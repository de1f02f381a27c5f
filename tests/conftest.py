# NOTE: no XLA_FLAGS here on purpose -- by default smoke tests and benches
# see the real single CPU device; only launch/dryrun.py (separate process)
# fakes 512. The ci.yml `devices: 8` matrix leg exports
# XLA_FLAGS=--xla_force_host_platform_device_count=8 for the WHOLE run so
# the mesh-path tests (tests/test_sharded_serving.py) execute multi-device;
# under the plain run those tests skip.
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running (subprocess compiles)")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips inside the test without one)")
