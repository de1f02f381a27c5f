"""Kernel K1 (``csrc/plan_dds.cu``) on the card against its plain version.

Imports only the port, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels_cuda.py -q

Without a CUDA card the test skips: the kernel has no CPU mode.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import exec_plan as txp  # noqa: E402
from repro_torch.kernels.bsr_matmul import pack_bsr, plan_dds  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("tile,n,k,m", [((16, 32), 96, 128, 24),
                                        ((32, 1), 64, 64, 40),
                                        ((128, 128), 768, 768, 384)])
def test_plan_dds_kernel_matches_plain_on_card(tile, n, k, m):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.RandomState(8)
    w = rng.randn(n, k).astype(np.float32)
    w *= np.kron(rng.rand(n // tile[0], k // tile[1]) < 0.3,
                 np.ones(tile, np.float32))
    pk = pack_bsr(w, tile)
    plan = txp.build_plan(pk)
    data = txp.pack_plan_data(plan, pk.data).cuda()
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).cuda()
    b = torch.from_numpy(rng.randn(n).astype(np.float32)).cuda()
    sched = txp.plan_schedule(plan)
    before = plan_dds.launches
    y = plan_dds(x, data, sched, n=n, tile=tile, bias=b, act="gelu")
    assert plan_dds.launches == before + 1
    ref = txp.plan_fused_linear_plain(x, data, plan, bias=b, act="gelu")
    # fp32 sums in another order than the plain version's
    torch.testing.assert_close(y, ref, atol=1e-4, rtol=1e-5)
