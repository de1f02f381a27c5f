"""The dry-run's flops against the reference's ``hlo_cost.analyze`` for
the MoE, MLA and vlm smoke archs x {train, prefill, decode} at small
shapes on a (1, 1) mesh (the cost model's own cases and the dense family:
``test_torch_op_cost.py``; ``tests/_dryrun_reference.py`` says how the
reference compiles). The port's flops within 10%; bytes have no bar (XLA's
program is not the eager one), the ratio is printed.
"""
import pytest

torch = pytest.importorskip("torch")

from _dryrun_reference import SMALL, port_cost, reference_cost  # noqa: E402

ARCHS = ("qwen3_moe_235b_a22b", "deepseek_v2_lite_16b", "pixtral_12b")
#: as ``test_torch_op_cost.FLOP_BAR``; these cells measure 0.987-1.002
FLOP_BAR = 0.10


@pytest.mark.parametrize("kind", list(SMALL))
@pytest.mark.parametrize("arch", ARCHS)
def test_flops_near_the_reference(arch, kind):
    port = port_cost(arch, kind)
    ref = reference_cost(arch, kind)
    ratio = port["flops"] / ref["flops"]
    print(f"{arch} {kind}: flops {port['flops']:.4e} / {ref['flops']:.4e}"
          f" = {ratio:.4f}; bytes {port['bytes'] / ref['bytes']:.3f} of "
          f"XLA's; {port['ops']} ops in {port['trace_s']:.2f} s")
    assert abs(ratio - 1) <= FLOP_BAR
