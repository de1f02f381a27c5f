"""The op-level cost model (``launch/op_cost.py``), the reference's
``tests/test_hlo_cost.py`` cases recast for the port, and the dry-run's
flops against the reference's ``hlo_cost.analyze`` for the dense family
(the other families: ``test_torch_op_cost_families.py``,
``test_torch_op_cost_local.py``, ``test_torch_op_cost_recurrent.py``).

  * ``tanh(a @ b) @ b``: flops and bytes equal a hand count exactly, and
    the flops equal the reference's count of the same function;
  * loops: a 12-iteration loop counts 4 x a 3-iteration one, nested loops
    multiply (Python runs every iteration; no trip count is read);
  * live memory: the high-water mark of a known allocation pattern, a
    storage kept alive by a view or by autograd's saved tensors;
  * a dry run refuses an op that puts out a tensor off the meta device,
    and its kept output metadata changes no count;
  * the mesh's collective kinds under the reference's names;
  * the dense smoke archs x {train, prefill, decode} at small shapes on a
    (1, 1) mesh: the port's flops within 10% of the reference's
    (``tests/_dryrun_reference.py`` says how the reference compiles);
    bytes have no bar (XLA's program is not the eager one), the ratio is
    printed.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _dryrun_reference import (SMALL, port_cost, reference_cost,  # noqa: E402
                               torch_shape)
from repro.launch.hlo_cost import HloCostModel  # noqa: E402
from repro_torch.launch.op_cost import OpCost, collective_bytes  # noqa: E402

ARCHS = ("deepseek_7b", "internlm2_20b", "chatglm3_6b")
#: the port's flops against the reference's: both count by hlo_cost's
#: rules, but each program is its own (which tiles a causal mask skips,
#: where a cast or a select sits); the cells measure 0.98-1.01
FLOP_BAR = 0.10


def _hand(m, k, n):
    """flops and bytes of tanh(a @ b) @ b, a (m, k), b (k, n = k), fp32:
    two dots and one elementwise op, each reading its operands and
    writing its output once."""
    dot = 2 * m * n * k
    ab = 4 * (m * k + k * n + m * n)
    return 2 * dot + m * n, 2 * ab + 4 * 2 * m * n


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_matches_a_hand_count_on_a_loop_free_graph(device):
    a = torch.empty(256, 512, device=device)
    b = torch.empty(512, 512, device=device)
    with OpCost(dry=device == "meta") as c:
        torch.tanh(a @ b) @ b
    flops, nbytes = _hand(256, 512, 512)
    assert c.flops == flops
    assert c.bytes == nbytes
    ref = HloCostModel(jax.jit(lambda x, y: jnp.tanh(x @ y) @ y).lower(
        jax.ShapeDtypeStruct((256, 512), jnp.float32),
        jax.ShapeDtypeStruct((512, 512), jnp.float32)).compile().as_text())
    assert c.flops == ref.total().flops


def _loop(n, size=128):
    h = torch.empty(size, size, device="meta")
    with OpCost() as c:
        for _ in range(n):
            h = torch.tanh(h @ h)
    return c.flops


def test_scales_with_trip_count():
    f3, f12 = _loop(3), _loop(12)
    assert f12 == 4 * f3
    assert f3 == 3 * (2 * 128 ** 3 + 128 ** 2)


def test_nested_loops_multiply():
    h = torch.empty(64, 64, device="meta")
    with OpCost() as c:
        for _ in range(3):
            for _ in range(5):
                h = torch.tanh(h @ h)
    assert c.flops == 15 * (2 * 64 ** 3 + 64 ** 2)


def test_peak_tracks_live_storages():
    n = 1024
    a = torch.empty(n, device="meta")
    with OpCost() as c:
        assert c.hold({"a": a}) == 4 * n
        b = a * 2                       # live 2n
        d = b * 3                       # live 3n
        del b                           # live 2n
        e = d + 1                       # live 3n
        v = e[: n // 2]                 # a view: no new storage
        del e                           # the view keeps e's storage
        f = v * 1                       # live 3n + n/2
        del v, f                        # live 2n
        g = d * 4                       # live 3n
    assert c.peak == 4 * (3 * n + n // 2)
    assert c.argument_bytes == 4 * n
    assert c.live == 4 * 3 * n
    del d, g
    assert c.live == 4 * n


def test_saved_tensors_stay_live_until_backward():
    """A tensor autograd saves stays live after its last Python reference
    dies: its storage is freed only with the graph."""
    n = 4096
    x = torch.empty(n, device="meta", requires_grad=True)
    with OpCost() as c:
        c.hold(x)
        y = torch.exp(x)                # saved for exp's backward
        z = y.sum()
        del y
        assert c.live == 2 * 4 * n + 4
        del z
    assert c.live == 4 * n


def test_dry_run_refuses_a_host_tensor():
    x = torch.empty(8, device="meta")
    with pytest.raises(RuntimeError, match="during a dry run"):
        with OpCost():
            x + torch.ones(8)
    with OpCost() as c:                 # a 0-d host scalar is allowed
        x * torch.tensor(2.0)
    assert c.flops == 8


@pytest.mark.parametrize("arch,kind", [("gemma3_4b", "train"),
                                       ("qwen3_moe_235b_a22b", "decode"),
                                       ("mamba2_780m", "prefill")])
def test_kept_output_metadata_changes_no_count(arch, kind, monkeypatch):
    """A dry run keeps functional ops' output metadata by their arguments'
    and skips the meta kernel on a repeat call: every count equals the
    run that calls every kernel (on a (2, 2) mesh, collectives included)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import trace_cell
    from repro_torch.launch.mesh import make_mesh
    cfg, mesh = get_config(arch, smoke=True), make_mesh((2, 2), ("data",
                                                                 "model"))
    kept = trace_cell(cfg, torch_shape(kind), mesh)
    monkeypatch.setattr(OpCost, "_run", lambda self, func, kind, args,
                        kwargs: func(*args, **kwargs))
    every = trace_cell(cfg, torch_shape(kind), mesh)
    for r in (kept, every):
        del r["trace_s"]
    assert kept == every


def test_collective_kinds_take_the_reference_names():
    stats = {"all_reduce:model": {"calls": 2, "bytes": 10},
             "all_max:model": {"calls": 1, "bytes": 1},
             "broadcast:data": {"calls": 1, "bytes": 4},
             "all_gather:data": {"calls": 3, "bytes": 30},
             "reduce_scatter:data": {"calls": 1, "bytes": 8},
             "ppermute:data": {"calls": 1, "bytes": 2}}
    got = collective_bytes(stats)
    assert got == {"all-reduce": 15, "all-gather": 30, "reduce-scatter": 8,
                   "all-to-all": 0, "collective-permute": 2, "total": 55}


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
