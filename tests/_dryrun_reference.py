"""The JAX reference's dry-run counts at small shapes, for the port's
op-cost tests (``tests/test_torch_op_cost*.py``) and as a script.

``reference_cost(arch, kind)`` lowers the reference's step of a smoke
config with ``repro.launch.dryrun.lower_cell`` on a (1, 1) mesh at the
small ``SHAPES`` below (patched into the reference's modules for the
call) and returns ``hlo_cost.analyze`` of the compiled HLO. By default XLA
compiles with its fusion pass off (``xla_disable_hlo_passes=fusion``: every
op its own one-op fusion, so each is costed once): the eager port fuses
nothing, while XLA's fusions recompute a producer in every consumer
fusion -- a mamba2 decode step's conv is computed three times -- and
count it each time. ``fused=True`` compiles as the reference's dry-run
does.

    PYTHONPATH=src python tests/_dryrun_reference.py

prints, for every ASSIGNED smoke arch and cell kind, the port's flops
and bytes (``launch.dryrun.trace_cell`` on a (1, 1) dry mesh) beside the
reference's, unfused and fused.
"""
import contextlib
import os

from repro_torch.configs.base import ShapeSpec as TorchShapeSpec

#: the small cells: B 4 x S 128 (train), B 2 x S 256 (prefill), B 4 slots
#: x 256 cached positions (decode)
SMALL = {"train": ("train_4k", 128, 4), "prefill": ("prefill_32k", 256, 2),
         "decode": ("decode_32k", 256, 4)}
UNFUSED = {"xla_disable_hlo_passes": "fusion"}


def torch_shape(kind):
    name, s, b = SMALL[kind]
    return TorchShapeSpec(name, s, b, kind)


def _reference_dryrun():
    """``repro.launch.dryrun``, imported without its process-wide
    ``XLA_FLAGS`` (512 fake devices) taking effect: the backend is
    initialised first and the environment restored."""
    import jax
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    import repro.launch.dryrun as rd
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return rd


@contextlib.contextmanager
def small_shapes():
    """The reference's ``SHAPES`` replaced by :data:`SMALL` in the modules
    ``lower_cell`` reads them from."""
    from repro.configs.base import ShapeSpec
    import repro.launch.specs as rs
    rd = _reference_dryrun()
    small = {name: ShapeSpec(name, s, b, kind)
             for kind, (name, s, b) in SMALL.items()}
    saved = rd.SHAPES, rs.SHAPES
    rd.SHAPES = rs.SHAPES = small
    try:
        yield rd
    finally:
        rd.SHAPES, rs.SHAPES = saved


def reference_cost(arch, kind, fused=False):
    """``hlo_cost.analyze`` of the reference's compiled step of the smoke
    ``arch`` at the small ``kind`` cell on a (1, 1) mesh."""
    import jax
    from repro.configs.registry import get_config
    from repro.launch import hlo_cost
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    with small_shapes() as rd:
        lowered = rd.lower_cell(get_config(arch, smoke=True),
                                SMALL[kind][0], mesh)
    compiled = lowered.compile() if fused else \
        lowered.compile(compiler_options=UNFUSED)
    return hlo_cost.analyze(compiled.as_text())


def port_cost(arch, kind):
    """``launch.dryrun.trace_cell`` of the port's smoke ``arch`` at the
    small ``kind`` cell on a (1, 1) dry mesh."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import trace_cell
    from repro_torch.launch.mesh import make_mesh
    return trace_cell(get_config(arch, smoke=True), torch_shape(kind),
                      make_mesh((1, 1), ("data", "model")))


def main():
    from repro.configs.registry import ASSIGNED
    print("arch kind port_flops ref_flops_unfused ratio ref_flops_fused "
          "ratio port_bytes ref_bytes_unfused ref_bytes_fused")
    for arch in ASSIGNED:
        for kind in SMALL:
            p = port_cost(arch, kind)
            u = reference_cost(arch, kind)
            f = reference_cost(arch, kind, fused=True)
            print(arch, kind, p["flops"], u["flops"],
                  round(p["flops"] / u["flops"], 4), f["flops"],
                  round(p["flops"] / f["flops"], 4), p["bytes"],
                  u["bytes"], f["bytes"], flush=True)


if __name__ == "__main__":
    main()
