"""The dry-run's input specs: the port's meta-device stand-ins against the
JAX reference's ``ShapeDtypeStruct``s, leaf for leaf in path, shape and
dtype, for every ASSIGNED arch x SHAPES cell at the full configs (both
sides allocate nothing: meta tensors and ``jax.eval_shape``), and the two
packages' verdicts on which cells run.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import SHAPES  # noqa: E402
from repro.configs.registry import ASSIGNED  # noqa: E402
from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.launch import specs as jax_specs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.core.tree import flatten_with_path, path_name  # noqa: E402
from repro_torch.launch import specs  # noqa: E402

CELLS = [(a, s) for a in ASSIGNED for s in SHAPES]
IDS = [f"{a}-{s}" for a, s in CELLS]


def _jax_leaves(tree):
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = "/".join(f"[{k.idx}]" if hasattr(k, "idx")
                        else str(getattr(k, "key", k)) for k in path)
        out.append((name, tuple(leaf.shape), str(leaf.dtype)))
    return out


def _torch_leaves(tree):
    return [(path_name(p), tuple(x.shape),
             str(x.dtype).replace("torch.", ""))
            for p, x in flatten_with_path(tree)]


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    """The reference's param specs of an arch, once (its cells share
    them; ``jax.eval_shape`` of the init is the slow part)."""
    return jax_specs.params_specs(jax_config(arch))


def _jax_input_specs(arch, shape_name):
    """``repro.launch.specs.input_specs`` with the param tree cached."""
    jp, jc, shape = _jax_params(arch), jax_config(arch), SHAPES[shape_name]
    if shape.kind == "decode":
        return {"params": jp, "cache": jax_specs.cache_specs(jc, shape, jp),
                "token": jax_specs.sds((shape.global_batch, 1), jnp.int32),
                "pos": jax_specs.sds((), jnp.int32)}
    return {"params": jp, "batch": jax_specs.batch_specs(
        jc, shape, shape.kind == "train")}


@pytest.mark.parametrize("arch,shape_name", CELLS, ids=IDS)
def test_input_specs_equal_the_reference_leaf_for_leaf(arch, shape_name):
    t = specs.input_specs(get_config(arch), shape_name)
    assert _jax_leaves(_jax_input_specs(arch, shape_name)) == \
        _torch_leaves(t)
    assert all(x.is_meta for _, x in flatten_with_path(t))


@pytest.mark.parametrize("arch,shape_name", CELLS, ids=IDS)
def test_cell_is_supported_agrees(arch, shape_name):
    assert specs.cell_is_supported(get_config(arch), shape_name) == \
        jax_specs.cell_is_supported(jax_config(arch), shape_name)


def test_input_specs_take_a_shape_spec():
    """A ShapeSpec of the tests' own size works where a name does, and the
    assembled dict has the reference's keys."""
    cfg = get_config("gemma3_4b", smoke=True)
    small = ShapeSpec("decode_32k", 64, 2, "decode")
    got = specs.input_specs(cfg, small)
    assert sorted(got) == ["cache", "params", "pos", "token"]
    assert tuple(got["token"].shape) == (2, 1)
    ref = jax_specs.input_specs(jax_config("gemma3_4b", smoke=True),
                                "decode_32k")
    assert sorted(ref) == sorted(got)
    train = specs.input_specs(cfg, ShapeSpec("train_4k", 32, 4, "train"))
    assert sorted(train["batch"]) == ["labels", "tokens"]
    assert tuple(train["batch"]["tokens"].shape) == (4, 32)
    assert specs.cell_is_supported(cfg, small) == (True, "")
