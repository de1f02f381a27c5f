"""Shared layer primitives: norms, activations, RoPE, linear init/apply,
gated MLPs and the paged-KV primitives.

Counterpart of ``repro/models/common.py``. Parameters are plain dicts of
tensors, laid out as in the reference: a linear weight is stored (d_out,
d_in) and applied as ``y = x @ w.T`` (the BSR layout).

Tensor parallelism (a mesh servable, ``serving/servable.py``) is explicit
SPMD here where the reference leaves it to GSPMD: a rank holds its shard of
each sharded projection and :func:`linear` makes the output whole on every
rank -- a column-parallel ('out') shard computes its rows' block and
all-gathers it along features, a row-parallel ('in') shard multiplies its
block columns of the whole ``x`` into an fp32 partial of every output and
all-reduces it (the reference's one psum a layer), then casts to ``x``'s
dtype (:func:`tp_constrain`); a column block sums in fp32 too and rounds
once (:func:`block_matmul`), as one device's whole GEMM does. Replicated
leaves compute the whole output and take no collective. A layer that
consumes only its block of a projection's features (the RG-LRU's width,
an SSM's heads, the audio family's cross K/V heads) takes it without the
gather (:func:`column_block`) and feeds a block straight into a
row-parallel shard (:func:`linear_from_block`). Shard objects by kind of
cache dim:
:class:`HeadShard`, :class:`LatentShard`, :class:`ExpertShard`,
:class:`ChannelShard` (conv channels, the RG-LRU width) and
:class:`SSDHeadShard`; a sequence-parallel batch's block of S is a
:class:`SeqShard`.

The mesh Trainer runs the same code with grad on (every family): each
collective is one of ``launch.mesh``'s differentiable
conjugate pairs (a gather's gradient keeps the rank's block, a cut's is
gathered, a reduce's passes through, a column shard's input all-reduces
its gradient), so a tensor replicated over "model" keeps a gradient
that is whole and equal on every rank; a training :class:`DenseShard`
also gathers its weight's "data" blocks first (FSDP).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import axis_size, dp_axes


@dataclasses.dataclass(frozen=True)
class Draw:
    """A :func:`normal_init` call recorded instead of drawn (under
    :func:`deferred_draws`): its place in the draw order and arguments,
    and a constant the init adds to the draw (the RG-LRU's ``lam``)."""

    index: int
    shape: tuple
    scale: float
    dtype: torch.dtype
    offset: float = 0.0

    def __add__(self, c: float) -> "Draw":
        return dataclasses.replace(self, offset=self.offset + float(c))


@dataclasses.dataclass(frozen=True)
class StackedDraw:
    """A layer-stacked leaf of deferred draws: one :class:`Draw` a
    period, stacked on a new leading axis when drawn."""

    parts: tuple

    @property
    def shape(self) -> tuple:
        return (len(self.parts),) + self.parts[0].shape


#: the list deferred draws are recorded in, or None (draw at once)
_DEFERRED = None


class deferred_draws:
    """Within the block, :func:`normal_init` draws nothing and returns a
    :class:`Draw`, appended to ``draws``: an init run this way gives the
    tree's shapes and draw order, and ``models.api.init_model_local``
    replays the draws one at a time."""

    def __init__(self):
        self.draws = []

    def __enter__(self):
        global _DEFERRED
        self._prev, _DEFERRED = _DEFERRED, self.draws
        return self.draws

    def __exit__(self, *exc):
        global _DEFERRED
        _DEFERRED = self._prev


def normal_init(gen: torch.Generator, shape, scale=0.02,
                dtype=torch.float32, device=None) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn in fp32 from ``gen``, cast to ``dtype``."""
    if _DEFERRED is not None:
        d = Draw(len(_DEFERRED), tuple(int(n) for n in shape), scale, dtype)
        _DEFERRED.append(d)
        return d
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=device)
    return (scale * w).to(dtype)


# -- norms -------------------------------------------------------------------

def rms_norm(x, scale, eps=1e-6):
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x, scale, bias, eps=1e-6):
    """LayerNorm in fp32 with the reference's eps (1e-6, not torch's
    1e-5), cast back to ``x``'s dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def init_norm(d, kind="rms", dtype=torch.float32, device=None):
    if kind == "rms":
        return {"scale": torch.zeros((d,), dtype=dtype, device=device)}
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def apply_norm(p, x, kind="rms"):
    if kind == "rms":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


# -- activations --------------------------------------------------------------

def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def act_fn(name):
    return {"gelu": gelu, "silu": F.silu, "relu": F.relu}[name]


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` = max(x, 0) +
    log1p(exp(-|x|)), NaN passed through. (``F.softplus`` returns x itself
    above its threshold and rounds otherwise.)"""
    out = x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))
    return torch.where(torch.isnan(x), x, out)


# -- RoPE ---------------------------------------------------------------------

def rope_freqs(head_dim, rotary_fraction=1.0, theta=10000.0, device=None):
    """Inverse frequencies of the rotated dims and their count (even)."""
    rot = int(head_dim * rotary_fraction)
    rot -= rot % 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    inv = 1.0 / (theta ** exps)
    return inv, rot


def apply_rope(x, positions, *, theta=10000.0, rotary_fraction=1.0):
    """x: (..., S, H, D); positions: (..., S) int. Pairs (x_i, x_{i+rot/2})
    rotated in fp32; trailing (1-fraction) dims pass through (chatglm-style
    partial rotary)."""
    d = x.shape[-1]
    inv, rot = rope_freqs(d, rotary_fraction, theta, device=x.device)
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    ang = positions[..., None].float() * inv               # (..., S, rot/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x_rot.float().chunk(2, dim=-1)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2, x_pass.float()], dim=-1).to(x.dtype)


# -- linear (dense or block-sparse) -------------------------------------------

def init_linear(gen, d_in, d_out, dtype=torch.float32, scale=0.02,
                device=None):
    """Weight stored (d_out, d_in): y = x @ w.T -- matches the BSR layout."""
    return {"w": normal_init(gen, (d_out, d_in), scale, dtype, device)}


@dataclasses.dataclass(frozen=True)
class DenseShard:
    """A dense weight that ``launch/sharding.spec_for_param`` shards over
    the "model" axis of ``mesh`` (a ``launch.mesh.ProcessMesh``): ``axis``
    'out' (its output rows) or 'in' (its input columns), None when "model"
    cuts neither. Mesh servables pass it to :func:`linear` in place of a
    pack; the shards of a (V, d) table under 'embed' / 'lm_head' / 'pos'
    mark vocabulary rows (:func:`embed_lookup`, :func:`head_logits`).

    Training (``train=True``, the mesh Trainer's shards) adds FSDP: the
    stored weight's dim ``data_dim`` (-2 or -1) is cut over "data" too and
    :meth:`weight` gathers it before use (its gradient reduce-scattered),
    and a vocabulary head keeps its logits block (the loss is
    vocabulary-parallel, ``launch.steps.cross_entropy``)."""

    axis: object
    mesh: object
    data_dim: object = None
    train: bool = False

    def weight(self, w):
        """The rank's "model" block of the weight, whole along "data"."""
        if self.data_dim is None:
            return w
        return self.mesh.fsdp_gather(w, "data", self.data_dim)


def _column(pk) -> bool:
    return isinstance(pk, DenseShard) and pk.axis == "out"


def tp_copy(x, *packs):
    """``x`` as the shared input of column-parallel shards: when every
    one of ``packs`` is such a shard, one ``copy_to`` (identity forward,
    the gradient's per-rank partials all-reduced over "model" backward)
    serves them all, marked so :func:`linear` copies no more. Otherwise
    ``x`` itself: each column shard copies its own input, and a
    replicated projection's gradient -- already whole on every rank --
    is not summed over the ranks."""
    if packs and all(_column(pk) for pk in packs):
        mesh = packs[0].mesh
        xc = mesh.copy_to(x, "model")
        if xc is not x:
            xc._tp_input = mesh
        return xc
    return x


def model_block(mesh, n: int):
    """``[lo, hi)``: this rank's block of ``n`` (divisible by the "model"
    axis) along a dim sharded over "model", in coordinate order."""
    s, m = mesh.coord("model"), mesh.shape["model"]
    w = n // m
    return s * w, (s + 1) * w


@dataclasses.dataclass(frozen=True)
class HeadShard:
    """Attention over this rank's KV heads (the cache's head dim is
    sharded over "model"): :meth:`local` slices q / k / v to them,
    :meth:`gather` makes the attention output whole again."""

    mesh: object
    n_kv_heads: int

    def local(self, q, k, v):
        """(B, S, H, D) q / k / v -> their local heads (q's G query heads
        per KV head follow their KV head: the rank's block of each head
        axis). k / v already cut to the rank's heads (cross-attention's K/V
        from a head-sharded cache) pass through. Under autograd the other
        ranks' head gradients are gathered back (``scatter_to``)."""
        mesh = self.mesh
        if k.shape[2] == self.n_kv_heads:
            k, v = mesh.scatter_to(k, "model", 2), mesh.scatter_to(
                v, "model", 2)
        return mesh.scatter_to(q, "model", 2), k, v

    def gather(self, out):
        return self.mesh.gather_from(out, "model", dim=2)


@dataclasses.dataclass(frozen=True)
class SeqShard:
    """A sequence-parallel batch: one row whose S the dp axes cut
    (``launch.sharding.batch_shardings``' SP branch), this rank holding
    positions ``[offset, offset + block)`` of the ``length`` of the
    global row. Position ids start at ``offset`` (RoPE, BERT's position
    rows) and attention gathers every rank's K / V along S
    (:meth:`gather`: its backward sums every rank's cotangent for the
    rank's block), so the rank's queries see the whole row and take the
    path one device takes for ``length``; every other op of the dense and
    BERT families acts token by token. Carried in a step's ``packs``
    under ``"seq"`` (``launch.steps.sequence_shard``)."""

    mesh: object
    axes: tuple
    offset: int
    length: int

    @classmethod
    def of(cls, mesh, length: int) -> "SeqShard":
        """This rank's block of a row of ``length`` cut over the dp axes."""
        axes = dp_axes(mesh)
        block = length // axis_size(mesh, axes)
        return cls(mesh, axes, mesh.coord(axes) * block, length)

    @property
    def block(self) -> int:
        return self.length // axis_size(self.mesh, self.axes)

    @property
    def last(self) -> bool:
        """True on the rank holding the row's last position."""
        return self.offset + self.block == self.length

    def positions(self, s: int, device):
        """(S/d,) position ids of the rank's block (``s`` its length)."""
        if s != self.block:
            raise ValueError(f"a sequence block of {s} positions, the "
                             f"shard's is {self.block} of {self.length}")
        return self.offset + torch.arange(s, device=device)

    def gather(self, x):
        """(B, S/d, ...) -> (B, S, ...): every rank's block along S."""
        return self.mesh.fsdp_gather(x, self.axes, 1)


@dataclasses.dataclass(frozen=True)
class LatentShard:
    """MLA over this rank's block of the latent rank (the cache's
    ``c_kv`` / ``c_kv_pages`` shard their last dim over "model";
    ``models.mla``): :meth:`block` cuts a whole latent-width tensor to the
    rank's columns, :meth:`gather` makes a block whole again, exactly, and
    :meth:`reduce` sums fp32 partials of a product over the blocks."""

    mesh: object
    rank: int

    def block(self, x):
        lo, hi = model_block(self.mesh, self.rank)
        return x[..., lo:hi]

    def gather(self, x):
        return self.mesh.all_gather(x, "model", dim=-1)

    def reduce(self, x):
        return self.mesh.all_reduce(x, "model")


@dataclasses.dataclass(frozen=True)
class ExpertShard:
    """A MoE layer on a mesh (``models.moe.apply_moe``): with ``sharded``
    the rank holds experts ``[s E/m, (s+1) E/m)`` (the routed-expert
    tensors' E axis over "model"), runs its expert products on them alone
    and all-gathers the outputs before the combine; with ``gather_rows``
    (a decode step whose rows shard over the dp axes, or a training step
    on a mesh whose dp axes have more than one rank) it all-gathers the
    step's rows over the dp axes ("data", and "pod" outermost on a
    multi-pod mesh) first, routes the whole batch and keeps its own rows
    of the output.

    Training (``train=True``, the mesh Trainer's shards) runs the same
    through the differentiable collectives: the rows' gather sums every
    dp rank's cotangent for the rank's rows (``fsdp_gather``: every
    rank's loss carries the whole batch's aux), the expert products take
    their input through ``copy_to`` over "model" (its gradient the sum of
    the ranks' expert blocks) and their outputs are made whole by
    ``gather_from``; the expert tensors named in ``fsdp`` hold their
    dim ``a`` (``wi`` / ``wg``: d, ``wo``: f) cut over "data", gathered
    for use by :meth:`weight` (gradient reduce-scattered; the rule cuts
    weights over "data" alone, so a weight is whole across pods). Where
    the rows are gathered a dp rank runs the products for its block of
    the capacity slots alone (:meth:`slots`; each product row is one
    slot's, so the block's rows are what the whole buffer's would be) and
    the blocks are gathered over the dp axes (:meth:`gather_slots`, whose
    backward sums every dp rank's cotangent for the rank's slots), so the
    expert FLOPs are split over every rank of the mesh."""

    mesh: object
    n_experts: int
    sharded: bool
    gather_rows: bool = False
    train: bool = False
    fsdp: tuple = ()

    def local(self, x):
        """Dim 0 of an (E, ...) tensor cut to this rank's experts."""
        if not self.sharded:
            return x
        lo, hi = model_block(self.mesh, self.n_experts)
        return x[lo:hi]

    def weight(self, name: str, w):
        """The rank's experts' ``name`` tensor (E/m, a, b), whole along
        ``a``."""
        if name not in self.fsdp:
            return w
        return self.mesh.fsdp_gather(w, "data", 1)

    def rows(self, x2):
        """(T, d) rows of this dp rank -> the whole batch's rows, in global
        row order (gathered over the dp axes, "pod" outermost)."""
        if self.train:
            return self.mesh.fsdp_gather(x2, dp_axes(self.mesh), 0)
        return self.mesh.all_gather(x2, dp_axes(self.mesh), dim=0)

    def expert_input(self, x2):
        """The rows as the expert products' input: a training shard whose
        experts are cut sums the gradient's expert blocks over "model"."""
        if self.train and self.sharded:
            return self.mesh.copy_to(x2, "model")
        return x2

    def _split_slots(self) -> bool:
        return self.train and self.gather_rows

    def slots(self, buf):
        """(E/m, cap, d) dispatch buffer -> this dp rank's block of the
        slots (a training shard whose rows the dp axes cut; the slots
        padded with zero rows to a multiple of the dp ranks), else
        ``buf``."""
        if not self._split_slots():
            return buf
        dp = dp_axes(self.mesh)
        n, c = axis_size(self.mesh, dp), self.mesh.coord(dp)
        per = -(-buf.shape[1] // n)
        buf = F.pad(buf, (0, 0, 0, per * n - buf.shape[1]))
        return buf[:, c * per:(c + 1) * per]

    def gather_slots(self, out, cap: int):
        """The dp ranks' slot blocks of the expert outputs -> the
        (E/m, cap, d) outputs of every slot (:meth:`slots`' inverse)."""
        if not self._split_slots():
            return out
        return self.mesh.fsdp_gather(out, dp_axes(self.mesh), 1)[:, :cap]

    def gather(self, out):
        """(E/m, cap, d) expert outputs -> (E, cap, d) on every rank."""
        if self.train:
            return self.mesh.gather_from(out, "model", dim=0)
        return self.mesh.all_gather(out, "model", dim=0)


@dataclasses.dataclass(frozen=True)
class ChannelShard:
    """A depthwise causal conv over this rank's block of channels
    ``[s C/m, (s+1) C/m)`` (the ``conv`` history cache (B, W-1, C) shards
    C over "model"; ``models.ssm``, ``models.rglru``): the conv is
    channel-local, so a rank convolves its block of the stream with its
    block of the replicated ``conv_w`` / ``conv_b`` (:meth:`block`),
    writes its block of the new history, and :meth:`gather` makes the
    output whole again, exactly. The RG-LRU's width W is its conv's
    channels: the same block is the rank's share of ``h`` (B, W), of the
    gates (the rows of ``w_a`` / ``w_i`` / ``in_x`` / ``in_gate``, the
    replicated ``lam``) and of ``out``'s input columns.

    The cut and the gather are ``launch.mesh``'s conjugate pair (without
    grad, a slice and an all-gather): a whole tensor -- an activation or
    a replicated per-channel leaf -- is cut by ``scatter_to``, whose
    backward all-gathers the blocks' cotangents, so its gradient is whole
    and equal on every model rank (as one device's; ``MeshPlan.sync_grads``
    does no reduce over "model"); ``gather_from``'s backward keeps the
    rank's block of a cotangent every model rank holds whole."""

    mesh: object
    channels: int

    @property
    def range(self):
        return model_block(self.mesh, self.channels)

    def block(self, x):
        return self.mesh.scatter_to(x, "model", -1)

    def gather(self, x):
        return self.mesh.gather_from(x, "model", dim=-1)


@dataclasses.dataclass(frozen=True)
class SSDHeadShard:
    """The SSD over this rank's heads ``[s H/m, (s+1) H/m)`` (the
    ``state`` cache (B, H, P, N) shards H over "model"; ``models.ssm``):
    :meth:`heads` cuts a head axis (x, dt, z and the per-head ``A_log`` /
    ``D`` / ``dt_bias``); B and C stay whole, one group for every head
    (:meth:`shared`). The output's ``d_inner`` block is exactly the heads'
    (H/m x P columns), which ``out_proj``'s row-parallel shard takes as it
    is; :meth:`rms_norm` normalises that block over the whole ``d_inner``
    (the blocks gathered, so the statistic is one device's) and
    :meth:`gather` makes a block whole.

    Cuts and gathers are conjugate pairs, as :class:`ChannelShard`'s: a
    head axis is cut by ``scatter_to`` (the gradient of a replicated
    per-head leaf or of ``in_proj``'s output whole on every model rank),
    the norm's blocks gathered by ``gather_from`` and its whole output cut
    by ``scatter_to`` again (the statistic's gradient takes every head's
    cotangent), and B and C enter the rank's heads through ``copy_to``
    (their gradient, each rank's heads' partial, summed over "model")."""

    mesh: object
    n_heads: int

    def heads(self, x, dim: int = -1):
        return self.mesh.scatter_to(x, "model", dim)

    def shared(self, x):
        """B or C, whole, as the input of this rank's heads."""
        return self.mesh.copy_to(x, "model")

    def rms_norm(self, y, scale):
        """This rank's block of :func:`rms_norm` of the whole rows whose
        block ``y`` it holds (``scale``: the whole row's)."""
        return self.mesh.scatter_to(rms_norm(self.gather(y), scale),
                                    "model", -1)

    def gather(self, x):
        return self.mesh.gather_from(x, "model", dim=-1)


def block_matmul(x, w):
    """``x @ w.T`` for a rank's block of a weight's rows, accumulated in
    fp32 and rounded once to ``x``'s dtype. A bf16 GEMM's rounding depends
    on its shape: cuBLAS splits K by shape and by default rounds the split
    partial sums to bf16, so a block run as a bf16 GEMM of its own rounds
    elsewhere than one device's whole GEMM (on an H100, 41% of mamba2's
    ``in_proj`` block outputs at M 32 and 512, ``chip_smoke.py --phases
    lm_tp_trace``); one fp32 sum and one rounding is where one device's
    GEMM rounds."""
    return torch.matmul(x.float(), w.float().t()).to(x.dtype)


def tp_constrain(y, pack, dtype=None):
    """The port's counterpart of the reference's sharding hook for a
    sharded projection's rank-local output ``y``: column-parallel
    (``shard_axis`` / ``axis`` 'out') all-gathers the feature blocks,
    row-parallel ('in') all-reduces the fp32 partials -- the layer's one
    psum -- and casts the sum to ``dtype``."""
    axis = getattr(pack, "shard_axis", None) or pack.axis
    if axis == "out":
        return pack.mesh.gather_from(y, "model", dim=-1)
    return pack.mesh.reduce_from(y, "model").to(dtype or y.dtype)


def _in_block(x, k_local, mesh):
    """This rank's block of input features for a row-parallel shard (under
    autograd the gradient's blocks are gathered back, ``scatter_to``)."""
    if x.shape[-1] == k_local * mesh.shape["model"]:
        return mesh.scatter_to(x, "model", -1)
    s = mesh.coord("model")
    return x[..., s * k_local:(s + 1) * k_local]


def _sharded_plan_linear(p, x, sharded, qpack=None):
    """A ShardedPlan (or a QuantPlan over one) on a mesh: this rank's shard
    through the plain 'plan' composition, then :func:`tp_constrain`."""
    from repro_torch.kernels import exec_plan as xp
    if qpack is not None and qpack.backend != "plan":
        raise ValueError(
            f"a sharded quantized pack serves through backend 'plan' only, "
            f"not {qpack.backend!r} (kernel K6 needs every output row)")
    lp = xp.local_plan(sharded, sharded.mesh.coord("model"))
    lead = tuple(x.shape[:-1])
    if sharded.shard_axis == "in":
        x = _in_block(x, lp.shape[1], sharded.mesh)
    x2 = x.reshape(-1, x.shape[-1])
    if sharded.shard_axis == "in":
        y = (xp._plan_q_fwd_f32(x2, p["w"], p["scale"], lp) if qpack
             else xp._plan_fwd_f32(x2, p["w"], lp))
    elif qpack is not None:
        y = xp.plan_q_linear(x2, p["w"], p["scale"], lp)
    else:
        y = xp.plan_linear(x2, p["w"], lp)
    y = y.reshape(lead + (lp.shape[0],))
    return tp_constrain(y, sharded, x.dtype)


def linear(p, x, pack=None, backend=None):
    """Dense or block-sparse projection.

    ``pack`` is static pattern metadata from ``serving.export``:
      * a ``RowPackPlan`` -- ``p['w']`` holds row-grouped values
        (V, P, bn, bk) served by the plain plan composition ('plan');
      * a ``PlanChoice`` -- the same layout pinned to a backend through
        ``ops.plan_dispatch`` ('plan_pallas' = kernel K1);
      * a ``QuantPlan`` -- ``p['w']`` holds int8/fp8 row-grouped values and
        ``p['scale']`` their fp32 scales; ``ops.plan_q_dispatch`` runs the
        dequant-fused product ('plan_pallas' = kernel K6);
      * a ``KernelBSR`` -- ``p['w']`` holds packed tile values
        (nnzt, bn, bk) and the product goes through ``ops.bsr_matmul``'s
        backends (``backend``; by default kernel K4 on a CUDA tensor);
      * an ``autotune.BackendChoice`` -- a KernelBSR pattern pinned to the
        backend the autotuner measured fastest for it;
      * an ``autotune.MaskedPack`` -- ``p['w']`` stays a DENSE (N, K) weight
        and kernel K7 (``masked_matmul``) skips the masked tiles;
      * a ``ShardedPlan`` with a mesh attached (a mesh servable) -- this
        rank's vrows of the plan (``exec_plan.local_plan``) and the
        collective that makes the output whole (:func:`tp_constrain`); a
        ``QuantPlan`` over one likewise ('plan' backend only);
      * a :class:`DenseShard` -- this rank's rows or columns of a dense
        weight (gathered over "data" first in training), then the same
        collective; a column shard's input passes ``copy_to`` first
        (once for all of a layer's column shards, :func:`tp_copy`);
      * None -- a dense weight, ``x @ w.T``.
    Every fp plan and pack route is differentiable; the quantized plain
    route in ``x`` only, K6 and K7 are forward-only.
    """
    if pack is not None:
        from repro_torch.kernels.autotune import BackendChoice, MaskedPack
        from repro_torch.kernels.bsr_matmul import KernelBSR
        from repro_torch.kernels.exec_plan import (PlanChoice, QuantPlan,
                                                   RowPackPlan, ShardedPlan,
                                                   plan_matmul)
        if isinstance(pack, DenseShard):
            w = pack.weight(p["w"])
            if pack.axis == "in":
                xl = _in_block(x, w.shape[1], pack.mesh)
                y = torch.matmul(xl.float(), w.float().t())
                return tp_constrain(y, pack, x.dtype)
            if pack.axis == "out":
                if getattr(x, "_tp_input", None) is not pack.mesh:
                    x = pack.mesh.copy_to(x, "model")
                return tp_constrain(block_matmul(x, w), pack)
            return torch.matmul(x, w.t())
        inner = pack.plan if isinstance(pack, QuantPlan) else pack
        if isinstance(inner, ShardedPlan) and inner.mesh is not None:
            return _sharded_plan_linear(
                p, x, inner, pack if isinstance(pack, QuantPlan) else None)
        if isinstance(pack, QuantPlan):
            from repro_torch.kernels.ops import plan_q_dispatch
            return plan_q_dispatch(x, p["w"], p["scale"], pack.plan,
                                   backend=pack.backend)
        if isinstance(pack, PlanChoice):
            from repro_torch.kernels.ops import plan_dispatch
            return plan_dispatch(x, p["w"], pack.plan, backend=pack.backend)
        if isinstance(pack, RowPackPlan):
            return plan_matmul(x, p["w"], pack)
        if isinstance(pack, MaskedPack):
            from repro_torch.kernels.bsr_matmul import masked_matmul
            lead = tuple(x.shape[:-1])
            y = masked_matmul(x.reshape(-1, x.shape[-1]).contiguous(),
                              p["w"], pack.mask_on(x.device), tile=pack.tile)
            return y.reshape(lead + (pack.shape[0],))
        if isinstance(pack, BackendChoice):
            backend, pack = pack.backend, pack.pack
        if isinstance(pack, KernelBSR):
            import dataclasses as _dc
            from repro_torch.kernels.ops import bsr_matmul
            return bsr_matmul(x, _dc.replace(pack, data=p["w"]), backend)
        raise TypeError(f"unknown pack kind {type(pack).__name__}")
    return torch.matmul(x, p["w"].t())


def column_block(p, x, pack, lo: int, hi: int, mesh=None):
    """Output features ``[lo, hi)`` of ``linear(p, x, pack)``: a
    column-parallel :class:`DenseShard` whose rows are exactly that block
    multiplies them alone (no collective forward; a training shard's input
    passes ``copy_to`` and its weight its "data" gather, as in
    :func:`linear`); any other pack (or none) makes the output whole and
    cuts it -- with ``mesh`` (the block is this rank's over "model") by
    ``scatter_to``, so the gradient of the whole output, and of a
    replicated weight, is whole on every model rank."""
    if isinstance(pack, DenseShard) and pack.axis == "out" \
            and p["w"].shape[-2] == hi - lo \
            and model_block(pack.mesh, (hi - lo) * pack.mesh.shape["model"]
                            ) == (lo, hi):
        if pack.train and getattr(x, "_tp_input", None) is not pack.mesh:
            x = pack.mesh.copy_to(x, "model")
        return block_matmul(x, pack.weight(p["w"]))
    y = linear(p, x, pack)
    if mesh is not None and mesh.shape.get("model", 1) > 1:
        return mesh.scatter_to(y, "model", -1)
    return y[..., lo:hi]


def linear_from_block(p, xb, pack, shard=None):
    """``linear(p, x, pack)`` given only this rank's block ``xb`` of x's
    features (the block of ``shard``, a :class:`ChannelShard` or
    :class:`SSDHeadShard`; without one ``xb`` is x): a row-parallel
    :class:`DenseShard` whose columns are that block multiplies it into an
    fp32 partial of every output and all-reduces it (the layer's one
    collective, :func:`tp_constrain`); any other pack gathers x whole
    first."""
    if shard is None:
        return linear(p, xb, pack)
    if isinstance(pack, DenseShard) and pack.axis == "in" \
            and p["w"].shape[-1] == xb.shape[-1]:
        y = torch.matmul(xb.float(), pack.weight(p["w"]).float().t())
        return tp_constrain(y, pack, xb.dtype)
    return linear(p, shard.gather(xb), pack)


def prefill_conv_history(x, valid, length, width, dtype):
    """Conv-cache state after a one-pass prompt prefill: the last ``width``
    pre-conv inputs of the real prompt. ``x``: (B, S, C) bucket-padded
    inputs, ``valid``: (1, S, 1) real-token mask, ``length`` the prompt
    length. Masking then left-padding ``width`` zeros makes prompts shorter
    than the conv window zero-fill exactly like a fresh decode cache.
    Shared by the SSM and RG-LRU prefill paths."""
    b = x.shape[0]
    zeros = torch.zeros((b, width) + tuple(x.shape[2:]), dtype=x.dtype,
                        device=x.device)
    masked = torch.where(valid, x, torch.zeros((), dtype=x.dtype,
                                               device=x.device))
    padded = torch.cat([zeros, masked], dim=1)
    # the reference's dynamic slice clamps its start into range
    start = min(max(int(length), 0), padded.shape[1] - width)
    return padded[:, start:start + width].to(dtype)


def init_mlp(gen, d_model, d_ff, act="gelu", dtype=torch.float32,
             device=None):
    """``wi``/``wg``/``wo`` for the gated MLPs (swiglu, geglu), ``wi``/``wo``
    otherwise; drawn in the reference's key order (wi, wg, wo)."""
    p = {"wi": init_linear(gen, d_model, d_ff, dtype, device=device)}
    if act in ("swiglu", "geglu"):
        p["wg"] = init_linear(gen, d_model, d_ff, dtype, device=device)
    p["wo"] = init_linear(gen, d_ff, d_model, dtype, device=device)
    return p


class _BatchRows(torch.autograd.Function):
    """``w[t]`` on a rank of a mesh whose dp axes ("pod", "data") have
    more than one rank. Backward adds the rows' gradients into the table
    as one device adds its batch's: every dp rank's rows and token ids
    are gathered over the dp axes (global row order) and indexing's own
    accumulation runs over all of them, in the table's dtype -- a bf16
    table takes a row's repeats one at a time, as one device and the
    reference do, where a sum of each rank's own partials would round
    elsewhere. On a sequence-parallel batch (each rank a (1, S/d) block
    of one row) the gathered (d, S/d) ids are the row's tokens in order,
    so the adds are one device's there too. Dp index 0 returns that
    gradient and the other dp ranks
    zeros, so the sums that follow (FSDP's reduce-scatter over "data" and
    the sum over "pod", or the all-reduce of a leaf replicated over the dp
    axes) are the batch's."""

    @staticmethod
    def forward(ctx, w, t, mesh):
        ctx.save_for_backward(t)
        ctx.mesh, ctx.like = mesh, (tuple(w.shape), w.dtype)
        return w[t]

    @staticmethod
    def backward(ctx, g):
        t, = ctx.saved_tensors
        mesh = ctx.mesh
        shape, dtype = ctx.like
        dp = dp_axes(mesh)
        rows = mesh.all_gather(g.contiguous(), dp, dim=0)
        ids = mesh.all_gather(t.contiguous(), dp, dim=0)
        gw = torch.zeros(shape, dtype=dtype, device=g.device)
        if mesh.coord(dp) == 0:
            gw.index_put_((ids,), rows.to(dtype), accumulate=True)
        return gw, None, None


def _rows(w, t, shard):
    """``w[t]``; a mesh Trainer's shard on a mesh with dp ranks under
    autograd takes :class:`_BatchRows`."""
    if shard is not None and shard.train \
            and axis_size(shard.mesh, dp_axes(shard.mesh)) > 1 \
            and torch.is_grad_enabled() and w.requires_grad:
        return _BatchRows.apply(w, t, shard.mesh)
    return w[t]


def embed_lookup(w, tokens, shard=None):
    """Rows ``tokens`` of the table ``w``. With a :class:`DenseShard`, ``w``
    is this rank's block of vocabulary rows (whole along d: pass
    ``shard.weight(w)`` in training): tokens outside it read zeros and an
    all-reduce over "model" assembles the rows (exact: one value plus
    zeros). A training shard on a data mesh adds the rows' gradients over
    the whole batch (:class:`_BatchRows`)."""
    if shard is None or shard.axis is None:
        return _rows(w, tokens.long(), shard)
    mesh = shard.mesh
    v = w.shape[0]
    t = tokens.long() - mesh.coord("model") * v
    ok = ((t >= 0) & (t < v))[..., None]
    h = torch.where(ok, _rows(w, t.clamp(0, v - 1), shard),
                    torch.zeros((), dtype=w.dtype, device=w.device))
    return mesh.reduce_from(h, "model")


def head_logits(h, head_f32, shard=None):
    """fp32 logits ``h @ head.T``; with a :class:`DenseShard` the head is
    this rank's vocabulary rows and the logits blocks are all-gathered --
    or, for a training shard, kept: (..., V / model) for the
    vocabulary-parallel loss."""
    if shard is None or shard.axis is None:
        return torch.matmul(h.float(), head_f32.t())
    y = torch.matmul(shard.mesh.copy_to(h, "model").float(), head_f32.t())
    return y if shard.train else shard.mesh.gather_from(y, "model", dim=-1)


def apply_mlp(p, x, act="gelu", packs=None):
    """Gated: ``wo(g(wg x) * wi x)`` with g = silu (swiglu) or tanh-gelu
    (geglu); otherwise ``wo(act(wi x))``."""
    packs = packs or {}
    x = tp_copy(x, packs.get("wi"), packs.get("wg"))
    if act in ("swiglu", "geglu"):
        g = F.silu if act == "swiglu" else gelu
        h = g(linear(p["wg"], x, packs.get("wg"))) * \
            linear(p["wi"], x, packs.get("wi"))
    else:
        h = act_fn(act)(linear(p["wi"], x, packs.get("wi")))
    return linear(p["wo"], h, packs.get("wo"))


# -- paged KV primitives ------------------------------------------------------
#
# A paged cache replaces per-slot contiguous KV storage (B, T, ...) with a
# pool of fixed-size pages (n_pages, page_size, ...) plus a per-slot page
# table (B, T // page_size) of physical page ids (-1 = unmapped). The
# serving engine owns allocation (serving/paging.py); the model layer only
# needs the three device ops below. The reference's scatters send invalid
# rows out of bounds, where JAX drops them; a CUDA scatter out of bounds is
# a device fault, so here invalid rows are never written: the writes below
# select the valid rows explicitly, in place.


@dataclasses.dataclass(frozen=True)
class PagedLayout:
    """Static paging geometry threaded into ``init_cache``: a pool of
    ``n_pages`` pages of ``page_size`` positions each, addressed through
    per-slot page tables covering ``cache_len // page_size`` entries."""

    page_size: int
    n_pages: int

    def __post_init__(self):
        if self.page_size < 1 or self.n_pages < 1:
            raise ValueError(f"bad paged layout: page_size={self.page_size} "
                             f"n_pages={self.n_pages}")

    def table_width(self, cache_len: int) -> int:
        if cache_len % self.page_size:
            raise ValueError(
                f"cache_len={cache_len} not divisible by "
                f"page_size={self.page_size}")
        return cache_len // self.page_size


def paged_view(pages, page_table, pos_map):
    """Gather a slot-contiguous (B, T, ...) view out of a page pool.

    ``pages``: (N, ps, ...); ``page_table``: (B, NP) int page ids (-1 =
    unmapped); ``pos_map``: (B, T = NP*ps) absolute positions (-1 = empty).
    Unmapped/unwritten positions read as exact zeros -- the view is then
    elementwise identical to the dense slot cache the same writes would
    have produced."""
    b, npg = page_table.shape
    n, ps = pages.shape[0], pages.shape[1]
    safe = page_table.long().clamp(0, n - 1)        # gather: clip, mask below
    view = pages[safe].reshape((b, npg * ps) + tuple(pages.shape[2:]))
    keep = (pos_map >= 0).reshape((b, npg * ps) + (1,) * (pages.dim() - 2))
    return torch.where(keep, view, torch.zeros((), dtype=view.dtype,
                                               device=view.device))


def paged_row_write(pages, page_table, positions, val, active):
    """Write one new position per batch row into the pool, in place: row
    ``i``'s value lands in page ``page_table[i, positions[i] // ps]`` at
    offset ``positions[i] % ps``. Inactive or unmapped rows write nothing.

    Without a host sync (this runs inside fused decode windows): every
    invalid row is given the destination and value of the first valid row,
    so all writers of a location store the same value; when no row is
    valid, every row stores page 0 row 0's own content back."""
    n, ps = pages.shape[0], pages.shape[1]
    npg = page_table.shape[1]
    flat = pages.view((n * ps,) + tuple(pages.shape[2:]))
    posv = positions.long().clamp_min(0)
    rows = torch.arange(page_table.shape[0], device=pages.device)
    pp = page_table[rows, (posv // ps).clamp(0, npg - 1)].long()
    valid = active & (pp >= 0)
    dest = pp.clamp_min(0) * ps + posv % ps
    # first valid row (or row 0), kept 1-D: a 0-d index is read on the host
    donor = torch.argmax(valid.int()).reshape(1)
    any_valid = valid.any()
    dest = torch.where(valid, dest, dest[donor])
    dest = torch.where(any_valid, dest, torch.zeros_like(dest))
    keep = valid.reshape((-1,) + (1,) * (val.dim() - 1))
    val = torch.where(keep, val.to(pages.dtype), val[donor].to(pages.dtype))
    val = torch.where(any_valid, val, flat[0].expand_as(val))
    flat[dest] = val
    return pages


def paged_bulk_write(pages, page_row, vals):
    """Write a slot-contiguous tensor into the pool pages of ONE slot, in
    place: ``vals`` (NP*ps, ...) reshaped to (NP, ps, ...) lands page-wise
    at the ids in ``page_row`` (NP,); entries < 0 (unallocated table slots)
    are skipped. Every allocated page is fully (re)written, so recycled
    pages cannot leak stale state. (An admission-time op: selecting the
    valid pages syncs with the host.)"""
    ps = pages.shape[1]
    npg = page_row.shape[0]
    chunks = vals.reshape((npg, ps) + tuple(pages.shape[2:]))
    row = page_row.to(pages.device).long()
    valid = row >= 0
    pages[row[valid]] = chunks[valid].to(pages.dtype)
    return pages
