"""Model/run configuration schema shared by all architectures.

A config fully determines parameter shapes, the layer plan (how heterogeneous
layer stacks are decomposed into a scannable repeating pattern + unrolled
prefix/suffix), and the input specs for every assigned input shape.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.sparsity import SparsityConfig

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype string ('float32' | 'bfloat16') -> torch dtype."""
    if name not in _TORCH_DTYPES:
        raise ValueError(f"unsupported dtype {name!r}")
    return _TORCH_DTYPES[name]


# Mixer kinds: 'attn' (global), 'local' (windowed), 'mla', 'ssm', 'rglru'
# FFN kinds:   'dense', 'moe', 'none'
@dataclasses.dataclass(frozen=True)
class LayerKind:
    mixer: str = "attn"
    ffn: str = "dense"
    window: int = 0          # 0 = global attention; >0 = local window


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: str                      # dense|moe|ssm|hybrid|audio|vlm|bert
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # layer heterogeneity: the per-layer kinds, cycled; overridden per arch
    pattern: Tuple[LayerKind, ...] = (LayerKind(),)
    prefix: Tuple[LayerKind, ...] = ()     # unrolled leading layers

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # MLA (DeepSeek-V2)
    kv_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # SSM (Mamba2 SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    conv_width: int = 4

    # RG-LRU (RecurrentGemma)
    rnn_width: int = 0

    # attention details
    rope_theta: float = 10000.0
    rotary_fraction: float = 1.0    # chatglm "2d" rope = 0.5
    qk_norm: bool = False           # qwen3
    scale_embedding: bool = False   # gemma
    attn_logit_softcap: float = 0.0
    tie_embeddings: bool = False

    # enc-dec (whisper)
    n_enc_layers: int = 0
    n_audio_ctx: int = 0

    # vlm (pixtral)
    n_patches: int = 0

    # norms / activation
    norm: str = "rms"               # rms|ln
    act: str = "swiglu"             # swiglu|gelu|geglu
    # numeric
    dtype: str = "bfloat16"
    # paper technique
    sparsity: Optional[SparsityConfig] = None
    # flash-attention chunking
    q_chunk: int = 1024
    kv_chunk: int = 1024
    # decode KV cache quantization (int8 + per-(slot,head) scales): halves
    # cache HBM residency -- the capacity fix for few-kv-head GQA archs at
    # batch 128 x 32k (DESIGN.md §8, EXPERIMENTS.md §Perf iter 5)
    kv_cache_quant: bool = False

    # ------------------------------------------------------------------
    @property
    def tdtype(self) -> torch.dtype:
        """The model dtype as a torch dtype (the reference's ``jdtype``)."""
        return torch_dtype(self.dtype)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def layer_plan(self):
        """(prefix, pattern, n_periods, suffix): layers = prefix
        + n_periods * pattern + suffix, with the middle lax.scan'ed."""
        body = self.n_layers - len(self.prefix)
        n_periods, rem = divmod(body, len(self.pattern))
        suffix = self.pattern[:rem]
        return self.prefix, self.pattern, n_periods, suffix

    def supports_long_context(self) -> bool:
        """True iff no layer kind requires global full attention
        (=> 500k decode has bounded per-step state)."""
        kinds = self.prefix + self.pattern
        return all(k.mixer in ("ssm", "rglru") or
                   (k.mixer in ("attn", "local") and k.window > 0)
                   for k in kinds)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}
