"""Gemma-3 4B [hf:google/gemma-3-1b-pt family; unverified tier].

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144; 5 local (window
1024) : 1 global interleave; embedding scaled by sqrt(d). long_500k is
SKIPPED for this arch (global layers are full attention).
"""
from repro_torch.configs.base import LayerKind, ModelConfig

_PATTERN = tuple([LayerKind("local", "dense", window=1024)] * 5
                 + [LayerKind("attn", "dense")])


def full():
    return ModelConfig(
        arch="gemma3-4b", family="dense",
        n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, head_dim=256,
        d_ff=10240, vocab_size=262144,
        pattern=_PATTERN, scale_embedding=True, tie_embeddings=True,
        act="geglu", rope_theta=1e6,
    )


def smoke():
    return ModelConfig(
        arch="gemma3-smoke", family="dense",
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512,
        pattern=tuple([LayerKind("local", "dense", window=32)] * 2
                      + [LayerKind("attn", "dense")]),
        scale_embedding=True, tie_embeddings=True, act="geglu",
        dtype="float32", q_chunk=64, kv_chunk=64,
    )
