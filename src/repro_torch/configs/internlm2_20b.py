"""InternLM2 20B [arXiv:2403.17297; hf-verified].

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544, SwiGLU.
"""
from repro_torch.configs.base import LayerKind, ModelConfig


def full():
    return ModelConfig(
        arch="internlm2-20b", family="dense",
        n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=16384, vocab_size=92544, rope_theta=1e6,
        pattern=(LayerKind("attn", "dense"),),
    )


def smoke():
    return ModelConfig(
        arch="internlm2-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, pattern=(LayerKind("attn", "dense"),),
        dtype="float32", q_chunk=64, kv_chunk=64,
    )
