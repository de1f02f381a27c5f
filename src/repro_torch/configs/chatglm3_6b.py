"""ChatGLM3 6B [arXiv:2406.12793; hf-verified].

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024; 2d-RoPE realized as
partial rotary over half the head dim (rotary_fraction=0.5).
"""
from repro_torch.configs.base import LayerKind, ModelConfig


def full():
    return ModelConfig(
        arch="chatglm3-6b", family="dense",
        n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2, head_dim=128,
        d_ff=13696, vocab_size=65024, rotary_fraction=0.5,
        pattern=(LayerKind("attn", "dense"),),
    )


def smoke():
    return ModelConfig(
        arch="chatglm3-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, rotary_fraction=0.5,
        pattern=(LayerKind("attn", "dense"),), dtype="float32",
        q_chunk=64, kv_chunk=64,
    )
