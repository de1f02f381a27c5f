"""Qwen3-MoE 235B-A22B [hf:Qwen/Qwen3-30B-A3B family; hf-verified].

94L d_model=4096 64H (GQA kv=4) expert d_ff=1536 vocab=151936,
128 experts top-8, QK-RMSNorm, no shared experts, untied head.
"""
from repro_torch.configs.base import LayerKind, ModelConfig


def full():
    return ModelConfig(
        arch="qwen3-moe-235b-a22b", family="moe",
        n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
        d_ff=1536, d_ff_expert=1536, vocab_size=151936,
        n_experts=128, top_k=8, qk_norm=True, rope_theta=1e6,
        pattern=(LayerKind("attn", "moe"),),
    )


def smoke():
    return ModelConfig(
        arch="qwen3-moe-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=96, d_ff_expert=96, vocab_size=512,
        n_experts=8, top_k=2, qk_norm=True,
        pattern=(LayerKind("attn", "moe"),), dtype="float32",
        q_chunk=64, kv_chunk=64,
    )
