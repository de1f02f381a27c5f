"""Pixtral 12B [hf:mistralai/Pixtral-12B-2409; unverified tier].

Mistral-Nemo-style decoder: 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072. The Pixtral-ViT frontend is STUBBED: input_specs feeds
(B, n_patches=256, d_model) patch embeddings merged into the prefix slots.
"""
from repro_torch.configs.base import LayerKind, ModelConfig


def full():
    return ModelConfig(
        arch="pixtral-12b", family="vlm",
        n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab_size=131072, n_patches=256, rope_theta=1e6,
        pattern=(LayerKind("attn", "dense"),),
    )


def smoke():
    return ModelConfig(
        arch="pixtral-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, n_patches=8,
        pattern=(LayerKind("attn", "dense"),), dtype="float32",
        q_chunk=64, kv_chunk=64,
    )
