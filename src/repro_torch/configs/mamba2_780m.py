"""Mamba2 780M [arXiv:2405.21060; unverified tier]. Attention-free SSD.

48L d_model=1536, ssm_state=128, expand=2, head_dim=64, vocab=50280.
long_500k RUNS for this arch (O(1) decode state).
"""
from repro_torch.configs.base import LayerKind, ModelConfig


def full():
    return ModelConfig(
        arch="mamba2-780m", family="ssm",
        n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0, head_dim=0,
        d_ff=0, vocab_size=50280,
        ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=128,
        pattern=(LayerKind("ssm", "none"),), tie_embeddings=True,
    )


def smoke():
    return ModelConfig(
        arch="mamba2-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, head_dim=0,
        d_ff=0, vocab_size=512,
        ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_chunk=32,
        pattern=(LayerKind("ssm", "none"),), tie_embeddings=True,
        dtype="float32",
    )
