"""DeepSeek-LLM 7B [arXiv:2401.02954; hf-verified]. Llama-arch MHA.

30L d_model=4096 32H (kv=32) d_ff=11008 vocab=102400.
"""
from repro_torch.configs.base import LayerKind, ModelConfig


def full():
    return ModelConfig(
        arch="deepseek-7b", family="dense",
        n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
        d_ff=11008, vocab_size=102400,
        pattern=(LayerKind("attn", "dense"),),
    )


def smoke():
    return ModelConfig(
        arch="deepseek-7b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512, pattern=(LayerKind("attn", "dense"),),
        dtype="float32", q_chunk=64, kv_chunk=64,
    )
