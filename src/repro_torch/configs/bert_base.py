"""BERT_BASE -- the paper's own pruning target (L=12, H=768, A=12, 110M).

Not part of the 40-cell assigned grid; used by the paper-validation
benchmarks (Table 1 / Table 2 analogues) and the sparse-serving example.
"""
from repro_torch.configs.base import LayerKind, ModelConfig


def full():
    return ModelConfig(
        arch="bert-base", family="bert",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
        d_ff=3072, vocab_size=30522, norm="ln", act="gelu",
        rotary_fraction=0.0,  # learned absolute positions
        pattern=(LayerKind("attn", "dense"),), dtype="float32",
    )


def smoke():
    return ModelConfig(
        arch="bert-smoke", family="bert",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512, norm="ln", act="gelu",
        rotary_fraction=0.0,
        pattern=(LayerKind("attn", "dense"),), dtype="float32",
    )
