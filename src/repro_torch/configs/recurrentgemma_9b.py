"""RecurrentGemma 9B [arXiv:2402.19427; unverified tier]. Griffin hybrid.

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000; repeating
(RG-LRU, RG-LRU, local-attn window 2048) blocks; rnn_width=4096.
long_500k RUNS (bounded window + recurrent state).
"""
from repro_torch.configs.base import LayerKind, ModelConfig

_PATTERN = (LayerKind("rglru", "dense"), LayerKind("rglru", "dense"),
            LayerKind("local", "dense", window=2048))


def full():
    return ModelConfig(
        arch="recurrentgemma-9b", family="hybrid",
        n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
        d_ff=12288, vocab_size=256000, rnn_width=4096,
        pattern=_PATTERN, scale_embedding=True, tie_embeddings=True,
        act="geglu",
    )


def smoke():
    return ModelConfig(
        arch="recurrentgemma-smoke", family="hybrid",
        n_layers=6, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=512, rnn_width=64,
        pattern=(LayerKind("rglru", "dense"), LayerKind("rglru", "dense"),
                 LayerKind("local", "dense", window=32)),
        scale_embedding=True, tie_embeddings=True, act="geglu",
        dtype="float32", q_chunk=64, kv_chunk=64,
    )
