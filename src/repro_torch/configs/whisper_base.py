"""Whisper-base [arXiv:2212.04356; unverified tier]. Enc-dec audio backbone.

6L enc + 6L dec, d_model=512 8H d_ff=2048 vocab=51865; conv frontend STUBBED
(input_specs feeds (B, 1500, d) frame embeddings). Decoder uses RoPE instead
of learned positions (adaptation for 32k-decode stress cells; DESIGN.md).
"""
from repro_torch.configs.base import LayerKind, ModelConfig


def full():
    return ModelConfig(
        arch="whisper-base", family="audio",
        n_layers=6, n_enc_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
        head_dim=64, d_ff=2048, vocab_size=51865, n_audio_ctx=1500,
        norm="ln", act="gelu", pattern=(LayerKind("attn", "dense"),),
    )


def smoke():
    return ModelConfig(
        arch="whisper-smoke", family="audio",
        n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=512, n_audio_ctx=64,
        norm="ln", act="gelu", pattern=(LayerKind("attn", "dense"),),
        dtype="float32", q_chunk=64, kv_chunk=64,
    )
