"""DeepSeek-V2-Lite 16B [arXiv:2405.04434; hf-verified].

27L d_model=2048 16H, MLA kv_lora=512 (nope 128 / rope 64 / v 128),
expert d_ff=1408, 64 routed top-6 + 2 shared experts, first layer dense FFN.
(The assignment line lists both "64e" and "160 routed"; we follow the real
V2-Lite: 64 routed + 2 shared -- noted in DESIGN.md.)
"""
from repro_torch.configs.base import LayerKind, ModelConfig


def full():
    return ModelConfig(
        arch="deepseek-v2-lite-16b", family="moe",
        n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=10944,                      # dense first layer (real V2-Lite)
        d_ff_expert=1408, vocab_size=102400,
        n_experts=64, n_shared_experts=2, top_k=6,
        kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
        prefix=(LayerKind("mla", "dense"),),
        pattern=(LayerKind("mla", "moe"),),
    )


def smoke():
    return ModelConfig(
        arch="deepseek-v2-lite-smoke", family="moe",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, d_ff_expert=48, vocab_size=512,
        n_experts=8, n_shared_experts=1, top_k=2,
        kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
        prefix=(LayerKind("mla", "dense"),),
        pattern=(LayerKind("mla", "moe"),), dtype="float32",
        q_chunk=64, kv_chunk=64,
    )
