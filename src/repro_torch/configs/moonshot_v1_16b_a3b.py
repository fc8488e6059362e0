"""Moonlight-16B-A3B [hf:moonshotai/Moonlight-16B-A3B; hf]: DeepSeek-style
MoE decoder, 64 experts top-6 + 2 shared experts, renormalized gates.
(Softmax gating stands in for the sigmoid+bias aux-free router; DESIGN.md.)"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1408,
    vocab_size=163840,
    layer_pattern=(("global", "moe"),),
    n_experts=64,
    moe_top_k=6,
    n_shared_experts=2,
    moe_renorm=True,
    rope_theta=5e4,
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=32, vocab_size=512, vocab_pad_multiple=16,
        n_experts=8, moe_top_k=2, n_shared_experts=1,
    )
