"""OLMoE-1B-7B [arXiv:2409.02060; hf]: MoE decoder, 64 experts top-8,
QK-norm, no top-k renorm."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1024,
    vocab_size=50304,
    layer_pattern=(("global", "moe"),),
    n_experts=64,
    moe_top_k=8,
    moe_renorm=False,
    qk_norm=True,
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=32, vocab_size=512, vocab_pad_multiple=16,
        n_experts=8, moe_top_k=2,
    )
