"""StableLM-2-1.6B [hf:stabilityai/stablelm-2-1_6b; unverified]:
dense decoder, LayerNorm, partial rotary (25%)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_head=64,
    d_ff=5632,
    vocab_size=100352,
    norm="layernorm",
    rope_pct=0.25,
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=128, vocab_size=512, vocab_pad_multiple=16,
    )
