"""Qwen1.5-0.5B [hf:Qwen/Qwen1.5-0.5B; hf]: dense decoder, QKV bias,
tied embeddings."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=2816,
    vocab_size=151936,
    attn_bias=True,
    rope_theta=1e6,
    tie_embeddings=True,
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=128, vocab_size=512, vocab_pad_multiple=16,
    )
