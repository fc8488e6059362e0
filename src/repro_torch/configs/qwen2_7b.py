"""Qwen2-7B [arXiv:2407.10671; hf]: dense GQA decoder, QKV bias."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_head=128,
    d_ff=18944,
    vocab_size=152064,
    attn_bias=True,
    rope_theta=1e6,
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=512, vocab_pad_multiple=16,
    )
