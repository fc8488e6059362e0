"""HuBERT-XLarge [arXiv:2106.07447; unverified]: encoder-only (bidirectional)
transformer over (stub) conv-frontend frame embeddings; frame-level unit
logits (vocab 504).  Standard (non-gated) GELU MLP, LayerNorm.  RoPE stands
in for the conv positional embedding (DESIGN.md)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_head=80,
    d_ff=5120,
    vocab_size=504,
    norm="layernorm",
    act="gelu",
    mlp_gated=False,
    encoder_only=True,
    frontend="audio",
    frontend_dim=512,
    # 504 -> 512: the unit-logit head must shard over the 16-way model axis
    vocab_pad_multiple=256,
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=128, vocab_size=64, vocab_pad_multiple=8, frontend_dim=32,
    )
