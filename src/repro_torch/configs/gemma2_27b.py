"""Gemma-2-27B [arXiv:2408.00118; hf]: alternating local(4096)/global
attention, attn+logit softcaps, GeGLU, sandwich norms, tied embeddings."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_head=128,
    d_ff=36864,
    vocab_size=256000,
    layer_pattern=(("local", "dense"), ("global", "dense")),
    window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    # query_pre_attn_scalar = d_model / n_heads = 144
    attn_scale=144.0 ** -0.5,
    act="gelu",
    gemma_norm_plus_one=True,
    post_norm=True,
    emb_scale=True,
    tie_embeddings=True,
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=512, vocab_pad_multiple=16, window=16,
        attn_scale=16.0 ** -0.5,
    )
