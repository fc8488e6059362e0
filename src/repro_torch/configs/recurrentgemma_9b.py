"""RecurrentGemma-9B / Griffin [arXiv:2402.19427; unverified]: hybrid
(rglru, rglru, local-attention) pattern 1 attn : 2 recurrent, MQA (kv=1),
window 2048, logit softcap, tied embeddings.  38 = 12*(3) + 2 remainder
rglru layers (pattern cycling)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_head=256,
    d_ff=12288,
    vocab_size=256000,
    layer_pattern=(("rglru", "dense"), ("rglru", "dense"), ("local", "dense")),
    window=2048,
    lru_width=4096,
    act="gelu",
    gemma_norm_plus_one=True,
    emb_scale=True,
    tie_embeddings=True,
    logit_softcap=30.0,
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=1, d_head=16,
        d_ff=128, vocab_size=512, vocab_pad_multiple=16, window=16,
        lru_width=64,
    )
