"""Mamba2-370M [arXiv:2405.21060; unverified]: attention-free SSD stack,
state 128, head dim 64, tied embeddings.  (n_heads fields are unused
placeholders for the shared config schema.)"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=16,          # unused (attention-free)
    n_kv_heads=16,       # unused
    d_head=64,           # unused
    d_ff=0,
    vocab_size=50280,
    layer_pattern=(("ssm", "none"),),
    ssm_state=128,
    ssm_heads=32,        # d_inner 2048 / head dim 64
    ssm_expand=2,
    ssm_chunk=128,
    tie_embeddings=True,
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, vocab_size=512, vocab_pad_multiple=16,
        ssm_state=16, ssm_heads=4, ssm_chunk=16,
    )
