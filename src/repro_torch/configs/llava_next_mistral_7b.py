"""LLaVA-NeXT (Mistral-7B backbone) [hf:llava-hf/llava-v1.6-mistral-7b-hf;
unverified]: dense GQA decoder + anyres vision prefix (stub frontend:
precomputed CLIP-large patch embeddings, one 24x24 base tile)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=32000,
    rope_theta=1e6,
    frontend="vision",
    frontend_dim=1024,
    frontend_tokens=576,
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=512, vocab_pad_multiple=16,
        frontend_dim=32, frontend_tokens=8,
    )
