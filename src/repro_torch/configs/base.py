"""ArchConfig: one dataclass describing every supported architecture.

Counterpart of ``repro.configs.base``, copied whole (data only), as are the
ten ``<arch>.py`` files beside it: the same ids give the same configs.

``layer_pattern`` is a cycle of (mixer, mlp) kinds expanded to ``n_layers``:
  mixer ∈ {"global", "local", "rglru", "ssm"}
  mlp   ∈ {"dense", "moe", "none"}
e.g. Gemma-2's alternating local/global = (("local","dense"),("global","dense")).

Each architecture file in this package exports ``CONFIG`` plus a
``smoke()`` reduced config of the same family (small dims, same layer
pattern) used by per-arch CPU smoke tests.  ``registry()`` maps ids to
configs for ``--arch`` selection.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

__all__ = ["ArchConfig", "registry", "get_config", "ARCH_IDS"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int

    # attention
    layer_pattern: Tuple[Tuple[str, str], ...] = (("global", "dense"),)
    window: int = 0                  # sliding window for "local" layers
    attn_bias: bool = False
    qk_norm: bool = False
    rope_pct: float = 1.0
    rope_theta: float = 1e4
    attn_scale: float = 0.0          # 0 => 1/sqrt(d_head)
    attn_softcap: float = 0.0
    logit_softcap: float = 0.0
    full_attn_threshold: int = 2048  # chunked attention above this seq len
    attn_q_chunk: int = 0            # 0 => auto (2048)
    attn_kv_chunk: int = 0

    # norms / mlp
    norm: str = "rmsnorm"
    gemma_norm_plus_one: bool = False
    post_norm: bool = False          # Gemma-2 sandwich norms
    act: str = "silu"
    mlp_gated: bool = True

    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    n_shared_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_renorm: bool = False
    moe_aux_coef: float = 0.01
    moe_z_coef: float = 1e-3

    # SSM (Mamba-2)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_expand: int = 2
    ssm_chunk: int = 128
    conv1d_width: int = 4

    # RG-LRU
    lru_width: int = 0

    # embeddings
    tie_embeddings: bool = False
    emb_scale: bool = False
    vocab_pad_multiple: int = 256

    # modality frontend (stub: precomputed embeddings, DESIGN.md)
    frontend: str = "none"           # none | vision | audio
    frontend_dim: int = 0
    frontend_tokens: int = 0         # image tokens per sequence (vision)
    encoder_only: bool = False

    # numerics / execution
    seq_shard: bool = False          # Megatron-SP: residual stream sharded
                                     # over `model` along the sequence axis
    kv_cache_dtype: str = "bfloat16"  # "int8": quantized KV cache (decode)
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: str = "full"              # none | dots | full
    scan_layers: bool = True

    def layer_kinds(self) -> Tuple[Tuple[str, str], ...]:
        pat = self.layer_pattern
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))

    def group_size(self) -> int:
        return len(self.layer_pattern)

    def n_groups(self) -> int:
        return self.n_layers // self.group_size()

    def n_remainder(self) -> int:
        return self.n_layers % self.group_size()

    def supports_decode(self) -> bool:
        return not self.encoder_only

    def subquadratic(self) -> bool:
        """True if no layer kind needs an unbounded KV cache."""
        kinds = {k for k, _ in self.layer_pattern}
        return "global" not in kinds

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


ARCH_IDS = (
    "qwen2_7b",
    "stablelm_1_6b",
    "qwen15_0_5b",
    "gemma2_27b",
    "llava_next_mistral_7b",
    "olmoe_1b_7b",
    "moonshot_v1_16b_a3b",
    "recurrentgemma_9b",
    "mamba2_370m",
    "hubert_xlarge",
)


def registry() -> Dict[str, ArchConfig]:
    out = {}
    for aid in ARCH_IDS:
        mod = importlib.import_module(f"repro_torch.configs.{aid}")
        out[aid] = mod.CONFIG
    return out


def get_config(arch: str, smoke: bool = False) -> ArchConfig:
    aid = arch.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{aid}")
    return mod.smoke() if smoke else mod.CONFIG
