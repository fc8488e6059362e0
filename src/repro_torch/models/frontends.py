"""Modality frontends: stubs, as in the reference.

Counterpart of ``repro.models.frontends``.  The vision and audio configs
cover the transformer backbone only; the caller supplies precomputed
patch / frame embeddings (``batch["frontend_feats"]``), and the model
projects them into ``d_model`` (plus, for the vision prefix, a tile-position
embedding).
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import ParamSet, cdtype, pdtype, winit

__all__ = ["init_frontend", "frontend_specs", "apply_frontend"]


def init_frontend(cfg, gen: torch.Generator, device) -> ParamSet:
    """An empty set for ``frontend == "none"`` (no state-dict keys)."""
    if cfg.frontend == "none":
        return ParamSet()
    p = {"w_proj": winit(gen, (cfg.frontend_dim, cfg.d_model), cfg.frontend_dim,
                         pdtype(cfg), device)}
    if cfg.frontend == "vision":
        # anyres tile-position embedding (llava-next: tiles of the base grid)
        p["tile_pos"] = torch.zeros((cfg.frontend_tokens, cfg.d_model), dtype=pdtype(cfg),
                                    device=device)
    return ParamSet(**p)


def frontend_specs(cfg) -> dict:
    """Replicated."""
    if cfg.frontend == "none":
        return {}
    s = {"w_proj": (None, None)}
    if cfg.frontend == "vision":
        s["tile_pos"] = (None, None)
    return s


def apply_frontend(p, feats: torch.Tensor, cfg) -> torch.Tensor:
    """feats: [B, T_f, frontend_dim] -> [B, T_f, d_model] in the compute dtype."""
    dt = cdtype(cfg)
    x = feats.to(dt) @ p.w_proj.to(dt)
    if cfg.frontend == "vision":
        x = x + p.tile_pos.to(dt)[None]
    return x
