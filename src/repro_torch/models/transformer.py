"""Block stack: one ``Layer`` module per layer, for inference.

Counterpart of ``repro.models.transformer`` for the mixers ``global`` /
``local`` and the MLPs ``dense`` / ``none``.  The reference stacks the
parameters of each cycle of ``cfg.layer_pattern`` and scans over the cycles
(with remat); the port keeps a plain ``nn.ModuleList`` of layers, layer i
of kind ``cfg.layer_kinds()[i]``, and caches as a list with one dict per
layer.  ``models/convert.py`` maps the reference's stacked layout onto it.
The other mixers (``rglru``, ``ssm``) and ``moe`` raise ``NotPorted``.

  * ``stack_forward``: train / prefill, returns (x, aux f32[3]);
  * ``stack_prefill``: the same, plus the decode-layout caches;
  * ``stack_decode``: one token per row against the caches (in place).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.models import attention
from repro_torch.models.layers import NotPorted, apply_mlp, apply_norm, init_mlp, init_norm

__all__ = ["Layer", "init_stack", "stack_forward", "stack_prefill",
           "init_stack_cache", "stack_decode", "grow_cache", "check_supported"]

Cache = Dict[str, torch.Tensor]

_REMAINDER = ("ROADMAP Queue 1 item 20's remainder: the MoE, SSM and RG-LRU "
              "families and the vision / audio frontends are not ported yet")


def check_supported(cfg) -> None:
    """Raise ``NotPorted`` for a config the port cannot run yet."""
    for mixer, mlp in cfg.layer_pattern:
        if mixer not in ("global", "local"):
            raise NotPorted(f"{cfg.name}: mixer {mixer!r}; {_REMAINDER}")
        if mlp not in ("dense", "none"):
            raise NotPorted(f"{cfg.name}: mlp {mlp!r}; {_REMAINDER}")
    if cfg.frontend != "none":
        raise NotPorted(f"{cfg.name}: frontend {cfg.frontend!r}; {_REMAINDER}")


class Layer(nn.Module):
    """One block: norm1 -> mixer (-> norm1_post) -> residual, then the MLP
    likewise.  Submodule names are the reference's param keys."""

    def __init__(self, cfg, kind: Tuple[str, str], gen: torch.Generator, device):
        super().__init__()
        mixer_kind, mlp_kind = kind
        self.kind = kind
        self.window = cfg.window if mixer_kind == "local" else 0
        self.norm1 = init_norm(cfg, cfg.d_model, device)
        self.mixer = attention.init_attention(cfg, gen, device)
        if cfg.post_norm:
            self.norm1_post = init_norm(cfg, cfg.d_model, device)
        if mlp_kind != "none":
            self.norm2 = init_norm(cfg, cfg.d_model, device)
            self.mlp = init_mlp(cfg, gen, device)
            if cfg.post_norm:
                self.norm2_post = init_norm(cfg, cfg.d_model, device)


def init_stack(cfg, gen: torch.Generator, device) -> nn.ModuleList:
    check_supported(cfg)
    return nn.ModuleList(Layer(cfg, kind, gen, device) for kind in cfg.layer_kinds())


def _mlp_half(p: Layer, x: torch.Tensor, cfg) -> torch.Tensor:
    if p.kind[1] == "none":
        return x
    h = apply_mlp(p.mlp, apply_norm(p.norm2, x, cfg), cfg)
    if cfg.post_norm:
        h = apply_norm(p.norm2_post, h, cfg)
    return x + h


def _mixer_fwd(p: Layer, x: torch.Tensor, cfg, start: int, return_kv: bool):
    h = apply_norm(p.norm1, x, cfg)
    out = attention.attn_forward(p.mixer, h, cfg, layer_window=p.window,
                                 causal=not cfg.encoder_only, start=start,
                                 return_kv=return_kv)
    h, cache = out if return_kv else (out, None)
    if cfg.post_norm:
        h = apply_norm(p.norm1_post, h, cfg)
    return x + h, cache


def stack_forward(layers: nn.ModuleList, x: torch.Tensor, cfg, start: int = 0):
    """x: [B, S, D] -> ([B, S, D], aux f32[3]) (aux: the MoE losses, 0 here)."""
    for p in layers:
        x, _ = _mixer_fwd(p, x, cfg, start, False)
        x = _mlp_half(p, x, cfg)
    return x, torch.zeros((3,), dtype=torch.float32, device=x.device)


def stack_prefill(layers: nn.ModuleList, x: torch.Tensor, cfg, start: int = 0):
    """Forward pass that also emits the decode-layout caches (one per layer)."""
    caches: List[Cache] = []
    for p in layers:
        x, c = _mixer_fwd(p, x, cfg, start, True)
        caches.append(c)
        x = _mlp_half(p, x, cfg)
    return x, caches


def init_stack_cache(cfg, batch: int, max_len: int, device) -> List[Cache]:
    check_supported(cfg)
    return [attention.make_cache(cfg, batch, max_len, cfg.window if mixer == "local" else 0,
                                 device)
            for mixer, _ in cfg.layer_kinds()]


def stack_decode(layers: nn.ModuleList, x: torch.Tensor, caches: List[Cache],
                 pos: torch.Tensor, cfg, active: Optional[torch.Tensor] = None):
    """x: [B, 1, D]; pos: an integer scalar or [B]; active: bool[B] (None:
    every row).  Returns ([B, 1, D], caches), the caches written in place."""
    if active is not None:
        active = torch.nonzero(active).reshape(-1)   # once, not once per layer
    for p, cache in zip(layers, caches):
        h = attention.attn_decode(p.mixer, apply_norm(p.norm1, x, cfg), cache, pos, cfg,
                                  layer_window=p.window, active=active)[0]
        if cfg.post_norm:
            h = apply_norm(p.norm1_post, h, cfg)
        x = _mlp_half(p, x + h, cfg)
    return x, caches


def grow_cache(caches: List[Cache], cfg, max_len: int) -> List[Cache]:
    """Pad prefill-emitted caches to decode capacity: global layers' to
    ``max_len``, local layers' to ``min(window, max_len)`` (their rolling
    slots need length == window).  Zero slots are masked by decode's
    stored-position check."""
    out = []
    for (mixer, _), c in zip(cfg.layer_kinds(), caches):
        tgt = min(cfg.window, max_len) if mixer == "local" else max_len
        pad = tgt - c["k"].shape[-3]
        if pad <= 0:
            out.append(c)
            continue
        out.append({name: torch.cat([t, t.new_zeros(t.shape[:-3] + (pad,) + t.shape[-2:])],
                                    dim=-3)
                    for name, t in c.items()})
    return out
