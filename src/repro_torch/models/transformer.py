"""Block stack: one ``Layer`` module per layer, for training and serving.

Counterpart of ``repro.models.transformer``; ``Dist`` names the mesh a
``models/sharded.py::ShardedLM`` runs on (this module is its one-slot
path, and the layer structure both share).  The reference
stacks the parameters of each cycle of ``cfg.layer_pattern`` and scans over
the cycles; the port keeps a plain ``nn.ModuleList`` of layers, layer i of
kind ``cfg.layer_kinds()[i]``, and caches as a list with one dict per layer
(attention K / V, or a recurrent state).  ``models/convert.py`` maps the
reference's stacked layout onto it.  Mixers: ``global`` / ``local``
attention, ``rglru``, ``ssm``; MLPs: ``dense``, ``moe``, ``none``.

  * ``stack_forward``: train / prefill, returns (x, aux f32[3]): the MoE
    load-balance loss, z-loss and drop fraction, summed over the layers;
  * ``stack_prefill``: the same, plus the decode-layout caches;
  * ``stack_decode``: one token per row against the caches (in place).

Remat (``cfg.remat``) wraps each cycle of the pattern, as the reference
wraps its scan body (the layers past the last full cycle run unwrapped):
"full" checkpoints the cycle (``torch.utils.checkpoint``, non-reentrant),
"dots" keeps the outputs of unbatched matrix products and recomputes the
rest (the reference's ``dots_with_no_batch_dims_saveable``), "none" keeps
everything.  Only a forward that builds a graph is wrapped.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.models import attention, moe, rglru, ssm
from repro_torch.models.layers import (
    apply_mlp,
    apply_norm,
    init_mlp,
    init_norm,
    mlp_specs,
    norm_specs,
)

__all__ = ["Dist", "Layer", "layer_specs", "init_stack", "stack_forward", "stack_prefill",
           "init_stack_cache", "stack_decode", "grow_cache"]


@dataclasses.dataclass(frozen=True)
class Dist:
    """The mesh context (``repro/models/transformer.py:46``): a
    ``distributed.mesh.SlotMesh``, its batch axes, its model axis and the
    tensor-parallel degree (the model axis's size)."""
    mesh: Any
    data_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    tp: int = 1

Cache = Dict[str, torch.Tensor]


class Layer(nn.Module):
    """One block: norm1 -> mixer (-> norm1_post) -> residual, then the MLP
    likewise.  Submodule names are the reference's param keys."""

    def __init__(self, cfg, kind: Tuple[str, str], gen: torch.Generator, device,
                 tp: int = 1):
        super().__init__()
        mixer_kind, mlp_kind = kind
        self.kind = kind
        self.window = cfg.window if mixer_kind == "local" else 0
        self.norm1 = init_norm(cfg, cfg.d_model, device)
        if mixer_kind in ("global", "local"):
            self.mixer = attention.init_attention(cfg, gen, device, tp)
        elif mixer_kind == "rglru":
            self.mixer = rglru.init_rglru(cfg, gen, device)
        elif mixer_kind == "ssm":
            self.mixer = ssm.init_ssm(cfg, gen, device)
        else:
            raise ValueError(f"unknown mixer {mixer_kind!r}")
        if cfg.post_norm:
            self.norm1_post = init_norm(cfg, cfg.d_model, device)
        if mlp_kind != "none":
            self.norm2 = init_norm(cfg, cfg.d_model, device)
            if mlp_kind == "dense":
                self.mlp = init_mlp(cfg, gen, device)
            elif mlp_kind == "moe":
                self.mlp = moe.init_moe(cfg, gen, device)
            else:
                raise ValueError(f"unknown mlp {mlp_kind!r}")
            if cfg.post_norm:
                self.norm2_post = init_norm(cfg, cfg.d_model, device)


def layer_specs(cfg, kind: Tuple[str, str], tp: int) -> Dict[str, tuple]:
    """{name within the layer (``mixer.w_q``): spec} for a layer of ``kind``."""
    mixer_kind, mlp_kind = kind
    if mixer_kind in ("global", "local"):
        mixer = attention.attention_specs(cfg, tp)
    else:
        mixer = rglru.rglru_specs(cfg) if mixer_kind == "rglru" else ssm.ssm_specs(cfg)
    parts = {"norm1": norm_specs(cfg), "mixer": mixer}
    if cfg.post_norm:
        parts["norm1_post"] = norm_specs(cfg)
    if mlp_kind != "none":
        parts["norm2"] = norm_specs(cfg)
        parts["mlp"] = mlp_specs(cfg) if mlp_kind == "dense" else moe.moe_specs(cfg)
        if cfg.post_norm:
            parts["norm2_post"] = norm_specs(cfg)
    return {f"{m}.{k}": v for m, d in parts.items() for k, v in d.items()}


def init_stack(cfg, gen: torch.Generator, device, tp: int = 1) -> nn.ModuleList:
    return nn.ModuleList(Layer(cfg, kind, gen, device, tp) for kind in cfg.layer_kinds())


def _mlp_half(p: Layer, x: torch.Tensor, cfg):
    """The MLP half of a layer: (x, aux f32[3] or None)."""
    if p.kind[1] == "none":
        return x, None
    h = apply_norm(p.norm2, x, cfg)
    aux = None
    if p.kind[1] == "dense":
        h = apply_mlp(p.mlp, h, cfg)
    else:
        h, mo = moe.moe_mlp(p.mlp, h, cfg)
        aux = torch.stack([mo.load_balance, mo.z_loss, mo.drop_frac])
    if cfg.post_norm:
        h = apply_norm(p.norm2_post, h, cfg)
    return x + h, aux


def _mixer_fwd(p: Layer, x: torch.Tensor, cfg, start: int, return_state: bool):
    h = apply_norm(p.norm1, x, cfg)
    mixer_kind = p.kind[0]
    if mixer_kind in ("global", "local"):
        out = attention.attn_forward(p.mixer, h, cfg, layer_window=p.window,
                                     causal=not cfg.encoder_only, start=start,
                                     return_kv=return_state)
    elif mixer_kind == "rglru":
        out = rglru.rglru_forward(p.mixer, h, cfg, return_state=return_state)
    else:
        out = ssm.ssm_forward(p.mixer, h, cfg, return_state=return_state)
    h, cache = out if return_state else (out, None)
    if cfg.post_norm:
        h = apply_norm(p.norm1_post, h, cfg)
    return x + h, cache


def _layers_fwd(layers, x: torch.Tensor, cfg, start: int):
    """Run ``layers`` in order: (x, aux f32[3])."""
    aux = torch.zeros((3,), dtype=torch.float32, device=x.device)
    for p in layers:
        x, _ = _mixer_fwd(p, x, cfg, start, False)
        x, a = _mlp_half(p, x, cfg)
        if a is not None:
            aux = aux + a
    return x, aux


# matrix products with no batch dimension: what "dots" keeps (a [B, S, D]
# @ [D, F] product reaches aten.mm; attention's batched einsums reach bmm)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, cfg):
    """``fn`` under ``cfg.remat`` where a graph is being built."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    if cfg.remat == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts, _dots_policy)
        return functools.partial(checkpoint, fn, use_reentrant=False, context_fn=ctx)
    return functools.partial(checkpoint, fn, use_reentrant=False)


def stack_forward(layers: nn.ModuleList, x: torch.Tensor, cfg, start: int = 0):
    """x: [B, S, D] -> ([B, S, D], aux f32[3]: the MoE losses summed, 0
    without MoE)."""
    gs, ng = cfg.group_size(), cfg.n_groups()
    aux = torch.zeros((3,), dtype=torch.float32, device=x.device)
    for g in range(ng):
        group = layers[g * gs:(g + 1) * gs]
        x, a = _remat(lambda h, group=group: _layers_fwd(group, h, cfg, start), cfg)(x)
        aux = aux + a
    x, a = _layers_fwd(layers[ng * gs:], x, cfg, start)
    return x, aux + a


def stack_prefill(layers: nn.ModuleList, x: torch.Tensor, cfg, start: int = 0):
    """Forward pass that also emits the decode-layout caches (one per layer)."""
    caches: List[Cache] = []
    for p in layers:
        x, c = _mixer_fwd(p, x, cfg, start, True)
        caches.append(c)
        x, _ = _mlp_half(p, x, cfg)
    return x, caches


def _layer_cache(cfg, mixer: str, batch: int, max_len: int, device) -> Cache:
    if mixer in ("global", "local"):
        return attention.make_cache(cfg, batch, max_len,
                                    cfg.window if mixer == "local" else 0, device)
    if mixer == "rglru":
        return rglru.make_rglru_state(cfg, batch, device)
    return ssm.make_ssm_state(cfg, batch, device)


def init_stack_cache(cfg, batch: int, max_len: int, device) -> List[Cache]:
    return [_layer_cache(cfg, mixer, batch, max_len, device)
            for mixer, _ in cfg.layer_kinds()]


def stack_decode(layers: nn.ModuleList, x: torch.Tensor, caches: List[Cache],
                 pos: torch.Tensor, cfg, active: Optional[torch.Tensor] = None):
    """x: [B, 1, D]; pos: an integer scalar or [B]; active: bool[B] (None:
    every row).  Returns ([B, 1, D], caches), the caches written in place."""
    if active is not None:
        active = torch.nonzero(active).reshape(-1)   # once, not once per layer
    for p, cache in zip(layers, caches):
        h = apply_norm(p.norm1, x, cfg)
        mixer_kind = p.kind[0]
        if mixer_kind in ("global", "local"):
            h = attention.attn_decode(p.mixer, h, cache, pos, cfg, layer_window=p.window,
                                      active=active)[0]
        elif mixer_kind == "rglru":
            h = rglru.rglru_decode(p.mixer, h, cache, cfg, active=active)[0]
        else:
            h = ssm.ssm_decode(p.mixer, h, cache, cfg, active=active)[0]
        if cfg.post_norm:
            h = apply_norm(p.norm1_post, h, cfg)
        x, _ = _mlp_half(p, x + h, cfg)
    return x, caches


def grow_cache(caches: List[Cache], cfg, max_len: int) -> List[Cache]:
    """Pad prefill-emitted caches to decode capacity: global layers' to
    ``max_len``, local layers' to ``min(window, max_len)`` (their rolling
    slots need length == window); recurrent states keep their size.  Zero
    slots are masked by decode's stored-position check."""
    out = []
    for (mixer, _), c in zip(cfg.layer_kinds(), caches):
        if mixer not in ("global", "local"):
            out.append(c)
            continue
        tgt = min(cfg.window, max_len) if mixer == "local" else max_len
        pad = tgt - c["k"].shape[-3]
        if pad <= 0:
            out.append(c)
            continue
        out.append({name: torch.cat([t, t.new_zeros(t.shape[:-3] + (pad,) + t.shape[-2:])],
                                    dim=-3)
                    for name, t in c.items()})
    return out
