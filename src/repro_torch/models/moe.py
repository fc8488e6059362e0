"""Top-k routed MoE FFN.

Counterpart of ``repro.models.moe``; its ``shard_map`` branch (experts
over the model axis) is ``models/sharded.py``'s, which calls
``_dispatch_compute_combine`` with each slot's expert range.  Tokens are ranked
into fixed-capacity per-expert queues (the buffer k-d tree's batching by
destination, applied to routing): an exclusive cumsum over destination
one-hots in token-major order gives each (token, slot) its place in its
expert's queue, and assignments past the capacity are dropped (GShard),
counted in ``MoEAux.drop_frac``.  Each expert's queue then runs as one
batched GEMM.

Routing follows the reference exactly: router logits and softmax in fp32,
then top-k, with ``jax.lax.top_k``'s tie order (among equal probabilities
the lower expert index first) from a stable descending sort.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.models.layers import MODEL, ParamSet, _act, cdtype, pdtype, winit

__all__ = ["init_moe", "moe_specs", "moe_mlp", "MoEAux"]


class MoEAux(NamedTuple):
    load_balance: torch.Tensor   # scalar f32 (switch aux loss)
    z_loss: torch.Tensor         # scalar f32 (router logit z-loss)
    drop_frac: torch.Tensor      # scalar f32 (fraction of assignments dropped)


def init_moe(cfg, gen: torch.Generator, device) -> ParamSet:
    d, f, e, dt = cfg.d_model, cfg.d_ff, cfg.n_experts, pdtype(cfg)
    p = {
        "router": winit(gen, (d, e), d, dt, device).float(),   # fp32 whatever param_dtype
        "w_gate": winit(gen, (e, d, f), d, dt, device),
        "w_up": winit(gen, (e, d, f), d, dt, device),
        "w_down": winit(gen, (e, f, d), f, dt, device),
    }
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * f
        p["w_gate_sh"] = winit(gen, (d, fs), d, dt, device)
        p["w_up_sh"] = winit(gen, (d, fs), d, dt, device)
        p["w_down_sh"] = winit(gen, (fs, d), fs, dt, device)
    return ParamSet(**p)


def moe_specs(cfg) -> dict:
    """Experts split over the model axis (E / tp each), the router
    replicated, the shared expert split over its d_ff."""
    s = {"router": (None, None), "w_gate": (MODEL, None, None), "w_up": (MODEL, None, None),
         "w_down": (MODEL, None, None)}
    if cfg.n_shared_experts:
        s.update(w_gate_sh=(None, MODEL), w_up_sh=(None, MODEL), w_down_sh=(MODEL, None))
    return s


def _capacity(t_tokens: int, cfg) -> int:
    c = int(np.ceil(t_tokens * cfg.moe_top_k / cfg.n_experts * cfg.moe_capacity_factor))
    return max(c, cfg.moe_top_k)


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest per row, ties to the lower index (``jax.lax.top_k``)."""
    v, i = torch.sort(probs, dim=-1, descending=True, stable=True)
    return v[:, :k], i[:, :k]


def _dispatch_compute_combine(p, x2d: torch.Tensor, cfg, e0: int = 0, e_local: int = 0):
    """x2d: [T, D] against experts e0 .. e0 + e_local - 1 (default: every
    expert), whose weights ``p`` holds.  Returns (y [T, D], the partial sum
    of the local experts' outputs; probs f32 [T, E]; top-k expert ids
    [T, K]; the fraction of the local assignments dropped, f32)."""
    dt = cdtype(cfg)
    t = x2d.shape[0]
    e, topk = cfg.n_experts, cfg.moe_top_k
    e_local = e_local or e
    cap = _capacity(t, cfg)

    logits = x2d.float() @ p.router                              # [T, E] f32
    probs = torch.softmax(logits, dim=-1)
    topv, topi = _top_k(probs, topk)                             # [T, K]
    if cfg.moe_renorm:
        topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)

    # rank within each local expert's queue, token-major (the "buffer fill")
    local = topi - e0
    is_local = (local >= 0) & (local < e_local)
    safe = torch.where(is_local, local, torch.zeros_like(local))
    ohf = (torch.nn.functional.one_hot(safe, e_local) * is_local[..., None]).reshape(
        t * topk, e_local)
    ranks = torch.cumsum(ohf, dim=0) - ohf                        # exclusive
    pos = (ranks * ohf).sum(-1).reshape(t, topk)
    keep = is_local & (pos < cap)

    # scatter tokens into [E_local * cap (+ dump row), D], one scatter per
    # slot so the [T * K, D] token replication is never materialized
    dest = torch.where(keep, safe * cap + pos, torch.full_like(pos, e_local * cap))
    xe = x2d.new_zeros((e_local * cap + 1, x2d.shape[1]))
    for kk in range(topk):
        xe = xe.index_add(0, dest[:, kk], x2d * keep[:, kk, None].to(dt))
    xe = xe[:-1].reshape(e_local, cap, -1)

    # expert FFNs: one batched GEMM per weight
    h = _act(torch.bmm(xe, p.w_gate.to(dt)), cfg.act) * torch.bmm(xe, p.w_up.to(dt))
    ye = torch.bmm(h, p.w_down.to(dt))                            # [E, cap, D]

    # combine: each (token, slot)'s expert output, weighted by its router prob
    yef = torch.cat([ye.reshape(e_local * cap, -1), ye.new_zeros((1, ye.shape[-1]))], dim=0)
    y = torch.zeros_like(x2d)
    for kk in range(topk):
        w = (topv[:, kk] * keep[:, kk]).to(dt)
        y = y + w[:, None] * yef[dest[:, kk]]
    dropped = (is_local & ~keep).sum() / torch.clamp(is_local.sum(), min=1)
    return y, probs, topi, dropped.float()


def _aux_losses(probs: torch.Tensor, topi: torch.Tensor, cfg):
    """Switch load-balance loss and the router z-loss."""
    e = cfg.n_experts
    # fraction of (token, slot) assignments per expert
    fr = torch.nn.functional.one_hot(topi, e).float().sum(1).mean(0) / cfg.moe_top_k
    pe = probs.mean(0)
    lb = e * (fr * pe).sum()
    z = (torch.logsumexp(torch.log(torch.clamp(probs, min=1e-30)), dim=-1) ** 2).mean()
    return lb, z


def _shared_expert(p, x2d: torch.Tensor, cfg) -> torch.Tensor:
    dt = cdtype(cfg)
    h = _act(x2d @ p.w_gate_sh.to(dt), cfg.act) * (x2d @ p.w_up_sh.to(dt))
    return h @ p.w_down_sh.to(dt)


def moe_mlp(p, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, MoEAux]:
    """MoE FFN.  x: [B, S, D] -> ([B, S, D], MoEAux); every expert local."""
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    y, probs, topi, drop = _dispatch_compute_combine(p, x2, cfg)
    if cfg.n_shared_experts:
        y = y + _shared_expert(p, x2, cfg)
    lb, z = _aux_losses(probs, topi, cfg)
    return y.reshape(b, s, d), MoEAux(lb, z, drop)
