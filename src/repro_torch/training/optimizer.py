"""AdamW with global-norm clipping and a warmup + cosine schedule.

Counterpart of ``repro.training.optimizer``, with the reference's formula
(``adamw_update``): gradients scaled by ``min(1, clip_norm / max(gnorm,
1e-9))``, bias correction by ``count + 1``, the learning rate from the
``step`` argument, and the decoupled decay inside the step,
``w32 - lr * (m_hat / (sqrt(v_hat) + eps) + wd * w32)``.
``torch.optim.AdamW`` is not used: it applies the decay as a separate
multiply (another rounding) and has neither the clip nor the schedule.

Parameters, gradients and moments are dicts of tensors keyed by state-dict
name (``dict(lm.named_parameters())``); the moments are fp32.  The update
runs in place under ``torch.no_grad()``, as ``torch._foreach_*`` ops over
the whole dict.  With ``master_fp32`` the update goes to an fp32 master
copy in the state and the parameters (bf16) are cast from it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

__all__ = ["Hyper", "adamw_init", "adamw_update", "lr_schedule", "global_norm",
           "opt_state_specs"]

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Hyper:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    grad_accum: int = 1
    unroll_accum: bool = False


def lr_schedule(step: int, h: Hyper) -> float:
    """Linear warmup, then cosine decay to ``min_lr_frac``; evaluated in
    float32 as the reference evaluates it."""
    f32 = np.float32
    s = f32(step)
    warm = s / f32(max(1.0, h.warmup_steps))
    prog = np.clip((s - f32(h.warmup_steps)) / f32(max(1.0, h.total_steps - h.warmup_steps)),
                   f32(0.0), f32(1.0))
    cos = f32(h.min_lr_frac) + f32(1 - h.min_lr_frac) * f32(0.5) * (
        f32(1) + np.cos(f32(math.pi) * prog))
    return float(f32(h.lr) * (warm if step < h.warmup_steps else cos))


def adamw_init(params: Tensors, *, master_fp32: bool = False) -> dict:
    """{"m", "v": fp32 zeros like each parameter, "count": int32 0
    (+ "master": an fp32 copy of the parameters)}, on their devices."""
    params = {k: p.detach() for k, p in params.items()}
    state = {"m": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for k, p in params.items()},
             "v": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for k, p in params.items()},
             "count": torch.zeros((), dtype=torch.int32,
                                  device=next(iter(params.values())).device)}
    if master_fp32:
        state["master"] = {k: p.float().clone() for k, p in params.items()}
    return state


def opt_state_specs(param_specs: Dict[str, tuple], *, master_fp32: bool = False) -> dict:
    """The optimizer state's specs (``repro/training/optimizer.py:63``): the
    moments (and the fp32 master) placed like the parameters, the count
    replicated."""
    out = {"m": dict(param_specs), "v": dict(param_specs), "count": ()}
    if master_fp32:
        out["master"] = dict(param_specs)
    return out


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares, each tensor's in fp32, summed in order."""
    total = None
    for x in tensors:
        s = x.float().square().sum()
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads: Tensors, state: dict, params: Tensors, step: int,
                 h: Hyper, gnorm: torch.Tensor = None) -> Tuple[Tensors, dict, Dict[str, object]]:
    """One AdamW step, in place.  Returns (params, state, metrics) with
    ``grad_norm`` (the norm before clipping, a tensor) and ``lr``.  A
    sharded step passes the norm of the whole gradient as ``gnorm`` (one
    slot's ``grads`` are a shard of it)."""
    names = list(params)
    if gnorm is None:
        gnorm = global_norm(grads[k] for k in names)
    scale = torch.clamp(h.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = lr_schedule(step, h)
    state["count"] += 1
    c = state["count"].float()
    bc1 = 1.0 - torch.pow(h.b1, c)
    bc2 = 1.0 - torch.pow(h.b2, c)
    m = [state["m"][k] for k in names]
    v = [state["v"][k] for k in names]
    g = torch._foreach_mul([grads[k].float() for k in names], scale)
    torch._foreach_mul_(m, h.b1)                                 # b1 m + (1 - b1) g
    torch._foreach_add_(m, torch._foreach_mul(g, 1 - h.b1))
    torch._foreach_mul_(v, h.b2)                                 # b2 v + (1 - b2) g g
    torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, 1 - h.b2), g))
    del g
    has_master = "master" in state
    w32 = ([state["master"][k] for k in names] if has_master
           else [params[k].float() for k in names])
    upd = torch._foreach_div(
        torch._foreach_div(m, bc1),
        torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(v, bc2)), h.eps))
    torch._foreach_add_(upd, torch._foreach_mul(w32, h.weight_decay))
    torch._foreach_mul_(upd, lr)
    new_w = torch._foreach_sub(w32, upd)
    del upd
    for k, w in zip(names, new_w):
        if has_master:
            state["master"][k].copy_(w)
        params[k].copy_(w)                                       # cast to the param dtype
    return params, state, {"grad_norm": gnorm, "lr": lr}
