"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

Counterpart of ``repro.models.rglru``:

    u  = conv1d_causal(W_in1 x)              # temporal conv, width 4
    r  = sigmoid(W_a x + b_a)                # recurrence gate
    i  = sigmoid(W_x x + b_x)                # input gate
    a  = exp(-c * softplus(Lambda) * r)      # per-channel decay, c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)
    out = W_out (h * gelu(W_in2 x))

The recurrence runs over every token.  The reference's
``jax.lax.associative_scan`` becomes a log-depth (Hillis-Steele) scan of
(a, b) pairs in torch ops: 11 steps of whole-sequence ops at T = 2048, not
2048 steps of small ones; it associates differently, so the two agree
within a tolerance.  Decode carries (conv [B, W-1, R], h [B, R]), written
in place at the active rows.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamSet, cdtype, pdtype, winit
from repro_torch.models.ssm import causal_conv1d, write_rows

__all__ = ["init_rglru", "rglru_forward", "make_rglru_state", "rglru_decode",
           "linear_scan"]

_C = 8.0  # Griffin's fixed gate sharpness


def _lru_dim(cfg) -> int:
    return cfg.lru_width or cfg.d_model


def init_rglru(cfg, gen: torch.Generator, device) -> ParamSet:
    d, r, dt = cfg.d_model, _lru_dim(cfg), pdtype(cfg)
    # Lambda so that a^c lies in [0.9, 0.999] at r = 1 (Griffin app. A)
    lam0 = np.log(np.expm1(-np.log(np.linspace(0.9, 0.999, r)) / _C))
    return ParamSet(
        w_in1=winit(gen, (d, r), d, dt, device),
        w_in2=winit(gen, (d, r), d, dt, device),
        conv_w=(torch.randn((cfg.conv1d_width, r), generator=gen, device=device)
                * 0.1).to(dt),
        conv_b=torch.zeros((r,), dtype=dt, device=device),
        w_a=winit(gen, (d, r), d, dt, device),
        b_a=torch.zeros((r,), dtype=dt, device=device),
        w_x=winit(gen, (d, r), d, dt, device),
        b_x=torch.zeros((r,), dtype=dt, device=device),
        lam=torch.as_tensor(lam0, dtype=torch.float32, device=device),
        w_out=winit(gen, (r, d), r, dt, device),
    )


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t from h_{-1} = 0, along dim 1, as an
    inclusive Hillis-Steele scan of the pairs (a, b) under
    (a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2): ceil(log2 T) steps."""
    t_len, shift = a.shape[1], 1
    while shift < t_len:
        a_prev, b_prev = a[:, :-shift], b[:, :-shift]
        b = torch.cat([b[:, :shift], a[:, shift:] * b_prev + b[:, shift:]], dim=1)
        a = torch.cat([a[:, :shift], a[:, shift:] * a_prev], dim=1)
        shift *= 2
    return b


def _gates(p, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    dt = cdtype(cfg)
    r = torch.sigmoid((x @ p.w_a.to(dt) + p.b_a.to(dt)).float())
    i = torch.sigmoid((x @ p.w_x.to(dt) + p.b_x.to(dt)).float())
    log_a = -_C * F.softplus(p.lam) * r                         # [B,T,R] f32, < 0
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return torch.exp(log_a), mult * i


def rglru_forward(p, x: torch.Tensor, cfg, return_state: bool = False):
    """x: [B, T, D] -> [B, T, D] (training / prefill); with ``return_state``
    also the decode state after the last token."""
    dt = cdtype(cfg)
    pre = x @ p.w_in1.to(dt)
    u = causal_conv1d(pre, p.conv_w.to(dt), p.conv_b.to(dt))
    a, gate_in = _gates(p, x, cfg)
    h = linear_scan(a, gate_in * u.float())
    g = F.gelu(x @ p.w_in2.to(dt), approximate="tanh")
    y = (h.to(dt) * g) @ p.w_out.to(dt)
    if not return_state:
        return y
    width = p.conv_w.shape[0]
    return y, {"conv": pre[:, -(width - 1):], "h": h[:, -1]}


def make_rglru_state(cfg, batch: int, device) -> Dict[str, torch.Tensor]:
    r = _lru_dim(cfg)
    return {"conv": torch.zeros((batch, cfg.conv1d_width - 1, r), dtype=cdtype(cfg),
                                device=device),
            "h": torch.zeros((batch, r), dtype=torch.float32, device=device)}


def rglru_decode(p, x: torch.Tensor, state: Dict[str, torch.Tensor], cfg,
                 active: Optional[torch.Tensor] = None):
    """One token.  x: [B, 1, D] -> ([B, 1, D], state), the state written in
    place at the rows ``active`` (int64 indices; None: every row)."""
    dt = cdtype(cfg)
    pre = x @ p.w_in1.to(dt)                                       # [B, 1, R]
    conv_in = torch.cat([state["conv"], pre], dim=1)
    u = causal_conv1d(pre, p.conv_w.to(dt), p.conv_b.to(dt), state=state["conv"])
    a, gate_in = _gates(p, x, cfg)
    h = a[:, 0] * state["h"] + (gate_in * u.float())[:, 0]
    g = F.gelu(x @ p.w_in2.to(dt), approximate="tanh")
    y = h[:, None, :].to(dt) * g
    write_rows(state, {"conv": conv_in[:, 1:], "h": h}, active)
    return y @ p.w_out.to(dt), state
