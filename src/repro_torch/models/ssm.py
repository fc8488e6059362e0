"""Mamba-2 SSD block (state-space duality, arXiv:2405.21060).

Counterpart of ``repro.models.ssm``.  The sequence is cut into chunks of
``cfg.ssm_chunk`` tokens: within a chunk the output is the masked quadratic
term, across chunks a linear recurrence carries [H, N, P] states.  The
reference runs that recurrence as a ``jax.lax.associative_scan``; here it
is a loop over the T / Q chunks (16 at T = 2048, Q = 128), whose sums
associate left to right, so the two agree within a tolerance, not bit for
bit.  Decode carries (conv [B, W-1, d_inner], ssm [B, H, N, P]) and, like
the attention caches, writes the active rows' state in place.

The reference's simplifications stay: the causal conv1d runs on the x path
only, and the input projections are separate matrices.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import DATA, MODEL, ParamSet, cdtype, pdtype, winit

__all__ = ["init_ssm", "ssm_specs", "ssm_state_specs", "ssm_forward", "ssm_mix",
           "ssm_decode", "ssm_decode_mix", "gated_out", "make_ssm_state", "causal_conv1d",
           "write_rows"]


def _dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    h = cfg.ssm_heads or d_inner // 64
    return d_inner, h, d_inner // h, cfg.ssm_state


def init_ssm(cfg, gen: torch.Generator, device) -> ParamSet:
    d = cfg.d_model
    d_inner, h, _, n = _dims(cfg)
    dt = pdtype(cfg)
    return ParamSet(
        w_z=winit(gen, (d, d_inner), d, dt, device),
        w_x=winit(gen, (d, d_inner), d, dt, device),
        w_b=winit(gen, (d, n), d, dt, device),
        w_c=winit(gen, (d, n), d, dt, device),
        w_dt=winit(gen, (d, h), d, dt, device),
        dt_bias=torch.zeros((h,), dtype=dt, device=device),
        A_log=torch.zeros((h,), dtype=torch.float32, device=device),  # a = -exp(A_log)
        D_skip=torch.ones((h,), dtype=dt, device=device),
        conv_w=(torch.randn((cfg.conv1d_width, d_inner), generator=gen, device=device)
                * 0.1).to(dt),
        conv_b=torch.zeros((d_inner,), dtype=dt, device=device),
        norm_scale=torch.ones((d_inner,), dtype=dt, device=device),
        w_out=winit(gen, (d_inner, d), d_inner, dt, device),
    )


def ssm_specs(cfg) -> dict:
    """d_inner (so the heads) split over the model axis; B and C replicated."""
    return {"w_z": (None, MODEL), "w_x": (None, MODEL), "w_b": (None, None),
            "w_c": (None, None), "w_dt": (None, MODEL), "dt_bias": (MODEL,),
            "A_log": (MODEL,), "D_skip": (MODEL,), "conv_w": (None, MODEL),
            "conv_b": (MODEL,), "norm_scale": (MODEL,), "w_out": (MODEL, None)}


def ssm_state_specs(cfg) -> dict:
    return {"conv": (DATA, None, MODEL), "ssm": (DATA, MODEL, None, None)}


def _local_dims(p):
    """(d_inner, heads, head dim, state) of the parameters at hand: the
    whole block's, or one model shard's."""
    d_inner, h = p.w_x.shape[1], p.w_dt.shape[1]
    return d_inner, h, d_inner // h, p.w_b.shape[1]


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv as W shifted adds.  x: [B, T, C]; w: [W, C];
    ``state``: [B, W-1, C], the previous inputs (decode)."""
    width = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, width - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    t_len = x.shape[1]
    y = torch.zeros_like(x)
    for i in range(width):
        y = y + xp[:, i:i + t_len, :] * w[i]
    return y + b


def write_rows(state: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor],
               active: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Copy ``new`` into ``state`` in place at the rows ``active`` (int64
    indices; None: every row); the other rows keep their state."""
    for name, t in new.items():
        if active is None:
            state[name].copy_(t)
        else:
            state[name][active] = t[active].to(state[name].dtype)
    return state


def gate_sq(y: torch.Tensor, z: torch.Tensor):
    """(y * silu(z) in fp32, its sum of squares over the channels)."""
    gf = (y * F.silu(z)).float()
    return gf, (gf * gf).sum(-1, keepdim=True)


def gated_out(p, gf: torch.Tensor, sq: torch.Tensor, d_inner: int, cfg,
              eps: float = 1e-6) -> torch.Tensor:
    """The gated RMS norm over ``d_inner`` channels (``sq``: their sum of
    squares, over every model shard) and the output projection."""
    dt = cdtype(cfg)
    g = (gf * torch.rsqrt(sq / d_inner + eps)).to(dt) * p.norm_scale.to(dt)
    return g @ p.w_out.to(dt)


def _proj(p, x: torch.Tensor, cfg):
    dt = cdtype(cfg)
    z = x @ p.w_z.to(dt)
    xin = x @ p.w_x.to(dt)
    b_ = x @ p.w_b.to(dt)
    c_ = x @ p.w_c.to(dt)
    dtv = F.softplus((x @ p.w_dt.to(dt)).float() + p.dt_bias.float())
    return z, xin, b_, c_, dtv


def ssm_forward(p, x: torch.Tensor, cfg, return_state: bool = False):
    """x: [B, T, D] -> [B, T, D] (training / prefill); with ``return_state``
    also the decode state after the last token."""
    y, z, state = ssm_mix(p, x, cfg)
    gf, sq = gate_sq(y, z)
    y = gated_out(p, gf, sq, y.shape[-1], cfg)
    return (y, state) if return_state else y


def ssm_mix(p, x: torch.Tensor, cfg):
    """The block up to its gated norm: (y, z [B, T, d_inner], decode state),
    over the heads of ``p`` (all, or one model shard's)."""
    bsz, t_len, _ = x.shape
    d_inner, h, p_head, n = _local_dims(p)
    q = min(cfg.ssm_chunk, t_len)
    pad = (-t_len) % q
    if pad:
        # left-pad to a chunk multiple: zero inputs add nothing to the
        # zero initial state, so the real tokens' outputs and states are exact
        x = F.pad(x, (0, 0, pad, 0))
        t_len += pad
    nc = t_len // q
    dt = cdtype(cfg)

    z, xin, b_, c_, dtv = _proj(p, x, cfg)
    xin_pre = xin
    xin = F.silu(causal_conv1d(xin, p.conv_w.to(dt), p.conv_b.to(dt)))

    xh = xin.reshape(bsz, nc, q, h, p_head)
    bch = b_.reshape(bsz, nc, q, n)
    cch = c_.reshape(bsz, nc, q, n)
    dtc = dtv.reshape(bsz, nc, q, h)                              # f32
    a = -torch.exp(p.A_log)                                       # [H] f32, < 0
    cla = torch.cumsum(dtc * a, dim=2)                            # [B,C,Q,H] cum log decay

    # intra-chunk: decay(i, j) = exp(cla_i - cla_j) for j <= i.  Above the
    # diagonal seg > 0 grows with the chunk (exp overflows at full width);
    # the reference masks after exp, whose backward then takes 0 * inf =
    # NaN.  Masking before exp gives the same values and finite gradients.
    seg = cla[:, :, :, None, :] - cla[:, :, None, :, :]           # [B,C,Q,Q,H]
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    dec = torch.exp(seg.masked_fill(~causal[None, None, :, :, None], float("-inf")))
    sc = torch.einsum("bcin,bcjn->bcij", cch.float(), bch.float())  # [B,C,Q,Q] f32
    w_ij = (sc[..., None] * dec).to(dt)                            # [B,C,Q,Q,H]
    xdt = (xh.float() * dtc[..., None]).to(dt)                     # dt-scaled input
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w_ij, xdt)

    # chunk states, then the recurrence across chunks (left to right)
    dec_end = torch.exp(cla[:, :, -1:, :] - cla)                   # [B,C,Q,H]
    sb = torch.einsum("bcjn,bcjh,bcjhp->bchnp", bch.float(), dec_end, xdt.float())
    chunk_decay = torch.exp(cla[:, :, -1, :])                      # [B,C,H]
    runs = [sb[:, 0]]
    for c in range(1, nc):
        runs.append(sb[:, c] + chunk_decay[:, c, :, None, None] * runs[-1])
    s_run = torch.stack(runs, dim=1)                               # [B,C,H,N,P]
    # the state entering chunk c: s_run shifted right by one chunk
    s_prev = torch.cat([torch.zeros_like(s_run[:, :1]), s_run[:, :-1]], dim=1)

    # y_inter_i = exp(cla_i) * C_i . s_prev
    y_inter = torch.einsum("bcin,bcih,bchnp->bcihp", cch.float(), torch.exp(cla),
                           s_prev).to(dt)
    y = y_intra + y_inter + xh * p.D_skip.to(dt)[None, None, None, :, None]
    y = y.reshape(bsz, t_len, d_inner)
    if pad:
        y, z = y[:, pad:], z[:, pad:]
    width = p.conv_w.shape[0]
    return y, z, {"conv": xin_pre[:, -(width - 1):], "ssm": s_run[:, -1]}


def make_ssm_state(cfg, batch: int, device, tp: int = 1) -> Dict[str, torch.Tensor]:
    """The decode state (of one model shard of ``tp``)."""
    d_inner, h, p_head, n = _dims(cfg)
    d_inner, h = d_inner // tp, h // tp
    return {"conv": torch.zeros((batch, cfg.conv1d_width - 1, d_inner), dtype=cdtype(cfg),
                                device=device),
            "ssm": torch.zeros((batch, h, n, p_head), dtype=torch.float32, device=device)}


def ssm_decode(p, x: torch.Tensor, state: Dict[str, torch.Tensor], cfg,
               active: Optional[torch.Tensor] = None):
    """One token.  x: [B, 1, D] -> ([B, 1, D], state), the state written in
    place at the rows ``active`` (int64 indices; None: every row)."""
    y, z = ssm_decode_mix(p, x, state, cfg, active)
    gf, sq = gate_sq(y, z)
    return gated_out(p, gf, sq, y.shape[-1], cfg), state


def ssm_decode_mix(p, x: torch.Tensor, state: Dict[str, torch.Tensor], cfg,
                   active: Optional[torch.Tensor] = None):
    """One token up to the gated norm: (y, z [B, 1, d_inner]), the state
    written in place."""
    bsz = x.shape[0]
    d_inner, h, p_head, n = _local_dims(p)
    dt = cdtype(cfg)

    z, xin, b_, c_, dtv = _proj(p, x, cfg)
    conv_in = torch.cat([state["conv"], xin], dim=1)               # [B, W, C]
    xin = F.silu(causal_conv1d(xin, p.conv_w.to(dt), p.conv_b.to(dt), state=state["conv"]))
    xh = xin.reshape(bsz, h, p_head).float()
    dt1 = dtv.reshape(bsz, h)                                      # f32
    decay = torch.exp(dt1 * -torch.exp(p.A_log))                    # [B, H]
    bx = torch.einsum("bn,bh,bhp->bhnp", b_[:, 0].float(), dt1, xh)
    hnew = decay[..., None, None] * state["ssm"] + bx
    y = torch.einsum("bn,bhnp->bhp", c_[:, 0].float(), hnew)
    y = (y + xh * p.D_skip.float()[None, :, None]).to(dt).reshape(bsz, 1, d_inner)
    write_rows(state, {"conv": conv_in[:, 1:], "ssm": hnew}, active)
    return y, z
