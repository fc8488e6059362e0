"""GQA attention: full / blocked (online softmax) / sliding window / decode.

Counterpart of ``repro.models.attention``, as torch ops (einsum and a
masked softmax; no fused attention call): the reference has no Pallas
kernel here.

* **Blocked prefill**: above ``full_attn_threshold`` queries and keys run
  in blocks with an online softmax; the block loops are Python loops, so
  blocks that the causal mask or the window empty are skipped.
* **GQA**: K/V are never repeated to H heads; scores are computed group-wise
  ([B,S,KV,G,dh] x [B,T,KV,dh]).
* **Decode** reads a [B, T, KV, dh] cache (a rolling window buffer for
  local layers) and masks by the position stored in each slot.  It writes
  the new token's K/V into the cache in place, at each active row's slot
  only (the reference rebuilds the whole cache with a select; the result
  is the same).

Positions are ``start + arange(S)`` (unpacked batches).  Scores and the
softmax-weighted sum of V accumulate in fp32 from bf16 operands.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.models.layers import ParamSet, apply_rope, cdtype, pdtype, winit

__all__ = ["init_attention", "attn_forward", "make_cache", "attn_decode",
           "attn_scale", "NEG_INF"]

NEG_INF = -1e30


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------
def init_attention(cfg, gen: torch.Generator, device) -> ParamSet:
    d, dh, h, kv = cfg.d_model, cfg.d_head, cfg.n_heads, cfg.n_kv_heads
    dt = pdtype(cfg)
    p = {
        "w_q": winit(gen, (d, h, dh), d, dt, device),
        "w_k": winit(gen, (d, kv, dh), d, dt, device),
        "w_v": winit(gen, (d, kv, dh), d, dt, device),
        "w_o": winit(gen, (h, dh, d), h * dh, dt, device),
    }
    if cfg.attn_bias:
        p["b_q"] = torch.zeros((h, dh), dtype=dt, device=device)
        p["b_k"] = torch.zeros((kv, dh), dtype=dt, device=device)
        p["b_v"] = torch.zeros((kv, dh), dtype=dt, device=device)
    return ParamSet(**p)


def _rms(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    return (xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)).to(x.dtype)


def _qkv(p, x: torch.Tensor, cfg, positions: torch.Tensor):
    dt = cdtype(cfg)
    q = torch.einsum("bsd,dhk->bshk", x, p.w_q.to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p.w_k.to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p.w_v.to(dt))
    if cfg.attn_bias:
        q = q + p.b_q.to(dt)
        k = k + p.b_k.to(dt)
        v = v + p.b_v.to(dt)
    if cfg.qk_norm:
        q = _rms(q)
        k = _rms(k)
    q = apply_rope(q, positions, rope_pct=cfg.rope_pct, theta=cfg.rope_theta)
    k = apply_rope(k, positions, rope_pct=cfg.rope_pct, theta=cfg.rope_theta)
    return q, k, v


def attn_scale(cfg) -> float:
    return cfg.attn_scale if cfg.attn_scale else 1.0 / np.sqrt(cfg.d_head)


def _softcap_(s: torch.Tensor, cap: float) -> torch.Tensor:
    """tanh(s / cap) * cap, in place (s is a fresh fp32 score tile) unless
    autograd records it: tanh's backward reads its output, which the
    multiply would overwrite."""
    if cap:
        if s.requires_grad:
            return torch.tanh(s / cap) * cap
        s.div_(cap).tanh_().mul_(cap)
    return s


# --------------------------------------------------------------------------
# block attention core (online softmax)
# --------------------------------------------------------------------------
def _block_scores(qb: torch.Tensor, kb: torch.Tensor, cfg) -> torch.Tensor:
    """qb: [B,qc,KV,G,dh]  kb: [B,kc,KV,dh] -> f32 [B,KV,G,qc,kc] (scaled and
    softcapped in place: the [.., S, T] tiles are the attention's traffic)."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", qb.float(), kb.float())
    return _softcap_(s.mul_(attn_scale(cfg)), cfg.attn_softcap)


def _weighted_values(pa: torch.Tensor, vb: torch.Tensor) -> torch.Tensor:
    """pa: f32 [B,KV,G,q,k] (rounded to V's dtype, as the reference does)
    x vb: [B,k,KV,dh] -> f32 [B,q,KV,G,dh]."""
    return torch.einsum("bhgqk,bkhd->bqhgd", pa.to(vb.dtype).float(), vb.float())


def _mask(q0: int, q1: int, k0: int, k1: int, start: int, causal: bool,
          window: int, device) -> torch.Tensor:
    qp = start + torch.arange(q0, q1, device=device)
    kp = start + torch.arange(k0, k1, device=device)
    msk = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool, device=device)
    if causal:
        msk &= kp[None, :] <= qp[:, None]
    if window:
        msk &= kp[None, :] > qp[:, None] - window
    return msk


def _attend_blocks(q, k, v, cfg, *, start: int, causal: bool, window: int,
                   q_chunk: int, kv_chunk: int) -> torch.Tensor:
    """Online-softmax blocked attention.  q: [B,S,H,dh], k/v: [B,T,KV,dh];
    token i sits at absolute position start + i (self-attention)."""
    b, s_len, h, dh = q.shape
    t_len, kv = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, s_len, kv, g, dh)
    n_qb = (s_len + q_chunk - 1) // q_chunk
    n_kb = (t_len + kv_chunk - 1) // kv_chunk
    outs = []
    for i in range(n_qb):
        q0, q1 = i * q_chunk, min((i + 1) * q_chunk, s_len)
        qb = qg[:, q0:q1]
        m = torch.full((b, kv, g, q1 - q0), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, kv, g, q1 - q0), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, q1 - q0, kv, g, dh), dtype=torch.float32, device=q.device)
        for j in range(n_kb):
            k0, k1 = j * kv_chunk, min((j + 1) * kv_chunk, t_len)
            if causal and k0 > q1 - 1:
                continue  # block strictly in the future
            if window and (k1 - 1) < q0 - window + 1:
                continue  # block strictly outside the window
            sc = _block_scores(qb, k[:, k0:k1], cfg)            # [B,KV,G,qc,kc]
            if (causal and k1 - 1 > q0) or (window and k0 <= (q1 - 1) - window + 1):
                msk = _mask(q0, q1, k0, k1, start, causal, window, q.device)
                sc.masked_fill_(~msk, NEG_INF)
            m_new = torch.maximum(m, sc.amax(-1))
            pexp = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + pexp.sum(-1)
            acc = (acc * corr.permute(0, 3, 1, 2)[..., None]
                   + _weighted_values(pexp, v[:, k0:k1]))
            m = m_new
        l_safe = torch.clamp(l.permute(0, 3, 1, 2)[..., None], min=1e-30)
        outs.append((acc / l_safe).to(q.dtype))
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return out.reshape(b, s_len, h, dh)


def _attend_full(q, k, v, cfg, *, start: int, causal: bool, window: int) -> torch.Tensor:
    b, s_len, h, dh = q.shape
    t_len, kv = k.shape[1], k.shape[2]
    qg = q.reshape(b, s_len, kv, h // kv, dh)
    sc = _block_scores(qg, k, cfg)                               # [B,KV,G,S,T]
    if causal or window:
        sc.masked_fill_(~_mask(0, s_len, 0, t_len, start, causal, window, q.device), NEG_INF)
    pa = torch.softmax(sc, dim=-1)
    return _weighted_values(pa, v).to(q.dtype).reshape(b, s_len, h, dh)


# --------------------------------------------------------------------------
# public entry points
# --------------------------------------------------------------------------
def attn_forward(p, x: torch.Tensor, cfg, *, layer_window: int, causal: bool,
                 start: int = 0, return_kv: bool = False):
    """Training / prefill attention.  x: [B, S, D] -> [B, S, D] (+ the
    decode-layout KV cache when ``return_kv``, for serving prefill)."""
    s_len = x.shape[1]
    positions = start + torch.arange(s_len, device=x.device)
    q, k, v = _qkv(p, x, cfg, positions)
    if s_len <= cfg.full_attn_threshold:
        out = _attend_full(q, k, v, cfg, start=start, causal=causal, window=layer_window)
    else:
        out = _attend_blocks(q, k, v, cfg, start=start, causal=causal,
                             window=layer_window, q_chunk=cfg.attn_q_chunk or 2048,
                             kv_chunk=cfg.attn_kv_chunk or 2048)
    y = torch.einsum("bshk,hkd->bsd", out, p.w_o.to(cdtype(cfg)))
    if not return_kv:
        return y
    if layer_window and layer_window < s_len:
        # rolling cache: the last W positions at slots (start + i) % W
        w = layer_window
        slots = (start + torch.arange(s_len - w, s_len, device=x.device)) % w
        order = torch.argsort(slots)
        cache = {"k": k[:, s_len - w:][:, order], "v": v[:, s_len - w:][:, order]}
    else:
        cache = {"k": k, "v": v}
    return y, cache


def make_cache(cfg, batch: int, max_len: int, layer_window: int, device) -> Dict[str, torch.Tensor]:
    """KV cache for one attention layer: a rolling window buffer for local
    layers; with ``cfg.kv_cache_dtype == "int8"`` int8 K/V with bf16
    per-(token, head) scales."""
    kv, dh = cfg.n_kv_heads, cfg.d_head
    length = min(layer_window, max_len) if layer_window else max_len
    shape = (batch, length, kv, dh)
    if cfg.kv_cache_dtype == "int8":
        sshape = (batch, length, kv, 1)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(sshape, dtype=torch.bfloat16, device=device),
                "v_scale": torch.zeros(sshape, dtype=torch.bfloat16, device=device)}
    return {"k": torch.zeros(shape, dtype=cdtype(cfg), device=device),
            "v": torch.zeros(shape, dtype=cdtype(cfg), device=device)}


def _quantize_kv(x: torch.Tensor):
    """x: [B, 1, KV, dh] -> (int8 values, bf16 per-(token, head) scales)."""
    xf = x.float()
    scale = xf.abs().amax(-1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(xf / torch.clamp(scale, min=1e-9)), -127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def attn_decode(p, x: torch.Tensor, cache: Dict[str, torch.Tensor], pos: torch.Tensor,
                cfg, *, layer_window: int, active: Optional[torch.Tensor] = None):
    """Single-token decode.  x: [B, 1, D]; pos: an integer scalar (lockstep)
    or [B] (per slot, continuous batching); active: int64[n] the indices of
    the rows whose cache may be written (None: all).  Writes the cache in
    place and returns (out [B, 1, D], cache)."""
    b = x.shape[0]
    pos_b = pos.reshape(-1).expand(b) if pos.dim() == 0 else pos
    q, k_new, v_new = _qkv(p, x, cfg, pos_b[:, None])
    quantized = cfg.kv_cache_dtype == "int8"
    length = cache["k"].shape[1]
    slot = pos_b % length if layer_window else torch.clamp(pos_b, max=length - 1)
    rows = torch.arange(b, device=x.device)
    if active is not None:
        rows = active
        slot = slot[rows]
    if quantized:
        k_w, ks_new = _quantize_kv(k_new)
        v_w, vs_new = _quantize_kv(v_new)
        cache["k_scale"][rows, slot] = ks_new[rows, 0]
        cache["v_scale"][rows, slot] = vs_new[rows, 0]
    else:
        k_w, v_w = k_new, v_new
    cache["k"][rows, slot] = k_w[rows, 0]
    cache["v"][rows, slot] = v_w[rows, 0]

    dt = cdtype(cfg)
    kv, dh = cfg.n_kv_heads, cfg.d_head
    h = q.shape[2]
    qg = q.reshape(b, 1, kv, h // kv, dh)
    if quantized:
        ck = cache["k"].to(dt) * cache["k_scale"].to(dt)
        cv = cache["v"].to(dt) * cache["v_scale"].to(dt)
    else:
        ck, cv = cache["k"], cache["v"]
    sc = _block_scores(qg, ck, cfg)[..., 0, :]                   # [B,KV,G,T]

    # the position each cache slot holds, per batch row
    idx = torch.arange(length, device=x.device)
    pb = pos_b[:, None]
    if layer_window:
        # rolling buffer: slot i holds the largest p' <= pos with p' % L == i
        stored = pb - ((pb - idx[None, :]) % length)
        valid = (stored >= 0) & (stored > pb - layer_window)
    else:
        valid = idx[None, :] <= pb
    sc.masked_fill_(~valid[:, None, None, :], NEG_INF)
    pa = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", pa.to(cv.dtype).float(), cv.float()).to(x.dtype)
    y = torch.einsum("bshk,hkd->bsd", out.reshape(b, 1, h, dh), p.w_o.to(dt))
    return y, cache
