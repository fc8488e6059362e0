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

from repro_torch.models.layers import DATA, MODEL, ParamSet, apply_rope, cdtype, pdtype, winit

__all__ = ["heads_padded", "kv_sharded", "init_attention", "attention_specs", "attend",
           "prefill_cache", "attn_forward", "make_cache", "cache_specs", "attn_decode",
           "decode_slots", "write_cache", "cache_values", "valid_slots", "attn_scale",
           "NEG_INF"]

NEG_INF = -1e30


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------
def heads_padded(cfg, tp: int) -> int:
    """The query heads, padded up to a multiple of ``tp`` where ``tp`` does
    not divide them (``repro/models/attention.py:45``)."""
    h = cfg.n_heads
    if tp > 1 and h % tp:
        return ((h + tp - 1) // tp) * tp
    return h


def kv_sharded(cfg, tp: int) -> bool:
    """K / V split over the model axis by kv head (else replicated)."""
    return tp > 1 and cfg.n_kv_heads % tp == 0


def init_attention(cfg, gen: torch.Generator, device, tp: int = 1) -> ParamSet:
    """``heads_padded(cfg, tp)`` query heads; the padded ones (the last
    heads of each kv group) zeroed in ``w_q`` and ``w_o``, so the function
    is the unpadded model's."""
    d, dh, kv = cfg.d_model, cfg.d_head, cfg.n_kv_heads
    h = heads_padded(cfg, tp)
    dt = pdtype(cfg)
    p = {
        "w_q": winit(gen, (d, h, dh), d, dt, device),
        "w_k": winit(gen, (d, kv, dh), d, dt, device),
        "w_v": winit(gen, (d, kv, dh), d, dt, device),
        "w_o": winit(gen, (h, dh, d), h * dh, dt, device),
    }
    if h != cfg.n_heads:
        live = (torch.arange(h, device=device) % (h // kv)) < cfg.n_heads // kv
        p["w_q"] = p["w_q"] * live[None, :, None].to(dt)
        p["w_o"] = p["w_o"] * live[:, None, None].to(dt)
    if cfg.attn_bias:
        p["b_q"] = torch.zeros((h, dh), dtype=dt, device=device)
        p["b_k"] = torch.zeros((kv, dh), dtype=dt, device=device)
        p["b_v"] = torch.zeros((kv, dh), dtype=dt, device=device)
    return ParamSet(**p)


def attention_specs(cfg, tp: int) -> dict:
    """Query heads and ``w_o``'s rows split over the model axis; K / V by
    kv head where ``kv_sharded``, else replicated."""
    kv = (None, MODEL, None) if kv_sharded(cfg, tp) else (None, None, None)
    s = {"w_q": (None, MODEL, None), "w_k": kv, "w_v": kv, "w_o": (MODEL, None, None)}
    if cfg.attn_bias:
        bkv = (MODEL, None) if kv_sharded(cfg, tp) else (None, None)
        s.update(b_q=(MODEL, None), b_k=bkv, b_v=bkv)
    return s


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
def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg, *, start: int,
           causal: bool, window: int) -> torch.Tensor:
    """q: [B, S, H, dh], k / v: [B, S, KV, dh] (H a multiple of KV) -> the
    attention output [B, S, H, dh]: one masked softmax up to
    ``full_attn_threshold`` tokens, blocks with an online softmax above."""
    if q.shape[1] <= cfg.full_attn_threshold:
        return _attend_full(q, k, v, cfg, start=start, causal=causal, window=window)
    return _attend_blocks(q, k, v, cfg, start=start, causal=causal, window=window,
                          q_chunk=cfg.attn_q_chunk or 2048, kv_chunk=cfg.attn_kv_chunk or 2048)


def prefill_cache(k: torch.Tensor, v: torch.Tensor, layer_window: int,
                  start: int) -> Dict[str, torch.Tensor]:
    """The decode-layout cache of a prefill's K / V: a window layer keeps
    its last W positions at slots (start + i) % W (a rolling buffer)."""
    s_len = k.shape[1]
    if layer_window and layer_window < s_len:
        w = layer_window
        slots = (start + torch.arange(s_len - w, s_len, device=k.device)) % w
        order = torch.argsort(slots)
        return {"k": k[:, s_len - w:][:, order], "v": v[:, s_len - w:][:, order]}
    return {"k": k, "v": v}


def attn_forward(p, x: torch.Tensor, cfg, *, layer_window: int, causal: bool,
                 start: int = 0, return_kv: bool = False):
    """Training / prefill attention.  x: [B, S, D] -> [B, S, D] (+ the
    decode-layout KV cache when ``return_kv``, for serving prefill)."""
    positions = start + torch.arange(x.shape[1], device=x.device)
    q, k, v = _qkv(p, x, cfg, positions)
    out = attend(q, k, v, cfg, start=start, causal=causal, window=layer_window)
    y = torch.einsum("bshk,hkd->bsd", out, p.w_o.to(cdtype(cfg)))
    if not return_kv:
        return y
    return y, prefill_cache(k, v, layer_window, start)


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


def cache_specs(cfg, tp: int) -> Dict[str, tuple]:
    """The cache's specs (``repro/models/attention.py:261-275``): batch over
    the data axes; K / V by kv head where ``kv_sharded``, else split along
    the cache's length over the model axis."""
    kv_axis = MODEL if kv_sharded(cfg, tp) else None
    spec = (DATA, None if kv_axis == MODEL else MODEL, kv_axis, None)
    names = ("k", "v", "k_scale", "v_scale") if cfg.kv_cache_dtype == "int8" else ("k", "v")
    return {n: spec for n in names}


def _quantize_kv(x: torch.Tensor):
    """x: [B, 1, KV, dh] -> (int8 values, bf16 per-(token, head) scales)."""
    xf = x.float()
    scale = xf.abs().amax(-1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(xf / torch.clamp(scale, min=1e-9)), -127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def decode_slots(pos_b: torch.Tensor, length: int, layer_window: int) -> torch.Tensor:
    """The cache slot each row's token goes to: pos % length in a rolling
    window buffer, else min(pos, length - 1)."""
    return pos_b % length if layer_window else torch.clamp(pos_b, max=length - 1)


def write_cache(cache: Dict[str, torch.Tensor], rows: torch.Tensor, slot: torch.Tensor,
                k_new: torch.Tensor, v_new: torch.Tensor, cfg) -> None:
    """Write ``rows``' new K / V ([B, 1, KV, dh]) at cache slots ``slot``
    (one per row of ``rows``), in place; quantized where the cache is int8."""
    if cfg.kv_cache_dtype == "int8":
        k_new, ks_new = _quantize_kv(k_new)
        v_new, vs_new = _quantize_kv(v_new)
        cache["k_scale"][rows, slot] = ks_new[rows, 0]
        cache["v_scale"][rows, slot] = vs_new[rows, 0]
    cache["k"][rows, slot] = k_new[rows, 0]
    cache["v"][rows, slot] = v_new[rows, 0]


def write_cache_where(cache: Dict[str, torch.Tensor], rows: torch.Tensor, slot: torch.Tensor,
                      keep: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                      cfg) -> None:
    """``write_cache`` at every row of ``rows``: the new K / V where
    ``keep``, the cache's own values (written back) elsewhere.  No shape
    depends on the data (``keep`` selects by value, not by index), so it
    also runs on ``meta`` tensors; each row writes one slot of its own
    cache row, so the written-back rows change nothing."""
    pairs = [("k", k_new), ("v", v_new)]
    if cfg.kv_cache_dtype == "int8":
        k_new, ks_new = _quantize_kv(k_new)
        v_new, vs_new = _quantize_kv(v_new)
        pairs = [("k_scale", ks_new), ("v_scale", vs_new), ("k", k_new), ("v", v_new)]
    for name, new in pairs:
        t = cache[name]
        old = t[rows, slot]
        m = keep.reshape((-1,) + (1,) * (old.dim() - 1))
        t[rows, slot] = torch.where(m, new[rows, 0], old)


def cache_values(cache: Dict[str, torch.Tensor], cfg):
    """The cache's K / V in the compute dtype (dequantized if int8)."""
    if cfg.kv_cache_dtype == "int8":
        dt = cdtype(cfg)
        return cache["k"].to(dt) * cache["k_scale"].to(dt), cache["v"].to(dt) * cache["v_scale"].to(dt)
    return cache["k"], cache["v"]


def valid_slots(pos_b: torch.Tensor, idx: torch.Tensor, length: int,
                layer_window: int) -> torch.Tensor:
    """bool [B, len(idx)]: whether cache slot ``idx`` (of ``length``) holds
    a position each row may attend to at ``pos_b``."""
    pb = pos_b[:, None]
    if layer_window:
        # rolling buffer: slot i holds the largest p' <= pos with p' % L == i
        stored = pb - ((pb - idx[None, :]) % length)
        return (stored >= 0) & (stored > pb - layer_window)
    return idx[None, :] <= pb


def attn_decode(p, x: torch.Tensor, cache: Dict[str, torch.Tensor], pos: torch.Tensor,
                cfg, *, layer_window: int, active: Optional[torch.Tensor] = None):
    """Single-token decode.  x: [B, 1, D]; pos: an integer scalar (lockstep)
    or [B] (per slot, continuous batching); active: int64[n] the indices of
    the rows whose cache may be written (None: all).  Writes the cache in
    place and returns (out [B, 1, D], cache).  The K / V heads are the
    cache's: a kv-head shard of it with the matching query heads works too."""
    b = x.shape[0]
    pos_b = pos.reshape(-1).expand(b) if pos.dim() == 0 else pos
    q, k_new, v_new = _qkv(p, x, cfg, pos_b[:, None])
    length = cache["k"].shape[1]
    slot = decode_slots(pos_b, length, layer_window)
    rows = torch.arange(b, device=x.device) if active is None else active
    write_cache(cache, rows, slot[rows], k_new, v_new, cfg)

    kv, dh = cache["k"].shape[2], cfg.d_head
    h = q.shape[2]
    qg = q.reshape(b, 1, kv, h // kv, dh)
    ck, cv = cache_values(cache, cfg)
    sc = _block_scores(qg, ck, cfg)[..., 0, :]                   # [B,KV,G,T]
    valid = valid_slots(pos_b, torch.arange(length, device=x.device), length, layer_window)
    sc.masked_fill_(~valid[:, None, None, :], NEG_INF)
    pa = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", pa.to(cv.dtype).float(), cv.float()).to(x.dtype)
    y = torch.einsum("bshk,hkd->bsd", out.reshape(b, 1, h, dh), p.w_o.to(cdtype(cfg)))
    return y, cache
