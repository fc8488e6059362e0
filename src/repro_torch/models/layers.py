"""Shared layers: norms, RoPE, gated MLPs, embeddings.

Counterpart of ``repro.models.layers``.  Parameters live in ``ParamSet``
modules whose attribute names are the reference's dict keys (``w_q``,
``scale``, ``embedding`` ...), so a reference parameter pytree maps onto the
port's state dict name by name (``models/convert.py``).

Each ``init_*`` has a ``*_specs`` beside it: the reference's
``PartitionSpec`` of every parameter as a tuple (``distributed/mesh.py``),
``MODEL`` the tensor-parallel axis, ``DATA`` a placeholder for the batch
axes that ``resolve_specs`` replaces once the mesh is known.

Weights are stored in ``cfg.param_dtype`` (fp32 by default) and cast to
``cfg.dtype`` (bf16) at use, as in the reference.  Where the reference asks
for fp32 accumulation of bf16 operands (``preferred_element_type``), the
port upcasts the operands: a product of two bf16 values is exact in fp32,
so only the order of the fp32 sums differs.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "MODEL", "DATA", "resolve_specs", "norm_specs", "mlp_specs", "embed_specs",
    "ParamSet", "cdtype", "pdtype", "winit", "init_norm",
    "apply_norm", "rope_frequencies", "apply_rope", "init_mlp", "apply_mlp",
    "padded_vocab", "init_embed", "apply_embed", "apply_unembed",
    "softmax_xent",
]

MODEL = "model"
# the batch-sharding axes, ("data",) or ("pod", "data") once the mesh is known
DATA = "__data__"


def resolve_specs(tree, data_axes):
    """Replace the DATA placeholder in a (nested) dict of specs with the
    mesh's batch axes (``repro/models/layers.py:30-45``)."""
    if isinstance(tree, dict):
        return {k: resolve_specs(v, data_axes) for k, v in tree.items()}
    if isinstance(tree, list):
        return [resolve_specs(v, data_axes) for v in tree]
    return tuple(tuple(data_axes) if e == DATA else e for e in tree)


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


class ParamSet(nn.Module):
    """A flat set of named parameters (one of the reference's param dicts)."""

    def __init__(self, **tensors: torch.Tensor):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t))

    def __contains__(self, name: str) -> bool:
        return name in self._parameters


# --------------------------------------------------------------------------
# dtype helpers
# --------------------------------------------------------------------------
def cdtype(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def pdtype(cfg) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


def winit(gen: torch.Generator, shape, fan_in: int, dtype, device) -> torch.Tensor:
    """normal / sqrt(fan_in), the reference's ``_winit`` distribution."""
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (x / np.sqrt(fan_in)).to(dtype)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------
def init_norm(cfg, d: int, device) -> ParamSet:
    scale = torch.ones((d,), dtype=pdtype(cfg), device=device)
    if cfg.norm == "layernorm":
        return ParamSet(scale=scale,
                        bias=torch.zeros((d,), dtype=pdtype(cfg), device=device))
    return ParamSet(scale=scale)


def norm_specs(cfg) -> dict:
    return {"scale": (None,), "bias": (None,)} if cfg.norm == "layernorm" else {"scale": (None,)}


def apply_norm(p, x: torch.Tensor, cfg, eps: float = 1e-6) -> torch.Tensor:
    """Norm with fp32 statistics, applied in the compute dtype
    (``repro/models/layers.py:74-98``)."""
    dt = x.dtype
    if cfg.norm == "layernorm":
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        rs = torch.rsqrt(var + eps)
        y = (x - mu.to(dt)) * rs.to(dt)
        y = y * p.scale.to(dt) + p.bias.to(dt)
    else:  # rmsnorm: an fp32-accumulated sum of squares
        xf = x.float()
        sq = (xf * xf).sum(-1)
        var = (sq / x.shape[-1])[..., None]
        rs = torch.rsqrt(var + eps)
        scale = p.scale.float()
        if cfg.gemma_norm_plus_one:
            scale = scale + 1.0
        y = x * rs.to(dt) * scale.to(dt)
    return y.to(dt)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------
def rope_frequencies(d_head: int, rope_pct: float, theta: float) -> Tuple[int, np.ndarray]:
    """Inverse frequencies (numpy float32) for the rotated fraction of dims."""
    d_rot = int(d_head * rope_pct) // 2 * 2
    inv = 1.0 / (theta ** (np.arange(0, d_rot, 2, dtype=np.float32) / d_rot))
    return d_rot, inv.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _inv_frequencies(d_head: int, rope_pct: float, theta: float, device) -> torch.Tensor:
    """``rope_frequencies`` on ``device``, copied there once (a copy from
    pageable host memory per call would wait for the device every layer)."""
    return torch.from_numpy(rope_frequencies(d_head, rope_pct, theta)[1]).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, rope_pct: float,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, Dh]; positions: broadcastable [..., S] integers.
    Rotates interleaved pairs (dims 0::2 with 1::2) of the first d_rot dims,
    in fp32, and rounds once to x's dtype."""
    d_rot = int(x.shape[-1] * rope_pct) // 2 * 2
    if d_rot == 0:
        return x
    inv_t = _inv_frequencies(x.shape[-1], rope_pct, theta, x.device)
    ang = positions[..., :, None].float() * inv_t              # [..., S, d_rot/2]
    sin = torch.sin(ang)[..., :, None, :]                       # [..., S, 1, d_rot/2]
    cos = torch.cos(ang)[..., :, None, :]
    xr, xp = x[..., :d_rot], x[..., d_rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr.to(x.dtype), xp], dim=-1)


# --------------------------------------------------------------------------
# dense / gated MLP
# --------------------------------------------------------------------------
def init_mlp(cfg, gen: torch.Generator, device) -> ParamSet:
    d, f, dt = cfg.d_model, cfg.d_ff, pdtype(cfg)
    p = {}
    if cfg.mlp_gated:
        p["w_gate"] = winit(gen, (d, f), d, dt, device)
    p["w_up"] = winit(gen, (d, f), d, dt, device)
    p["w_down"] = winit(gen, (f, d), f, dt, device)
    return ParamSet(**p)


def mlp_specs(cfg) -> dict:
    """gate / up split over d_ff, down over its rows."""
    s = {"w_up": (None, MODEL), "w_down": (MODEL, None)}
    if cfg.mlp_gated:
        s["w_gate"] = (None, MODEL)
    return s


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    if kind == "relu":
        return F.relu(x)
    raise ValueError(f"unknown activation {kind!r}")


def apply_mlp(p, x: torch.Tensor, cfg) -> torch.Tensor:
    dt = cdtype(cfg)
    if cfg.mlp_gated:
        h = _act(x @ p.w_gate.to(dt), cfg.act) * (x @ p.w_up.to(dt))
    else:
        h = _act(x @ p.w_up.to(dt), cfg.act)
    return h @ p.w_down.to(dt)


# --------------------------------------------------------------------------
# embeddings / unembedding
# --------------------------------------------------------------------------
def padded_vocab(cfg) -> int:
    vp = cfg.vocab_pad_multiple
    return ((cfg.vocab_size + vp - 1) // vp) * vp


def init_embed(cfg, gen: torch.Generator, device) -> ParamSet:
    v, d, dt = padded_vocab(cfg), cfg.d_model, pdtype(cfg)
    p = {"embedding": winit(gen, (v, d), d, dt, device)}
    if not cfg.tie_embeddings:
        p["unembed"] = winit(gen, (d, v), d, dt, device)
    return ParamSet(**p)


def embed_specs(cfg) -> dict:
    """The embedding split over vocabulary rows, the unembedding over columns."""
    s = {"embedding": (MODEL, None)}
    if not cfg.tie_embeddings:
        s["unembed"] = (None, MODEL)
    return s


def apply_embed(p, tokens: torch.Tensor, cfg) -> torch.Tensor:
    dt = cdtype(cfg)
    x = F.embedding(tokens, p.embedding).to(dt)    # rows cast = cast, then rows
    if cfg.emb_scale:   # the scale rounded to the compute dtype, as the reference's
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=dt).item()
    return x


def apply_unembed(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """fp32 logits [*, V_pad] (softcapped if configured)."""
    dt = cdtype(cfg)
    w = p.embedding.to(dt).T if cfg.tie_embeddings else p.unembed.to(dt)
    logits = (x @ w).float()
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Mean CE over tokens; labels < 0 are masked, and so are the logits of
    the vocabulary's pad columns."""
    v_pad = logits.shape[-1]
    if v_pad != vocab_size:
        pad = torch.arange(v_pad, device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.clamp(0, vocab_size - 1).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    nll = (lse - ll) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)
