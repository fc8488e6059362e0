"""Analytic parameter counts + MODEL_FLOPS (the "useful work" yardstick).

Counterpart of ``repro.roofline.model_flops``, copied whole: pure shape
arithmetic on an ``ArchConfig`` (``repro_torch.configs``).
``param_counts`` derives N analytically from the config (logical heads — no
TP padding pollution); ``tests/test_torch_roofline.py`` holds it against
the numel of ``LanguageModel(cfg, tp=1, device="meta")``.

MODEL_FLOPS follows the assignment: 6*N*D for training (N = active
non-embedding params, D = tokens), 2*N*D for inference forward.  A refined
estimate adds the attention score/AV work (the part 6ND ignores), reported
alongside.
"""

from __future__ import annotations

from typing import Dict

__all__ = ["param_counts", "model_flops"]


def _norm_params(cfg) -> int:
    return 2 * cfg.d_model if cfg.norm == "layernorm" else cfg.d_model


def _layer_params(cfg, kind) -> Dict[str, int]:
    mixer, mlp = kind
    d = cfg.d_model
    out: Dict[str, int] = {"norms": _norm_params(cfg)}
    if cfg.post_norm:
        out["norms"] += _norm_params(cfg)
    if mixer in ("global", "local"):
        h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        p = d * h * dh + 2 * d * kv * dh + h * dh * d
        if cfg.attn_bias:
            p += h * dh + 2 * kv * dh
        out["mixer"] = p
    elif mixer == "rglru":
        r = cfg.lru_width or d
        out["mixer"] = 4 * d * r + r * d + cfg.conv1d_width * r + r + 2 * r + r
    elif mixer == "ssm":
        di = cfg.ssm_expand * d
        hh = cfg.ssm_heads or di // 64
        n = cfg.ssm_state
        out["mixer"] = (
            2 * d * di + 2 * d * n + d * hh + hh  # z,x,b,c,dt(+bias)
            + 2 * hh                              # A_log, D_skip
            + cfg.conv1d_width * di + di          # conv w,b
            + di                                  # norm_scale
            + di * d                              # out
        )
    if mlp == "dense":
        out["norms"] += _norm_params(cfg) + (_norm_params(cfg) if cfg.post_norm else 0)
        out["mlp"] = (3 if cfg.mlp_gated else 2) * d * cfg.d_ff
    elif mlp == "moe":
        out["norms"] += _norm_params(cfg) + (_norm_params(cfg) if cfg.post_norm else 0)
        out["router"] = d * cfg.n_experts
        out["experts"] = 3 * cfg.n_experts * d * cfg.d_ff
        out["experts_active"] = 3 * cfg.moe_top_k * d * cfg.d_ff
        if cfg.n_shared_experts:
            out["shared"] = 3 * d * cfg.n_shared_experts * cfg.d_ff
    return out


def param_counts(cfg) -> Dict[str, int]:
    """Returns dict with total/embedding/non-embedding/active counts."""
    vp = ((cfg.vocab_size + cfg.vocab_pad_multiple - 1)
          // cfg.vocab_pad_multiple) * cfg.vocab_pad_multiple
    emb = vp * cfg.d_model
    if not cfg.tie_embeddings:
        emb += cfg.d_model * vp
    frontend = 0
    if cfg.frontend != "none":
        frontend = cfg.frontend_dim * cfg.d_model
        if cfg.frontend == "vision":
            frontend += cfg.frontend_tokens * cfg.d_model

    nonemb = frontend + _norm_params(cfg)  # final norm
    active = nonemb
    for kind in cfg.layer_kinds():
        lp = _layer_params(cfg, kind)
        fixed = lp.get("norms", 0) + lp.get("mixer", 0) + lp.get("mlp", 0) \
            + lp.get("router", 0) + lp.get("shared", 0)
        nonemb += fixed + lp.get("experts", 0)
        active += fixed + lp.get("experts_active", 0)
    return {
        "embedding": emb,
        "non_embedding": nonemb,
        "active_non_embedding": active,
        "total": emb + nonemb,
    }


def _attn_extra_flops_per_token(cfg, s_len: int, kind: str) -> float:
    """QK^T + AV flops per token for one attention layer (fwd).

    s_eff = mean lookback: causal (S+1)/2; local causal = exact mean of
    min(i+1, W); encoder (bidirectional) = S."""
    if cfg.encoder_only:
        s_eff = float(s_len)
    elif kind == "local" and cfg.window and s_len > cfg.window:
        w = cfg.window
        s_eff = (w * (w + 1) / 2 + (s_len - w) * w) / s_len
    else:
        s_eff = (s_len + 1) / 2
    return 4.0 * cfg.n_heads * cfg.d_head * s_eff


def _ssd_extra_flops_per_token(cfg) -> float:
    """Intra-chunk quadratic + state terms per token (fwd)."""
    di = cfg.ssm_expand * cfg.d_model
    hh = cfg.ssm_heads or di // 64
    p = di // hh
    n = cfg.ssm_state
    q = cfg.ssm_chunk
    # scores C.B^T: 2*q*n ; y_intra: 2*q*h*p ; states: 2*n*h*p*2
    return 2.0 * q * n + 2.0 * q * hh * p + 4.0 * n * hh * p


def model_flops(cfg, shape) -> Dict[str, float]:
    """MODEL_FLOPS for a shape cell (whole-job, all chips).

    train: 6*N_active*T (spec) ; refined adds attention/SSD quadratic terms.
    prefill: 2*N_active*T (+ extras).
    decode: 2*N_active*B new tokens (+ cache attention reads).
    """
    pc = param_counts(cfg)
    n_act = pc["active_non_embedding"]
    vp_flops_per_tok = 2.0 * cfg.d_model * cfg.vocab_size  # unembed fwd

    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        tokens = b * s
        spec = 6.0 * n_act * tokens
        extra = 0.0
        for kind in cfg.layer_kinds():
            if kind[0] in ("global", "local"):
                extra += 3.0 * _attn_extra_flops_per_token(cfg, s, kind[0]) * tokens
            elif kind[0] == "ssm":
                extra += 3.0 * _ssd_extra_flops_per_token(cfg) * tokens
        refined = spec + extra + 3.0 * vp_flops_per_tok * tokens
        return {"spec": spec, "refined": refined, "tokens": float(tokens)}
    if shape.kind == "prefill":
        tokens = b * s
        spec = 2.0 * n_act * tokens
        extra = 0.0
        for kind in cfg.layer_kinds():
            if kind[0] in ("global", "local"):
                extra += _attn_extra_flops_per_token(cfg, s, kind[0]) * tokens
            elif kind[0] == "ssm":
                extra += _ssd_extra_flops_per_token(cfg) * tokens
        refined = spec + extra + vp_flops_per_tok * b  # only last pos unembedded
        return {"spec": spec, "refined": refined, "tokens": float(tokens)}
    # decode: one new token per sequence
    tokens = float(b)
    spec = 2.0 * n_act * tokens
    extra = 0.0
    for kind in cfg.layer_kinds():
        if kind[0] == "global":
            extra += 4.0 * cfg.n_heads * cfg.d_head * s * tokens
        elif kind[0] == "local":
            extra += 4.0 * cfg.n_heads * cfg.d_head * min(cfg.window, s) * tokens
        elif kind[0] == "ssm":
            di = cfg.ssm_expand * cfg.d_model
            hh = cfg.ssm_heads or di // 64
            extra += 4.0 * cfg.ssm_state * di * tokens
    refined = spec + extra + vp_flops_per_tok * tokens
    return {"spec": spec, "refined": refined, "tokens": tokens}
