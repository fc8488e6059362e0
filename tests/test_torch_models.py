"""repro_torch's dense decoder stack (``repro_torch.models``) vs the JAX
reference (``repro.models``), on the CPU at the smoke sizes.

Both packages run the same function: the reference's parameters (drawn by
``LanguageModel.init`` from a seeded key, then seeded noise on every bias
and norm leaf, which it initialises to 0 or 1) are loaded into the port
with ``params_from_reference``, and both get the same seeded numpy tokens.  The
four dense smoke configs cover QKV bias and tied embeddings
(``qwen15_0_5b``), GQA (``qwen2_7b``), LayerNorm with 25 % RoPE
(``stablelm_1_6b``) and local / global layers with both softcaps, sandwich
norms, norm + 1 and the embedding scale (``gemma2_27b``).

Tolerances: with ``dtype="float32"`` logits agree within rtol = atol =
1e-4 (only the order of fp32 sums differs).  In bf16 the two packages
round at different points (XLA fuses chains the port runs op by op), so
each is held against the fp32 function: the port's mean error within
1.25x the reference's own, and every logit within 0.5 of the reference's
bf16 logit (measured, logits of mean magnitude 0.8, gemma2 1.6: mean
errors 0.008-0.010 for both packages, gemma2 0.06-0.10; largest
difference 0.047, gemma2 0.26).  An int8 KV cache within one quantization
level.  The reference's forward, prefill and decode step run jitted, as
its ``KNNLM`` and ``ServeEngine`` run them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_config
from repro.models import attention as ref_attention
from repro.models.layers import softmax_xent as ref_xent
from repro.models.model import LanguageModel as RefLM
from repro.models.transformer import grow_cache as ref_grow
from repro_torch.configs import ARCH_IDS, get_config, registry
from repro_torch.models import LanguageModel, params_from_reference
from repro_torch.models import attention
from repro_torch.models.convert import reference_layers
from repro_torch.models.layers import softmax_xent
from repro_torch.models.transformer import grow_cache

DENSE = ["qwen15_0_5b", "qwen2_7b", "stablelm_1_6b", "gemma2_27b"]
CPU = torch.device("cpu")
F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_ATOL, BF16_ERR_RATIO = 0.5, 1.25
PROMPT = 20       # longer than gemma2's smoke window (16): its rolling cache wraps
MAX_LEN = 32


def _pair(arch, **overrides):
    """(reference lm, reference params, port lm) on the same weights."""
    rcfg = ref_config(arch, smoke=True).replace(**overrides)
    cfg = get_config(arch, smoke=True).replace(**overrides)
    rlm = RefLM(rcfg)
    rlm.jit_forward = jax.jit(rlm.forward)
    rlm.jit_prefill = jax.jit(rlm.prefill)
    rlm.jit_decode = jax.jit(rlm.decode_step)
    params = perturbed(rlm.init(jax.random.key(0))[0])
    lm = LanguageModel(cfg, device=CPU)
    lm.load_state_dict(params_from_reference(jax.tree.map(np.asarray, params), cfg))
    return rlm, params, lm


def perturbed(params, seed=0):
    """The reference's fresh params with seeded noise on every leaf it
    initialises to a constant (QKV biases 0, norm scales 1 or 0, LayerNorm
    biases 0): leaf + 0.1 * N(0, 1), so that a dropped or misplaced bias or
    norm scale changes the function."""
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        if getattr(path[-1], "key", None) in ("b_q", "b_k", "b_v", "scale", "bias"):
            return leaf + jnp.asarray(0.1 * rng.standard_normal(leaf.shape), leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(perturb, params)


_PAIRS = {}


def pair(arch, **overrides):
    key = (arch, tuple(sorted(overrides.items())))
    if key not in _PAIRS:
        _PAIRS[key] = _pair(arch, **overrides)
    return _PAIRS[key]


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float32)


def _assert_bf16_close(out, ref, truth):
    """``out`` (the port's bf16) and ``ref`` (the reference's bf16) against
    ``truth`` (the reference in fp32)."""
    np.testing.assert_allclose(out, ref, rtol=0, atol=BF16_ATOL)
    port_err, ref_err = np.abs(out - truth).mean(), np.abs(ref - truth).mean()
    assert port_err <= BF16_ERR_RATIO * ref_err + 1e-3, (port_err, ref_err)


def _assert_caches(port, ref, cfg, **tol):
    ref_layers = reference_layers(jax.tree.map(np.asarray, ref), cfg)
    assert len(port) == len(ref_layers) == cfg.n_layers
    for c, r in zip(port, ref_layers):
        assert set(c) == set(r)
        for name in c:
            assert tuple(c[name].shape) == r[name].shape, name
            np.testing.assert_allclose(_np(c[name]), np.asarray(r[name], np.float32),
                                       err_msg=name, **tol)


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------
def test_configs_equal_the_reference():
    from repro.configs.base import registry as ref_registry

    ref = ref_registry()
    assert ARCH_IDS == tuple(ref)
    for aid, cfg in registry().items():
        assert cfg.__dict__ == ref[aid].__dict__
        assert get_config(aid, smoke=True).__dict__ == ref_config(aid, smoke=True).__dict__


# --------------------------------------------------------------------------
# forward / prefill / decode against the reference
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", DENSE)
def test_forward_logits_match_reference(arch):
    rlm, params, lm = pair(arch, dtype="float32")
    toks = _tokens(lm.cfg, (2, 24))
    ref, ref_aux = rlm.jit_forward(params, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        out, aux = lm({"tokens": toks})
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(_np(out), np.asarray(ref), **F32_TOL)
    np.testing.assert_array_equal(_np(aux), np.asarray(ref_aux))


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_logits_and_caches_match_reference(arch):
    rlm, params, lm = pair(arch, dtype="float32")
    toks = _tokens(lm.cfg, (2, PROMPT), seed=1)
    ref, ref_caches = rlm.jit_prefill(params, {"tokens": jnp.asarray(toks)})
    out, caches = lm.prefill({"tokens": toks})
    assert tuple(out.shape) == ref.shape == (2, 1, ref.shape[-1])
    np.testing.assert_allclose(_np(out), np.asarray(ref), **F32_TOL)
    _assert_caches(caches, ref_caches, lm.cfg, **F32_TOL)
    # prefill's last logits are forward's last position
    with torch.no_grad():
        full, _ = lm({"tokens": toks})
    np.testing.assert_allclose(_np(out[:, 0]), _np(full[:, -1]), **F32_TOL)


def _decode_chain(rlm, params, lm, steps=6, seed=2):
    """Prefill a prompt in both packages, grow the caches, then decode
    ``steps`` tokens per row with per-slot positions; row 1 is inactive on
    odd steps (its cache must not move).  Returns the per-step logits and
    the final caches of both."""
    cfg = lm.cfg
    toks = _tokens(cfg, (2, PROMPT), seed=seed)
    _, rc = rlm.jit_prefill(params, {"tokens": jnp.asarray(toks)})
    rc = ref_grow(rc, rlm.cfg, MAX_LEN)
    _, pc = lm.prefill({"tokens": toks})
    pc = grow_cache(pc, cfg, MAX_LEN)
    nxt = _tokens(cfg, (steps, 2), seed=seed + 1)
    pos = np.array([PROMPT, PROMPT])
    outs = []
    for t in range(steps):
        active = np.array([True, t % 2 == 0])
        batch = {"tokens": nxt[t][:, None], "pos": pos.astype(np.int32), "active": active}
        rl, rc = rlm.jit_decode(params, {k: jnp.asarray(v) for k, v in batch.items()}, rc)
        pl, pc = lm.decode_step(batch, pc)
        outs.append((_np(pl), np.asarray(rl)))
        pos = pos + active
    return outs, pc, rc


@pytest.mark.parametrize("arch", DENSE)
def test_decode_chain_matches_reference(arch):
    rlm, params, lm = pair(arch, dtype="float32")
    outs, pc, rc = _decode_chain(rlm, params, lm)
    for pl, rl in outs:
        np.testing.assert_allclose(pl, rl, **F32_TOL)
    _assert_caches(pc, rc, lm.cfg, **F32_TOL)


def test_decode_replays_forward():
    """Prompt replay through decode_step from an empty cache gives the
    forward pass's logits at every position (one row inactive)."""
    _, _, lm = pair("gemma2_27b", dtype="float32")
    toks = _tokens(lm.cfg, (2, PROMPT), seed=5)
    with torch.no_grad():
        full, _ = lm({"tokens": toks})
    caches = lm.init_cache(3, MAX_LEN)
    for t in range(PROMPT):
        batch = {"tokens": np.concatenate([toks[:, t], [0]])[:, None],
                 "pos": np.array([t, t, 0]), "active": np.array([True, True, False])}
        lg, caches = lm.decode_step(batch, caches)
        np.testing.assert_allclose(_np(lg[:2, 0]), _np(full[:, t]), **F32_TOL)
    assert all(float(c["k"][2].abs().sum()) == 0 for c in caches)   # row 2 untouched


@pytest.mark.parametrize("arch", DENSE)
def test_bf16_forward_and_decode_close_to_reference(arch):
    """In bf16 the port is as close to the fp32 function as the reference's
    bf16 is: its mean error against the reference in fp32 within 1.25x the
    reference's own (+ 1e-3), and every logit within 0.5 of the reference's
    bf16 logit; forward, then a decode chain."""
    rlm, params, lm = pair(arch)
    r32, p32, l32 = pair(arch, dtype="float32")
    assert lm.cfg.dtype == "bfloat16"
    toks = _tokens(lm.cfg, (2, 24))
    ref, _ = rlm.jit_forward(params, {"tokens": jnp.asarray(toks)})
    truth, _ = r32.jit_forward(p32, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        out, _ = lm({"tokens": toks})
    _assert_bf16_close(_np(out), np.asarray(ref), np.asarray(truth))
    outs, _, _ = _decode_chain(rlm, params, lm, steps=3)
    truths, _, _ = _decode_chain(r32, p32, l32, steps=3)
    for (pl, rl), (_, tl) in zip(outs, truths):
        _assert_bf16_close(pl, rl, tl)


# --------------------------------------------------------------------------
# attention variants
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen2_7b", "gemma2_27b"])
def test_blocked_attention_matches_full_and_reference(arch):
    """Above ``full_attn_threshold`` the online-softmax blocks (8 x 8, with
    gemma2's window skipping blocks) give the full attention's logits, and
    the reference's blocked ones."""
    blocked = dict(dtype="float32", full_attn_threshold=8, attn_q_chunk=8, attn_kv_chunk=8)
    rlm, params, lm = pair(arch, **blocked)
    _, _, full_lm = pair(arch, dtype="float32")
    toks = _tokens(lm.cfg, (2, 36), seed=3)
    with torch.no_grad():
        out, _ = lm({"tokens": toks})
        full, _ = full_lm({"tokens": toks})
    ref, _ = rlm.jit_forward(params, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(_np(out), _np(full), **F32_TOL)
    np.testing.assert_allclose(_np(out), np.asarray(ref), **F32_TOL)


def test_window_wider_than_sequence_equals_global():
    cfg = get_config("qwen2_7b", smoke=True).replace(dtype="float32")
    p = attention.init_attention(cfg, torch.Generator().manual_seed(0), CPU)
    x = torch.randn((2, 32, cfg.d_model), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a = attention.attn_forward(p, x, cfg, layer_window=0, causal=True)
        b = attention.attn_forward(p, x, cfg, layer_window=500, causal=True)
        c = attention.attn_forward(p, x, cfg, layer_window=8, causal=True)
    np.testing.assert_array_equal(_np(a), _np(b))
    assert np.abs(_np(a) - _np(c)).max() > 1e-3     # a real window changes the output


@pytest.mark.parametrize("arch", ["qwen15_0_5b", "gemma2_27b"])
def test_int8_kv_cache_matches_reference(arch):
    """The int8 cache (bf16 per-(token, head) scales): a decode chain from
    an empty cache, logits and cache against the reference's."""
    rlm, params, lm = pair(arch, dtype="float32", kv_cache_dtype="int8")
    cfg = lm.cfg
    rc, _ = rlm.init_cache(2, MAX_LEN)
    pc = lm.init_cache(2, MAX_LEN)
    assert pc[0]["k"].dtype == torch.int8 and pc[0]["k_scale"].dtype == torch.bfloat16
    toks = _tokens(cfg, (PROMPT, 2), seed=4)
    pos = np.array([0, 3])
    for t in range(PROMPT):
        batch = {"tokens": toks[t][:, None], "pos": pos.astype(np.int32),
                 "active": np.array([True, t >= 3])}
        rl, rc = rlm.jit_decode(params, {k: jnp.asarray(v) for k, v in batch.items()}, rc)
        pl, pc = lm.decode_step(batch, pc)
        np.testing.assert_allclose(_np(pl), np.asarray(rl), rtol=0, atol=2e-2)
        pos = pos + np.array([1, t >= 3])
    ref_layers = reference_layers(jax.tree.map(np.asarray, rc), cfg)
    for c, r in zip(pc, ref_layers):
        for name in ("k", "v"):     # within one quantization level
            assert np.abs(c[name].numpy().astype(np.int32)
                          - r[name].astype(np.int32)).max() <= 1
        for name in ("k_scale", "v_scale"):
            np.testing.assert_allclose(_np(c[name]), np.asarray(r[name], np.float32),
                                       rtol=1e-2, atol=0)


@pytest.mark.parametrize("arch", ["qwen15_0_5b", "gemma2_27b"])
def test_grow_cache_matches_reference(arch):
    rlm, params, lm = pair(arch, dtype="float32")
    toks = _tokens(lm.cfg, (1, 10), seed=6)
    _, rc = rlm.jit_prefill(params, {"tokens": jnp.asarray(toks)})
    _, pc = lm.prefill({"tokens": toks})
    for max_len in (10, 12, 40):
        _assert_caches(grow_cache(pc, lm.cfg, max_len), ref_grow(rc, rlm.cfg, max_len),
                       lm.cfg, **F32_TOL)


def test_rolling_cache_slots_match_reference():
    """A local layer's prefill cache past the window keeps the last W
    positions at slots pos % W, as the reference lays them out."""
    cfg = get_config("gemma2_27b", smoke=True).replace(dtype="float32")
    rcfg = ref_config("gemma2_27b", smoke=True).replace(dtype="float32")
    rp, _ = ref_attention.init_attention(rcfg, jax.random.key(0))
    p = attention.init_attention(cfg, torch.Generator().manual_seed(0), CPU)
    with torch.no_grad():
        for name in p._parameters:
            getattr(p, name).copy_(torch.from_numpy(np.array(rp[name])))
    x = np.random.default_rng(7).normal(size=(2, 21, cfg.d_model)).astype(np.float32)
    ry, rc = ref_attention.attn_forward(rp, jnp.asarray(x), rcfg, layer_window=cfg.window,
                                        causal=True, start=3, return_kv=True)
    with torch.no_grad():
        y, c = attention.attn_forward(p, torch.from_numpy(x), cfg, layer_window=cfg.window,
                                      causal=True, start=3, return_kv=True)
    np.testing.assert_allclose(_np(y), np.asarray(ry), **F32_TOL)
    for name in ("k", "v"):
        assert tuple(c[name].shape) == rc[name].shape == (2, cfg.window, cfg.n_kv_heads,
                                                          cfg.d_head)
        np.testing.assert_allclose(_np(c[name]), np.asarray(rc[name]), **F32_TOL)


# --------------------------------------------------------------------------
# loss
# --------------------------------------------------------------------------
def test_softmax_xent_matches_reference():
    rng = np.random.default_rng(8)
    logits = rng.normal(size=(3, 7, 48)).astype(np.float32) * 3
    labels = rng.integers(-1, 40, size=(3, 7)).astype(np.int32)     # -1 masked
    ref = float(ref_xent(jnp.asarray(logits), jnp.asarray(labels), 40))
    out = float(softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels), 40))
    np.testing.assert_allclose(out, ref, rtol=1e-6)
    # every label masked: 0, not a division by zero
    assert float(softmax_xent(torch.from_numpy(logits), torch.full((3, 7), -1), 40)) == 0.0


@pytest.mark.parametrize("arch", ["qwen15_0_5b", "gemma2_27b"])
def test_loss_matches_reference(arch):
    rlm, params, lm = pair(arch, dtype="float32")
    toks = _tokens(lm.cfg, (2, 17), seed=9)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    ref, ref_metrics = rlm.loss(params, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        out, metrics = lm.loss(batch)
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-5)
    assert set(metrics) == set(ref_metrics)


# --------------------------------------------------------------------------
# devices and init
# --------------------------------------------------------------------------
def test_default_device_is_the_card():
    """No device: cuda:0, and a clear error where no card is visible."""
    cfg = get_config("qwen15_0_5b", smoke=True)
    if torch.cuda.is_available():
        assert LanguageModel(cfg).device == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LanguageModel(cfg)


def test_init_is_seeded_and_scaled():
    cfg = get_config("qwen15_0_5b", smoke=True)
    a = LanguageModel(cfg, device=CPU, generator=torch.Generator().manual_seed(3))
    b = LanguageModel(cfg, device=CPU, generator=torch.Generator().manual_seed(3))
    for (na, ta), (nb, tb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert na == nb and torch.equal(ta, tb)
    w = a.blocks[0].mlp.w_down.detach()                    # [d_ff, d]: fan_in d_ff
    assert abs(float(w.std()) * np.sqrt(cfg.d_ff) - 1) < 0.05
    assert a.blocks[0].mixer.b_q.abs().sum() == 0          # QKV bias starts at 0
    assert set(a.state_dict()) == set(params_from_reference(
        jax.tree.map(np.asarray, RefLM(ref_config("qwen15_0_5b", smoke=True)).init(
            jax.random.key(0))[0]), cfg))
