"""repro_torch's MoE, SSM, RG-LRU and frontend families vs the JAX
reference (``repro.models``), on the CPU at the smoke sizes.

The six configs the dense suite (``tests/test_torch_models.py``) does not
run: ``olmoe_1b_7b`` and ``moonshot_v1_16b_a3b`` (MoE: routing, capacity
drops, renormalised gates, a shared expert), ``mamba2_370m`` (SSD),
``recurrentgemma_9b`` (RG-LRU + local attention, 4 = 1 * 3 + 1 layers: a
remainder layer), ``llava_next_mistral_7b`` (a vision prefix) and
``hubert_xlarge`` (audio frames, encoder only).  Both packages run the same
function: the reference's parameters (with seeded noise on every leaf it
initialises to a constant) are loaded into the port with
``params_from_reference``, and both get the same seeded numpy inputs.

Tolerances, fp32 (``dtype="float32"``): logits and caches within rtol =
atol = 1e-4 (the order of fp32 sums differs; the SSM's cross-chunk
recurrence and the RG-LRU's scan associate differently from the
reference's ``associative_scan``); loss gradients within 1e-4 of each
tensor's largest gradient (measured: at most 3e-6 of it); MoE routing
(top-k ids, drops) equal, the load-balance loss within 1e-6 relative, the
z-loss (rounding noise about 0) within 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_config
from repro.models import moe as ref_moe
from repro.models.model import LanguageModel as RefLM
from repro.models.transformer import grow_cache as ref_grow
from repro.serving.engine import Request as RefRequest
from repro.serving.engine import ServeEngine as RefEngine
from repro_torch.configs import get_config
from repro_torch.models import LanguageModel, moe, params_from_reference
from repro_torch.models.convert import reference_layers
from repro_torch.models.rglru import linear_scan
from repro_torch.models.transformer import grow_cache
from repro_torch.serving import Request, ServeEngine

FAMILIES = ["olmoe_1b_7b", "moonshot_v1_16b_a3b", "mamba2_370m", "recurrentgemma_9b",
            "llava_next_mistral_7b", "hubert_xlarge"]
DECODERS = [a for a in FAMILIES if a != "hubert_xlarge"]
CPU = torch.device("cpu")
F32_TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 2, 20          # 20 tokens: two SSM chunks of 16 after 12 pad rows; past
PROMPT = 20           # RecurrentGemma's smoke window (16), so its cache wraps
MAX_LEN = 40
_CONST_LEAVES = ("b_q", "b_k", "b_v", "scale", "bias", "dt_bias", "A_log", "D_skip",
                 "conv_b", "norm_scale", "b_a", "b_x", "tile_pos")


def _perturbed(params, seed=0):
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        if getattr(path[-1], "key", None) in _CONST_LEAVES:
            return leaf + jnp.asarray(0.1 * rng.standard_normal(leaf.shape), leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(perturb, params)


_PAIRS = {}


def pair(arch):
    """(reference lm with jitted entry points, its params, port lm), fp32."""
    if arch not in _PAIRS:
        rlm = RefLM(ref_config(arch, smoke=True).replace(dtype="float32"))
        cfg = get_config(arch, smoke=True).replace(dtype="float32")
        params = _perturbed(rlm.init(jax.random.key(0))[0])
        rlm.jit_forward = jax.jit(rlm.forward)
        rlm.jit_grad = jax.jit(jax.grad(lambda p, b: rlm.loss(p, b)[0]))
        rlm.jit_prefill = jax.jit(rlm.prefill)
        rlm.jit_decode = jax.jit(rlm.decode_step)
        lm = LanguageModel(cfg, device=CPU)
        lm.load_state_dict(params_from_reference(jax.tree.map(np.asarray, params), cfg))
        _PAIRS[arch] = rlm, params, lm
    return _PAIRS[arch]


def _batch(cfg, seed=0, s=S, labels=True):
    rng = np.random.default_rng(seed)
    b = {}
    if cfg.frontend != "audio":
        b["tokens"] = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    if cfg.frontend == "vision":
        b["frontend_feats"] = rng.normal(size=(B, cfg.frontend_tokens, cfg.frontend_dim)
                                         ).astype(np.float32)
    if cfg.frontend == "audio":
        b["frontend_feats"] = rng.normal(size=(B, s, cfg.frontend_dim)).astype(np.float32)
    if labels:
        b["labels"] = rng.integers(-1, cfg.vocab_size, (B, s)).astype(np.int32)
    return b


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float32)


def _assert_states(port, ref, cfg, **tol):
    ref_layers = reference_layers(jax.tree.map(np.asarray, ref), cfg)
    assert len(port) == len(ref_layers) == cfg.n_layers
    for c, r in zip(port, ref_layers):
        assert set(c) == set(r)
        for name in c:
            assert tuple(c[name].shape) == r[name].shape, name
            np.testing.assert_allclose(_np(c[name]), np.asarray(r[name], np.float32),
                                       err_msg=name, **tol)


# --------------------------------------------------------------------------
# forward, loss, gradients
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_logits_and_aux_match_reference(arch):
    rlm, params, lm = pair(arch)
    batch = _batch(lm.cfg, labels=False)
    ref, ref_aux = rlm.jit_forward(params, _jnp(batch))
    with torch.no_grad():
        out, aux = lm(batch)
    s_total = S + (lm.cfg.frontend_tokens if lm.cfg.frontend == "vision" else 0)
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    assert out.shape[1] == s_total
    np.testing.assert_allclose(_np(out), np.asarray(ref), **F32_TOL)
    ref_aux = np.asarray(ref_aux)
    np.testing.assert_allclose(_np(aux)[0], ref_aux[0], rtol=1e-6)     # load balance
    np.testing.assert_allclose(_np(aux)[1], ref_aux[1], rtol=0, atol=1e-12)   # z-loss
    assert _np(aux)[2] == ref_aux[2]                                    # drop fraction


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_metrics_and_gradients_match_reference(arch):
    """lm.loss (CE over the labels, -1 masked and over the vision prefix,
    plus the MoE terms) and its gradient for every parameter."""
    rlm, params, lm = pair(arch)
    batch = _batch(lm.cfg, seed=1)
    ref, ref_metrics = rlm.loss(params, _jnp(batch))
    ref_grads = params_from_reference(jax.tree.map(np.asarray, rlm.jit_grad(
        params, _jnp(batch))), lm.cfg)
    loss, metrics = lm.loss(batch)
    assert set(metrics) == set(ref_metrics)
    for k in metrics:
        np.testing.assert_allclose(_np(metrics[k]), np.asarray(ref_metrics[k]), rtol=1e-5,
                                   atol=1e-12, err_msg=k)
    names = [n for n, _ in lm.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in lm.named_parameters()],
                                allow_unused=True)   # hubert's token embedding: unused
    assert set(names) == set(ref_grads)
    for name, g in zip(names, grads):
        g = torch.zeros(ref_grads[name].shape) if g is None else g
        r = ref_grads[name].numpy()
        np.testing.assert_allclose(_np(g), r, rtol=0, atol=1e-4 * np.abs(r).max() + 1e-30,
                                   err_msg=name)


def test_vision_prefix_carries_no_loss():
    """The image prefix's logits never reach the loss: changing the labels'
    image positions is impossible (they are prepended as -1), and the loss
    equals the CE over the text positions of the forward's logits."""
    _, _, lm = pair("llava_next_mistral_7b")
    from repro_torch.models.layers import softmax_xent

    batch = _batch(lm.cfg, seed=2)
    with torch.no_grad():
        logits, _ = lm(batch)
        loss, _ = lm.loss(batch)
    text = logits[:, lm.cfg.frontend_tokens:]
    expect = softmax_xent(text, torch.as_tensor(batch["labels"]).long(), lm.cfg.vocab_size)
    np.testing.assert_allclose(float(loss), float(expect), rtol=1e-6)


# --------------------------------------------------------------------------
# prefill and decode
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_logits_and_states_match_reference(arch):
    rlm, params, lm = pair(arch)
    batch = _batch(lm.cfg, seed=3, labels=False)
    ref, ref_caches = rlm.jit_prefill(params, _jnp(batch))
    out, caches = lm.prefill(batch)
    np.testing.assert_allclose(_np(out), np.asarray(ref), **F32_TOL)
    _assert_states(caches, ref_caches, lm.cfg, **F32_TOL)
    with torch.no_grad():
        full, _ = lm(batch)
    np.testing.assert_allclose(_np(out[:, 0]), _np(full[:, -1]), **F32_TOL)


def _decode_chain(rlm, params, lm, steps=6, seed=4):
    """Prefill a prompt in both packages, grow the caches, then decode
    ``steps`` tokens per row at per-slot positions; row 1 is inactive on
    odd steps (its state must not move)."""
    cfg = lm.cfg
    batch = _batch(cfg, seed=seed, s=PROMPT, labels=False)
    _, rc = rlm.jit_prefill(params, _jnp(batch))
    rc = ref_grow(rc, rlm.cfg, MAX_LEN)
    _, pc = lm.prefill(batch)
    pc = grow_cache(pc, cfg, MAX_LEN)
    nxt = np.random.default_rng(seed + 1).integers(0, cfg.vocab_size, (steps, B))
    start = PROMPT + (cfg.frontend_tokens if cfg.frontend == "vision" else 0)
    pos = np.array([start, start])
    outs = []
    for t in range(steps):
        active = np.array([True, t % 2 == 0])
        step = {"tokens": nxt[t][:, None].astype(np.int32), "pos": pos.astype(np.int32),
                "active": active}
        rl, rc = rlm.jit_decode(params, _jnp(step), rc)
        pl, pc = lm.decode_step(step, pc)
        outs.append((_np(pl), np.asarray(rl)))
        pos = pos + active
    return outs, pc, rc


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_chain_matches_reference(arch):
    rlm, params, lm = pair(arch)
    outs, pc, rc = _decode_chain(rlm, params, lm)
    for pl, rl in outs:
        np.testing.assert_allclose(pl, rl, **F32_TOL)
    _assert_states(pc, rc, lm.cfg, **F32_TOL)


@pytest.mark.parametrize("arch", ["mamba2_370m", "recurrentgemma_9b"])
def test_decode_replays_forward(arch):
    """A prompt replayed through decode_step from an empty state gives the
    forward pass's logits at every position (one row inactive: its state
    stays zero).  Not for MoE: its capacity, so its drops, depend on the
    number of tokens routed together, as in the reference."""
    _, _, lm = pair(arch)
    toks = _batch(lm.cfg, seed=5, labels=False)["tokens"]
    with torch.no_grad():
        full, _ = lm({"tokens": toks})
    caches = lm.init_cache(3, MAX_LEN)
    for t in range(toks.shape[1]):
        step = {"tokens": np.concatenate([toks[:, t], [0]])[:, None],
                "pos": np.array([t, t, 0]), "active": np.array([True, True, False])}
        lg, caches = lm.decode_step(step, caches)
        np.testing.assert_allclose(_np(lg[:2, 0]), _np(full[:, t]), **F32_TOL)
    assert all(float(t[2].abs().sum()) == 0 for c in caches for t in c.values())


def test_encoder_only_has_no_decode():
    _, _, lm = pair("hubert_xlarge")
    with pytest.raises(ValueError, match="encoder-only"):
        lm.decode_step({"tokens": np.zeros((1, 1)), "pos": np.array(0)}, [])
    with pytest.raises(ValueError, match="encoder-only"):
        ServeEngine(lm, slots=1, max_len=8)


@pytest.mark.parametrize("arch", ["mamba2_370m", "recurrentgemma_9b", "moonshot_v1_16b_a3b"])
def test_serve_engine_tokens_match_the_references_engine(arch):
    """Both packages' ServeEngine on the same weights and requests (two
    slots, three requests of different lengths): the same greedy tokens."""
    rlm, params, lm = pair(arch)
    cfg = lm.cfg
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (5, 3, 7)]
    eng = ServeEngine(lm, slots=2, max_len=MAX_LEN)
    ref = RefEngine(rlm, params, slots=2, max_len=MAX_LEN)
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=p, max_new_tokens=6))
        ref.submit(RefRequest(rid=rid, prompt=p, max_new_tokens=6))
    out, ref_out = eng.run(), ref.run()
    assert {r: q.out_tokens for r, q in out.items()} == {
        r: list(map(int, q.out_tokens)) for r, q in ref_out.items()}


# --------------------------------------------------------------------------
# pieces
# --------------------------------------------------------------------------
def test_linear_scan_matches_the_recurrence():
    """The Hillis-Steele scan against h_t = a_t h_{t-1} + b_t step by step
    at lengths around powers of two."""
    gen = torch.Generator().manual_seed(0)
    for t_len in (1, 2, 3, 16, 17, 100):
        a = torch.rand((2, t_len, 5), generator=gen, dtype=torch.float64)
        b = torch.randn((2, t_len, 5), generator=gen, dtype=torch.float64)
        h, want = torch.zeros((2, 5), dtype=torch.float64), []
        for t in range(t_len):
            h = a[:, t] * h + b[:, t]
            want.append(h)
        np.testing.assert_allclose(linear_scan(a, b).numpy(), torch.stack(want, 1).numpy(),
                                   rtol=1e-12, atol=1e-12)


def test_moe_routing_ties_capacity_and_drops_match_reference():
    """Equal router probabilities go to the lower expert first (the
    reference's top_k); the capacity and the dropped assignments equal the
    reference's when far more tokens pick one expert than it holds."""
    cfg = get_config("olmoe_1b_7b", smoke=True).replace(dtype="float32")
    rcfg = ref_config("olmoe_1b_7b", smoke=True).replace(dtype="float32")
    for t in (1, 7, 64, 1000):
        assert moe._capacity(t, cfg) == ref_moe._capacity(t, rcfg)
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25, 0, 0, 0, 0],
                          [0, 0, 0.5, 0, 0.5, 0, 0, 0]])
    v, i = moe._top_k(probs, 2)
    rv, ri = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))

    rp, _ = ref_moe.init_moe(rcfg, jax.random.key(1))
    p = moe.init_moe(cfg, torch.Generator().manual_seed(0), CPU)
    with torch.no_grad():
        for name in p._parameters:
            getattr(p, name).copy_(torch.from_numpy(np.array(rp[name])))
        # every token's router logits favour expert 3: capacity drops
        p.router[:, 3] += 5.0
    x = np.abs(np.random.default_rng(7).normal(size=(2, 24, cfg.d_model))).astype(np.float32)
    rp = dict(rp, router=jnp.asarray(p.router.detach().numpy()))
    ry, raux = jax.jit(ref_moe.moe_mlp, static_argnums=2)(rp, jnp.asarray(x), rcfg)
    with torch.no_grad():
        y, aux = moe.moe_mlp(p, torch.from_numpy(x), cfg)
    assert float(aux.drop_frac) == float(raux.drop_frac) > 0.2
    np.testing.assert_allclose(_np(y), np.asarray(ry), **F32_TOL)
    np.testing.assert_allclose(float(aux.load_balance), float(raux.load_balance), rtol=1e-6)


def test_ssm_gradients_stay_finite_where_the_decay_overflows():
    """At full width a chunk of 128 steps of log-decay about -0.7 each puts
    exp(cla_i - cla_j) above the float32 range for j > i.  The reference
    masks those entries after the exp, so its forward is finite but its
    backward takes 0 * inf = NaN (a divergence in the reference itself);
    the port masks before the exp: the same logits, finite gradients."""
    from repro.models import ssm as ref_ssm
    from repro_torch.models import ssm

    cfg = get_config("mamba2_370m", smoke=True).replace(dtype="float32", ssm_chunk=128)
    rcfg = ref_config("mamba2_370m", smoke=True).replace(dtype="float32", ssm_chunk=128)
    rp, _ = ref_ssm.init_ssm(rcfg, jax.random.key(0))
    rp = dict(rp, dt_bias=jnp.full(rp["dt_bias"].shape, 3.0))   # dt ~ 3: overflows by 30
    p = ssm.init_ssm(cfg, torch.Generator().manual_seed(0), CPU)
    with torch.no_grad():
        for name in p._parameters:
            getattr(p, name).copy_(torch.from_numpy(np.array(rp[name])))
    x = np.random.default_rng(10).normal(size=(1, 128, cfg.d_model)).astype(np.float32)
    ry = ref_ssm.ssm_forward(rp, jnp.asarray(x), rcfg)
    ref_grad = jax.grad(lambda q: ref_ssm.ssm_forward(q, jnp.asarray(x), rcfg).sum())(rp)
    assert np.isnan(np.asarray(ref_grad["w_dt"])).any()          # the reference's NaN
    y = ssm.ssm_forward(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(_np(y), np.asarray(ry), **F32_TOL)
    grads = torch.autograd.grad(y.sum(), list(p.parameters()))
    assert all(torch.isfinite(g).all() for g in grads)


def test_recurrent_states_keep_their_size_when_grown():
    """grow_cache pads the attention caches only; RG-LRU and SSM states
    pass through unchanged (the reference's rule)."""
    for arch in ("recurrentgemma_9b", "mamba2_370m"):
        rlm, params, lm = pair(arch)
        batch = _batch(lm.cfg, seed=8, s=10, labels=False)
        _, rc = rlm.jit_prefill(params, _jnp(batch))
        _, pc = lm.prefill(batch)
        grown = grow_cache(pc, lm.cfg, MAX_LEN)
        _assert_states(grown, ref_grow(rc, rlm.cfg, MAX_LEN), lm.cfg, **F32_TOL)
        for (mixer, _), a, b in zip(lm.cfg.layer_kinds(), pc, grown):
            if mixer in ("rglru", "ssm"):
                assert all(a[k] is b[k] for k in a)


def test_bf16_forward_is_close_to_the_fp32_function():
    """In bf16 (the configs' compute dtype) the MoE and SSM logits stay
    within 0.5 of the fp32 function, as the dense suite holds the dense
    configs, and on average no farther than the reference's bf16 logits
    (x 1.25)."""
    for arch in ("olmoe_1b_7b", "mamba2_370m"):
        rlm32, params, lm32 = pair(arch)
        cfg = get_config(arch, smoke=True)
        lm = LanguageModel(cfg, device=CPU)
        lm.load_state_dict(lm32.state_dict())
        batch = _batch(cfg, seed=9, labels=False)
        with torch.no_grad():
            out, _ = lm(batch)
            truth, _ = lm32(batch)
        rref, _ = jax.jit(RefLM(ref_config(arch, smoke=True)).forward)(params, _jnp(batch))
        port_err = np.abs(_np(out) - _np(truth))
        ref_err = np.abs(np.asarray(rref, np.float32) - _np(truth))
        assert port_err.max() <= 0.5, (arch, port_err.max())
        assert port_err.mean() <= 1.25 * ref_err.mean() + 1e-3, (arch, port_err.mean(),
                                                                  ref_err.mean())
