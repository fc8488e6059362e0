"""repro_torch's training substrate (``repro_torch.training``) vs the JAX
reference (``repro.training``), on the CPU at the smoke sizes.

The counterpart of ``tests/test_training.py``: the AdamW update, clipping,
the fp32 master copy and the schedule against ``repro``'s functions (and
the reference test's numpy AdamW); the train step against ``repro``'s
``build_train_step`` on the same weights and batches; microbatch
accumulation; remat; the loss falling on Markov data.

Tolerances: the optimizer alone within rtol 1e-6 (the same fp32 formula;
``b ** count`` and fused multiply-adds may round differently); train-step
metrics (loss, ce, grad_norm) within 1e-5 relative at every step, and each
parameter tensor after the steps within 1e-5 of its norm, relative.  The
attention key bias ``b_k`` is left out of that parameter check: adding a
constant to every key's score leaves the softmax unchanged, so its gradient
is 0 in exact arithmetic and rounding noise in both packages, which AdamW
turns into steps of +-lr (its effect on the function is 0; the losses
match).  Remat recomputes the same ops, so its gradients are bit for bit
those without it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_config
from repro.data.pipeline import TokenPipeline as RefPipeline
from repro.models.model import LanguageModel as RefLM
from repro.training import optimizer as ref_opt
from repro.training.step import build_train_step as ref_build
from repro_torch.configs import get_config
from repro_torch.data import TokenPipeline
from repro_torch.models import LanguageModel, params_from_reference
from repro_torch.training import Hyper, adamw_init, adamw_update, build_train_step, lr_schedule
from repro_torch.training.optimizer import global_norm

CPU = torch.device("cpu")
STEP_RTOL = 1e-5


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32), dtype=dtype)


def _ref_hyper(h: Hyper):
    import dataclasses

    return ref_opt.Hyper(**dataclasses.asdict(h))


# --------------------------------------------------------------------------
# AdamW and the schedule
# --------------------------------------------------------------------------
def test_adamw_matches_numpy_reference():
    """The reference test's one-step numpy AdamW."""
    h = Hyper(lr=0.1, warmup_steps=0, total_steps=10**9, b1=0.9, b2=0.99, eps=1e-8,
              weight_decay=0.01, clip_norm=1e9)
    p = {"w": _t([1.0, -2.0, 3.0])}
    g = {"w": _t([0.1, 0.2, -0.3])}
    w0 = p["w"].numpy().copy()
    st = adamw_init(p)
    adamw_update(g, st, p, 0, h)
    m = 0.1 * g["w"].numpy()
    v = 0.01 * g["w"].numpy() ** 2
    mh, vh = m / (1 - 0.9), v / (1 - 0.99)
    ref = w0 - lr_schedule(0, h) * (mh / (np.sqrt(vh) + 1e-8) + 0.01 * w0)
    np.testing.assert_allclose(p["w"].numpy(), ref, rtol=1e-5)
    assert int(st["count"]) == 1


@pytest.mark.parametrize("clip_norm", [1e9, 0.5])
def test_adamw_update_matches_reference(clip_norm):
    """Three updates of a four-tensor tree, weight decay on, clipping off
    and on, through the warmup into the cosine: parameters, moments, count,
    grad_norm and lr against ``repro``'s adamw_update."""
    h = Hyper(lr=0.05, warmup_steps=2, total_steps=6, weight_decay=0.1, clip_norm=clip_norm)
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 5), "b": (7,), "c": (2, 2, 4), "d": ()}
    p_np = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    params = {k: torch.from_numpy(v.copy()) for k, v in p_np.items()}
    rparams = {k: jnp.asarray(v) for k, v in p_np.items()}
    st, rst = adamw_init(params), ref_opt.adamw_init(rparams)
    for step in (0, 1, 3):
        g_np = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        _, _, m = adamw_update({k: torch.from_numpy(v) for k, v in g_np.items()}, st, params,
                               step, h)
        rparams, rst, rm = ref_opt.adamw_update({k: jnp.asarray(v) for k, v in g_np.items()},
                                                rst, rparams, jnp.int32(step), _ref_hyper(h))
        np.testing.assert_allclose(float(m["grad_norm"]), float(rm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(m["lr"], float(rm["lr"]), rtol=2.4e-7, atol=0)
        for k in shapes:
            np.testing.assert_allclose(params[k].numpy(), np.asarray(rparams[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=k)
            for name in ("m", "v"):
                np.testing.assert_allclose(st[name][k].numpy(), np.asarray(rst[name][k]),
                                           rtol=1e-6, atol=1e-12, err_msg=name + k)
        assert int(st["count"]) == int(rst["count"])


def test_clipping_reports_the_norm_before_it():
    h = Hyper(lr=1.0, warmup_steps=0, clip_norm=0.5, weight_decay=0.0)
    p = {"w": torch.zeros((4,))}
    st = adamw_init(p)
    _, _, m = adamw_update({"w": torch.full((4,), 100.0)}, st, p, 0, h)
    assert float(m["grad_norm"]) == pytest.approx(200.0, rel=1e-4)
    # the clipped gradient (norm 0.5) is what entered the moments
    np.testing.assert_allclose(st["m"]["w"].numpy(), 0.1 * 0.25, rtol=1e-6)


def test_master_fp32_matches_reference():
    """bf16 parameters with an fp32 master copy: the update lands on the
    master, the parameters are its bf16 rounding, as in ``repro``."""
    h = Hyper(lr=0.1, warmup_steps=0, weight_decay=0.01, clip_norm=1e9)
    rng = np.random.default_rng(1)
    w = rng.normal(size=(6,)).astype(np.float32)
    p = {"w": torch.from_numpy(w).to(torch.bfloat16)}
    rp = {"w": jnp.asarray(w, jnp.bfloat16)}
    st = adamw_init(p, master_fp32=True)
    rst = ref_opt.adamw_init(rp, master_fp32=True)
    assert st["master"]["w"].dtype == torch.float32
    for step in range(3):
        g = rng.normal(size=(6,)).astype(np.float32)
        adamw_update({"w": torch.from_numpy(g).to(torch.bfloat16)}, st, p, step, h)
        rp, rst, _ = ref_opt.adamw_update({"w": jnp.asarray(g, jnp.bfloat16)}, rst, rp,
                                          jnp.int32(step), _ref_hyper(h))
    assert p["w"].dtype == torch.bfloat16
    np.testing.assert_allclose(st["master"]["w"].numpy(), np.asarray(rst["master"]["w"]),
                               rtol=1e-6)
    np.testing.assert_array_equal(p["w"].float().numpy(), np.asarray(rp["w"], np.float32))
    np.testing.assert_array_equal(p["w"].float().numpy(),
                                  st["master"]["w"].to(torch.bfloat16).float().numpy())


def test_lr_schedule_matches_reference():
    """Both in float32: the warmup exactly, the cosine within an ulp
    (XLA's cos and numpy's round differently)."""
    for h in (Hyper(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1),
              Hyper(lr=3e-3, warmup_steps=5, total_steps=24), Hyper(warmup_steps=0)):
        for t in (0, 1, 4, 5, 9, 10, 11, 55, 99, 100, 150):
            want = float(ref_opt.lr_schedule(jnp.int32(t), _ref_hyper(h)))
            if t < h.warmup_steps:
                assert lr_schedule(t, h) == want, (h, t)
            np.testing.assert_allclose(lr_schedule(t, h), want, rtol=2.4e-7, atol=0)
    h = Hyper(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    assert lr_schedule(0, h) == 0.0 and lr_schedule(5, h) == pytest.approx(0.5)
    assert lr_schedule(100, h) == pytest.approx(0.1, rel=1e-2)


def test_global_norm_sums_in_fp32():
    xs = [torch.full((3,), 2.0, dtype=torch.bfloat16), torch.full((2, 2), 1.0)]
    assert float(global_norm(xs)) == pytest.approx(4.0)
    assert global_norm(xs).dtype == torch.float32


# --------------------------------------------------------------------------
# the train step against repro's
# --------------------------------------------------------------------------
def _pair(arch, **overrides):
    rlm = RefLM(ref_config(arch, smoke=True).replace(dtype="float32", **overrides))
    cfg = get_config(arch, smoke=True).replace(dtype="float32", **overrides)
    params, _ = rlm.init(jax.random.key(0))
    lm = LanguageModel(cfg, device=CPU)
    lm.load_state_dict(params_from_reference(jax.tree.map(np.asarray, params), cfg))
    return rlm, params, lm


def _assert_params_close(lm, ref_params, skip=("b_k",)):
    want = params_from_reference(jax.tree.map(np.asarray, ref_params), lm.cfg)
    for name, p in lm.state_dict().items():
        if name.rsplit(".", 1)[-1] in skip:
            continue
        diff = float((p - want[name]).norm() / max(float(want[name].norm()), 1e-30))
        assert diff <= STEP_RTOL, (name, diff)


@pytest.mark.parametrize("arch,steps", [("qwen15_0_5b", 1), ("qwen15_0_5b", 3),
                                        ("gemma2_27b", 3), ("olmoe_1b_7b", 3)])
def test_train_steps_match_reference(arch, steps):
    """``steps`` steps (warmup then decay) of the port's train step and of
    ``repro``'s jitted one from the same weights on the same batches; the
    port at its configs' remat ("full")."""
    rlm, rparams, lm = _pair(arch)
    assert lm.cfg.remat == "full"
    h = Hyper(lr=1e-2, warmup_steps=2, total_steps=6)
    rstep = jax.jit(ref_build(rlm, _ref_hyper(h)))
    step = build_train_step(lm, h)
    ropt, opt = ref_opt.adamw_init(rparams), adamw_init(dict(lm.named_parameters()))
    pipe = TokenPipeline(lm.cfg.vocab_size, 16, 4, seed=1)
    for t in range(steps):
        b = pipe.global_batch_at(t)
        rparams, ropt, rm = rstep(rparams, ropt, {k: jnp.asarray(v) for k, v in b.items()},
                                  jnp.int32(t))
        m = step(opt, b, t)
        assert set(m) == set(rm)
        for k in m:
            np.testing.assert_allclose(float(m[k]), float(rm[k]), rtol=STEP_RTOL,
                                       atol=1e-12, err_msg=f"step {t} {k}")
    _assert_params_close(lm, rparams)
    assert int(opt["count"]) == int(ropt["count"]) == steps


def test_grad_accum_matches_reference_and_one_batch():
    """ga = 2 (rows j::2) against ``repro``'s ga = 2, and against ga = 1 on
    the same batch (the mean of the microbatch losses, the update equal
    up to fp32 noise, as the reference's test holds it)."""
    rlm, rparams, lm = _pair("qwen15_0_5b")
    b = TokenPipeline(lm.cfg.vocab_size, 16, 8, seed=2).global_batch_at(0)
    h1 = Hyper(lr=1e-3, warmup_steps=0, total_steps=10)
    h2 = Hyper(lr=1e-3, warmup_steps=0, total_steps=10, grad_accum=2)
    rp2, _, rm2 = jax.jit(ref_build(rlm, _ref_hyper(h2)))(
        rparams, ref_opt.adamw_init(rparams), {k: jnp.asarray(v) for k, v in b.items()},
        jnp.int32(0))
    start = {k: v.clone() for k, v in lm.state_dict().items()}
    m2 = build_train_step(lm, h2)(adamw_init(dict(lm.named_parameters())), b, 0)
    for k in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(float(m2[k]), float(rm2[k]), rtol=STEP_RTOL, err_msg=k)
    _assert_params_close(lm, rp2)
    after2 = {k: v.clone() for k, v in lm.state_dict().items()}
    lm.load_state_dict(start)
    m1 = build_train_step(lm, h1)(adamw_init(dict(lm.named_parameters())), b, 0)
    for k, v in lm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), after2[k].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-3)


def test_unroll_accum_is_the_same_loop():
    _, _, lm = _pair("qwen15_0_5b")
    b = TokenPipeline(lm.cfg.vocab_size, 16, 8, seed=3).global_batch_at(0)
    start = {k: v.clone() for k, v in lm.state_dict().items()}
    outs = []
    for unroll in (False, True):
        lm.load_state_dict(start)
        h = Hyper(lr=1e-3, warmup_steps=0, grad_accum=4, unroll_accum=unroll)
        build_train_step(lm, h)(adamw_init(dict(lm.named_parameters())), b, 0)
        outs.append({k: v.clone() for k, v in lm.state_dict().items()})
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]), k


@pytest.mark.parametrize("arch", ["gemma2_27b", "recurrentgemma_9b", "moonshot_v1_16b_a3b"])
def test_remat_gradients_equal_no_remat(arch):
    """"full" and "dots" recompute the same ops: the loss gradients are bit
    for bit those of "none" (gemma2: both softcaps and the in-place score
    ops; recurrentgemma: a 3-layer cycle and a remainder layer outside the
    checkpoint; moonshot: MoE)."""
    _, _, lm = _pair(arch)
    b = TokenPipeline(lm.cfg.vocab_size, 20, 2, seed=4).global_batch_at(0)
    grads = {}
    for remat in ("none", "full", "dots"):
        lm.cfg = lm.cfg.replace(remat=remat)
        loss, _ = lm.loss(b)
        grads[remat] = torch.autograd.grad(loss, list(lm.parameters()))
    for remat in ("full", "dots"):
        for g0, g in zip(grads["none"], grads[remat]):
            assert torch.equal(g0, g), remat


def test_dots_keeps_the_matrix_products():
    """Under "dots" the unbatched products are saved (not recomputed): the
    policy sees aten.mm, and the checkpoint recomputes fewer of them than
    "full" does."""
    from repro_torch.models import transformer

    _, _, lm = _pair("qwen15_0_5b")
    b = TokenPipeline(lm.cfg.vocab_size, 16, 2, seed=5).global_batch_at(0)
    seen = []
    policy = transformer._dots_policy

    def spy(ctx, op, *args, **kwargs):
        out = policy(ctx, op, *args, **kwargs)
        seen.append((op, out))
        return out

    transformer._dots_policy = spy
    try:
        lm.cfg = lm.cfg.replace(remat="dots")
        loss, _ = lm.loss(b)
        torch.autograd.grad(loss, list(lm.parameters()))
    finally:
        transformer._dots_policy = policy
    from torch.utils.checkpoint import CheckpointPolicy

    saved = {op for op, out in seen if out == CheckpointPolicy.MUST_SAVE}
    assert torch.ops.aten.mm.default in saved


def test_loss_falls_on_markov_data():
    """The reference test's run: 30 steps of the bf16 smoke model on the
    seeded Markov pipeline, the last loss 0.2 below the first."""
    cfg = get_config("qwen15_0_5b", smoke=True)
    lm = LanguageModel(cfg, device=CPU)
    step = build_train_step(lm, Hyper(lr=1e-2, warmup_steps=5, total_steps=50))
    opt = adamw_init(dict(lm.named_parameters()))
    pipe = TokenPipeline(cfg.vocab_size, 32, 8, seed=1)
    np.testing.assert_array_equal(pipe.global_batch_at(7)["tokens"],
                                  RefPipeline(cfg.vocab_size, 32, 8, seed=1
                                              ).global_batch_at(7)["tokens"])
    losses = [float(step(opt, pipe.global_batch_at(t), t)["loss"]) for t in range(30)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.2, losses
