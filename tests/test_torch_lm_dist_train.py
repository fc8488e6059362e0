"""repro_torch's sharded train step against repro's
``make_sharded_train_step`` (tp / zero1 / mp_zero1 / fsdp), elastic
restore, and the collectives under autograd, on CPU slots.

One module-scoped subprocess (``tests/torch_lm_dist_ref.py train``, 8
forced host devices) runs three steps of ``repro``'s
``make_sharded_train_step`` on a 2 x 2 mesh in every param_mode (and
zero1 with grad_accum = 2) from seeded weights (noise on the biases and
norm scales), and writes the reference's checkpoint of the tp state after
one step.  The port's ``make_sharded_train_step`` runs the same steps on
``(cpu,) * 4`` slots (Qwen1.5 smoke, fp32 compute, the port at remat
"full", the reference without: the same function).

Tolerances: metrics (loss, ce, grad_norm, lr) within 1e-5 relative at
every step; every parameter within 1e-5 of its max |value| after each
step, the attention key bias ``b_k`` left out as in
``tests/test_torch_training.py`` (its gradient is 0 in exact arithmetic,
rounding noise in both packages, which AdamW turns into steps of +-lr).
mp_zero1 keeps bf16 parameters and gradients, rounded at other points
than the reference's: each step from the reference's state, its fp32
master's update within 1e-2 of the update's norm per tensor, each bf16
parameter its master's rounding, grad_norm within 1e-4
(``test_sharded_train_steps_match_reference`` says why).  A state
restored on the mesh it was saved on continues bit for bit; on another
mesh within the bound above.
"""

import tempfile

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.distributed.mesh import SlotMesh, all_gather, all_sum, reduce_scatter
from repro_torch.models import (
    LanguageModel,
    opt_state_from_reference,
    params_from_reference,
    read_reference_checkpoint,
    shards_from_reference,
)
from repro_torch.training import (
    CheckpointManager,
    Hyper,
    gather_train_state,
    make_sharded_train_step,
    place_train_state,
    sharded_adamw_init,
    train_state_specs,
)
from repro_torch.training.step import slot_state_bytes, spec_slot_bytes

from test_torch_lm_dist import REF, _nest, start_reference, wait_reference

CPU = torch.device("cpu")
RTOL = 1e-5
MP_GNORM_RTOL = 1e-4
MP_UPDATE_RTOL = 1e-2
MODES = ("tp", "zero1", "mp_zero1", "fsdp")


@pytest.fixture(scope="module")
def reference_process(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_dist_train")
    proc, out, log = start_reference(tmp, "train", tmp / "ckpt")
    yield proc, out, log, tmp / "ckpt"
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def ref(reference_process):
    proc, out, log, ckpt = reference_process
    return wait_reference(proc, out, log), str(ckpt)


def _tree(ref, prefix):
    return _nest({k[len(prefix) + 1:]: v for k, v in ref.items() if k.startswith(prefix + "/")})


def _cfg(mode="tp", **over):
    cfg = get_config("qwen15_0_5b", smoke=True).replace(dtype="float32", **over)
    return cfg.replace(param_dtype="bfloat16") if mode == "mp_zero1" else cfg


def _mesh(dp=2, tp=2):
    return SlotMesh((CPU,) * (dp * tp), {"data": dp, "model": tp})


def _setup(params_np, mode, ga=1, mesh=None, comp=None, **over):
    """(step, specs, ShardedLM, opt) for ``mode`` on ``mesh`` (2 x 2)."""
    cfg = _cfg(mode, **over)
    mesh = mesh or _mesh()
    lm = LanguageModel(cfg, tp=mesh.shape["model"], device="meta")
    h = Hyper(grad_accum=ga, **REF.HYPER)
    step, specs = make_sharded_train_step(lm, h, mesh, param_mode=mode, grad_compression=comp)
    slm = shards_from_reference(params_np, cfg, specs["dist"], specs["params"])
    return step, specs, slm, sharded_adamw_init(slm, specs["opt"], error_feedback=bool(comp))


def _assert_close(got: dict, want: dict, what, skip=("b_k",)):
    for name, w in want.items():
        if name.rsplit(".", 1)[-1] in skip:
            continue
        g, w = got[name].double(), w.double()
        diff = float((g - w).abs().max() / max(float(w.abs().max()), 1e-30))
        assert diff <= RTOL, (what, name, diff)


def _ref_params(ref, prefix, cfg):
    return {k: v.float() for k, v in params_from_reference(_tree(ref, prefix), cfg).items()}


# --------------------------------------------------------------------------
# the collectives under autograd (no reference process)
# --------------------------------------------------------------------------
def test_collectives_are_their_transposes_under_autograd():
    """The port's counterparts of the reference's collectives
    (``jax.lax.psum`` in ``repro/models/moe.py:182``, and the all-gathers
    and reduce-scatters GSPMD inserts for ``with_sharding_constraint``):
    all_sum's backward sums the slots' gradients (Megatron's f / g pair),
    all_gather's is a reduce-scatter and reduce_scatter's an all-gather
    (uneven pieces: GSPMD's ceil split), against the same functions
    written as plain sums / concatenations."""
    rng = np.random.default_rng(0)
    devs = [CPU] * 3
    xs = [torch.tensor(rng.normal(size=(5, 7)), requires_grad=True) for _ in range(3)]
    ws = [torch.tensor(rng.normal(size=(5, 7))) for _ in range(3)]
    wg = [torch.tensor(rng.normal(size=(5, 21))) for _ in range(3)]
    wr = [torch.tensor(rng.normal(size=(2 if i < 2 else 1, 7))) for i in range(3)]

    def loss(fn):
        return fn([x * 1.0 for x in xs])

    cases = {
        "all_sum": (lambda p: sum((o * w).sum() for o, w in zip(all_sum(p, devs), ws)),
                    lambda p: sum(((p[0] + p[1] + p[2]) * w).sum() for w in ws)),
        "all_gather": (lambda p: sum((o * w).sum() for o, w in zip(all_gather(p, 1, devs), wg)),
                       lambda p: sum((torch.cat(p, 1) * w).sum() for w in wg)),
        "reduce_scatter": (
            lambda p: sum((o * w).sum() for o, w in zip(reduce_scatter(p, 0, devs), wr)),
            lambda p: sum(((p[0] + p[1] + p[2])[lo:hi] * w).sum()
                          for (lo, hi), w in zip([(0, 2), (2, 4), (4, 5)], wr))),
    }
    for name, (fn, plain) in cases.items():
        got = torch.autograd.grad(loss(fn), xs)
        want = torch.autograd.grad(loss(plain), xs)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12, msg=name)


# --------------------------------------------------------------------------
# the train step against the reference's
# --------------------------------------------------------------------------
@pytest.mark.parametrize("mode,ga", [(m, 1) for m in MODES] + [("zero1", 2)])
def test_sharded_train_steps_match_reference(ref, mode, ga):
    """Three steps of ``make_sharded_train_step`` (``mode``) on 2 x 2 slots
    against ``repro``'s on a 2 x 2 mesh: metrics and parameters after every
    step; each slot's resident bytes equal to what the specs give (zero1 /
    mp_zero1 hold half the moments, fsdp half the parameters), and no two
    slots share a tensor.  mp_zero1 and grad_accum = 2 take each step from
    the reference's state after the step before: mp_zero1's bf16 parameters
    are roundings of the fp32 master (where two masters within 1e-5
    straddle a rounding boundary the next forward sees parameters one bf16
    step apart), and with two microbatches one element of 8192 in a
    ``w_down`` drifts to 1.15e-5 by the second step (AdamW scales a
    near-cancelled moment).  mp_zero1's gradients are bf16 like the
    reference's, rounded at other points: the reference rounds each use's
    gradient to bf16 before adding the uses (the tied embedding's lookup
    and logits), the port sums them in fp32 and rounds once; where the uses
    nearly cancel the two differ by far more than a bf16 step of the sum.
    So mp_zero1's grad_norm is held within 1e-4 and each tensor's master
    update within 1e-2 of the update's norm (measured: 3.3e-3 at worst,
    2.0e-4 over the whole model); its loss, at the reference's state,
    within 1e-5."""
    ref, _ = ref
    case = f"train_{mode}_ga{ga}"
    cfg = _cfg(mode)
    step, specs, slm, opt = _setup(_tree(ref, f"{case}/params0"), mode, ga)
    batches = _tree(ref, "train/batches")
    f32 = cfg.replace(param_dtype="float32")
    for t, b in enumerate(batches):
        if (mode == "mp_zero1" or ga > 1) and t:
            state = _tree(ref, f"{case}/step{t - 1}/opt")
            full = {"params": params_from_reference(_tree(ref, f"{case}/step{t - 1}/params"), cfg),
                    "opt": opt_state_from_reference(state, f32)}
            slm, opt = place_train_state(cfg, specs["dist"], full, specs)
        m = step(slm, opt, b, t)
        want = _tree(ref, f"{case}/step{t}/metrics")
        assert set(m) == set(want)
        for k, v in m.items():
            tol = MP_GNORM_RTOL if (mode == "mp_zero1" and k == "grad_norm") else RTOL
            np.testing.assert_allclose(float(v), float(want[k]), rtol=tol, atol=1e-12,
                                       err_msg=f"{case} step {t} {k}")
        if mode == "mp_zero1":
            master = gather_train_state(slm, opt, specs["opt"])["opt"]["master"]
            want_m = _ref_params(ref, f"{case}/step{t}/opt/master", f32)
            before = _ref_params(ref, f"{case}/step{t - 1}/opt/master", f32) if t else \
                {k: v.float() for k, v in params_from_reference(
                    _tree(ref, f"{case}/params0"), cfg).items()}
            for n, w in want_m.items():
                upd = float((w - before[n]).norm())
                if upd:
                    assert float((master[n] - w).norm()) <= MP_UPDATE_RTOL * upd, (t, n)
            for n, p in slm.state_dict().items():
                assert torch.equal(p, master[n].to(p.dtype)), n
        else:
            _assert_close(slm.state_dict(), _ref_params(ref, f"{case}/step{t}/params", cfg),
                          (case, t))
    dtypes = {n: p.dtype for n, p in slm.params[0].items()}
    held, want = slot_state_bytes(slm, opt), spec_slot_bytes(specs, dtypes, slm.mesh)
    for s in range(slm.mesh.size):
        assert held[s]["params"] == want[s]["params"] and held[s]["opt"] == want[s]["opt"]
        assert step.grad_bytes[s] == want[s]["grads"]
    fp32_full = sum(p.numel() for p in slm.state_dict().values()) * 4
    if mode in ("zero1", "mp_zero1"):   # the moments (and master): half a tp share
        assert want[0]["opt"] < 0.3 * fp32_full * (3 if mode == "mp_zero1" else 2)
    if mode == "fsdp":
        assert want[0]["params"] < 0.3 * fp32_full
    ptrs = [t.data_ptr() for s in range(slm.mesh.size) for t in slm.params[s].values()
            if t.numel()]
    assert len(ptrs) == len(set(ptrs))


def test_grad_accum_two_equals_one(ref):
    """zero1 with grad_accum = 2 against grad_accum = 1 on the same
    batches: ``repro``'s ``build_train_step`` splits microbatches strided
    (rows j::2, ``repro/training/step.py:91-97``), so their mean loss is
    the batch's."""
    ref, _ = ref
    params0 = _tree(ref, "train_zero1_ga1/params0")
    runs = {}
    for ga in (1, 2):
        step, _, slm, opt = _setup(params0, "zero1", ga)
        runs[ga] = [float(step(slm, opt, b, t)["loss"])
                    for t, b in enumerate(_tree(ref, "train/batches"))], slm.state_dict()
    np.testing.assert_allclose(runs[2][0], runs[1][0], rtol=RTOL)
    _assert_close(runs[2][1], runs[1][1], "ga")


def test_compressed_step_tracks_exact(ref):
    """tp with ``grad_compression="ef_int8"``: the data-parallel mean by
    ``ef_int8_allreduce`` (error fed back; the function itself is held bit
    for bit against the reference's in ``tests/test_torch_lm_dist.py``):
    the first loss equal to the exact all-reduce run's, the next ones
    within 1e-2 of it, the error state non-zero; other modes refuse it."""
    ref, _ = ref
    params0 = _tree(ref, "train_tp_ga1/params0")
    losses = {}
    for comp in (None, "ef_int8"):
        step, _, slm, opt = _setup(params0, "tp", comp=comp)
        losses[comp] = [float(step(slm, opt, b, t)["loss"])
                        for t, b in enumerate(_tree(ref, "train/batches"))]
    np.testing.assert_allclose(losses["ef_int8"], losses[None], rtol=1e-2)
    assert losses["ef_int8"][0] == losses[None][0]
    assert any(float(e.abs().max()) > 0 for e in opt[0]["error"].values())
    with pytest.raises(ValueError, match="tp"):
        _setup(params0, "zero1", comp="ef_int8")


# --------------------------------------------------------------------------
# elastic restore
# --------------------------------------------------------------------------
def test_elastic_restore_across_meshes(ref):
    """``repro``'s elastic restart (``CheckpointManager.restore(...,
    shardings=)``, ``repro/training/checkpoint.py:193-223``): fsdp on 2 x 2
    slots, saved after two steps as full arrays, restored on 2 x 2
    continues bit for bit; on 1 x 4 (tp) and on one slot within 1e-5."""
    ref, _ = ref
    batches = _tree(ref, "train/batches") * 2
    cfg = _cfg()
    step, specs, slm, opt = _setup(_tree(ref, "train_fsdp_ga1/params0"), "fsdp")
    for t in range(2):
        step(slm, opt, batches[t], t)
    with tempfile.TemporaryDirectory() as d:
        ck = CheckpointManager(d)
        saved = gather_train_state(slm, opt, specs["opt"])
        ck.save(2, saved, block=True)
        cont = [float(step(slm, opt, batches[t], t)["loss"]) for t in range(2, 5)]
        final = slm.state_dict()
        for shape, mode in (((2, 2), "fsdp"), ((1, 4), "tp"), ((1, 1), "tp")):
            mesh = _mesh(*shape)
            lm = LanguageModel(cfg, tp=shape[1], device="meta")
            step2, sp2 = make_sharded_train_step(lm, Hyper(**REF.HYPER), mesh, param_mode=mode)
            tree, man = ck.restore(saved, shardings=(mesh, train_state_specs(sp2)))
            assert man["step"] == 2
            p2, o2 = place_train_state(cfg, sp2["dist"], tree, sp2)
            got = [float(step2(p2, o2, batches[t], t)["loss"]) for t in range(2, 5)]
            if mode == "fsdp":
                assert got == cont
                assert all(torch.equal(v, final[k]) for k, v in p2.state_dict().items())
            else:
                np.testing.assert_allclose(got, cont, rtol=RTOL)
                _assert_close(p2.state_dict(), final, shape)


def test_reference_checkpoint_of_a_sharded_state_resumes(ref):
    """The reference's checkpoint of its tp = 2 state (2 x 2 mesh, after
    one step) read by ``read_reference_checkpoint``, placed on 1 x 4 slots
    in zero1, one step: the reference's second step's parameters."""
    ref, ckpt = ref
    cfg = _cfg()
    params, opt_full, man = read_reference_checkpoint(ckpt, cfg)
    assert man["extra"]["data_step"] == 1
    mesh = _mesh(1, 4)
    lm = LanguageModel(cfg, tp=4, device="meta")
    step, specs = make_sharded_train_step(lm, Hyper(**REF.HYPER), mesh, param_mode="zero1")
    slm, opt = place_train_state(cfg, specs["dist"], {"params": params, "opt": opt_full}, specs)
    m = step(slm, opt, _tree(ref, "train/batches")[1], 1)
    want = _tree(ref, "train_tp_ga1/step1/metrics")
    np.testing.assert_allclose(float(m["loss"]), float(want["loss"]), rtol=RTOL)
    _assert_close(slm.state_dict(), _ref_params(ref, "train_tp_ga1/step1/params", cfg), "ckpt")
