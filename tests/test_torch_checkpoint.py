"""repro_torch's CheckpointManager, resume and the reference's checkpoints,
on the CPU.

The counterpart of ``tests/test_checkpoint_data.py``'s checkpoint half:
the round trip (bf16 kept as its uint16 bits), GC, the torn write (the
``checkpoint.write`` fault between the arrays and the manifest), the
missing-leaf and shape errors, restoring onto another device, an async
write's error raised at ``wait()``, and bit-identical resume.  Then across
the packages: a checkpoint ``repro`` wrote (its params, AdamW state and
data step) read by ``models/convert.py::read_reference_checkpoint`` and
resumed in the port, whose next step matches ``repro``'s next step (the
train-step tolerances of ``tests/test_torch_training.py``); the launcher's
auto-resume; the two examples.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_config
from repro.models.model import LanguageModel as RefLM
from repro.training import optimizer as ref_opt
from repro.training.checkpoint import CheckpointManager as RefManager
from repro.training.step import build_train_step as ref_build
from repro_torch import faults
from repro_torch.configs import get_config
from repro_torch.data import TokenPipeline
from repro_torch.models import LanguageModel, params_from_reference, read_reference_checkpoint
from repro_torch.training import CheckpointManager, Hyper, adamw_init, build_train_step

CPU = torch.device("cpu")
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _state():
    return {"a": torch.arange(5.0), "b": {"c": torch.ones((2, 3), dtype=torch.bfloat16) / 3},
            "n": torch.tensor(7, dtype=torch.int32)}


def test_roundtrip_keeps_dtypes_and_bits(tmp_path):
    ck = CheckpointManager(str(tmp_path), keep=2)
    state = _state()
    ck.save(7, state, extra={"data_step": 7}, block=True)
    got, man = ck.restore(state)
    assert man["step"] == 7 and man["extra"]["data_step"] == 7
    assert man["dtypes"]["b/c"] == "bfloat16"
    assert got["b"]["c"].dtype == torch.bfloat16 and got["n"].shape == ()
    for key in ("a", "n"):
        assert torch.equal(got[key], state[key])
    assert torch.equal(got["b"]["c"].view(torch.int16), state["b"]["c"].view(torch.int16))
    with np.load(os.path.join(tmp_path, "step_0000000007", "arrays.npz")) as z:
        assert z["b/c"].dtype == np.uint16


def test_save_copies_before_the_state_moves(tmp_path):
    """The async save snapshots at ``save``: an in-place update right after
    (the train step's) does not reach the checkpoint."""
    ck = CheckpointManager(str(tmp_path))
    state = {"w": torch.zeros(1000)}
    ck.save(1, state)
    state["w"] += 1
    got, _ = ck.restore({"w": torch.empty(1000)})
    assert float(got["w"].abs().sum()) == 0


def test_no_tmp_left_and_gc(tmp_path):
    ck = CheckpointManager(str(tmp_path), keep=2, keep_every=10)
    for s in (1, 2, 10, 11, 12):
        ck.save(s, {"x": torch.tensor(float(s))}, block=True)
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    assert ck.all_steps() == [10, 11, 12]   # the 2 newest + every 10th
    assert ck.nbytes() > 0


def test_torn_write_never_yields_a_complete_checkpoint(tmp_path):
    """A crash after the arrays and before the manifest leaves no
    restorable step; the previous checkpoint stays the newest and the next
    save clears the debris."""
    ck = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    ck.save(1, {"x": torch.tensor(1.0)}, block=True)
    faults.arm("checkpoint.write")
    try:
        with pytest.raises(faults.SimulatedCrash):
            ck.save(2, {"x": torch.tensor(2.0)}, block=True)
    finally:
        faults.reset()
    assert ck.all_steps() == [1] and ck.latest_step() == 1
    got, man = ck.restore({"x": torch.zeros(())})
    assert man["step"] == 1 and float(got["x"]) == 1.0
    assert any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    ck2 = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    ck2.save(3, {"x": torch.tensor(3.0)}, block=True)
    assert ck2.all_steps() == [1, 3]
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_async_write_error_is_raised_at_wait(tmp_path):
    ck = CheckpointManager(str(tmp_path))
    faults.arm("checkpoint.write")
    try:
        ck.save(4, {"x": torch.tensor(4.0)})      # returns; the thread fails
        with pytest.raises(faults.SimulatedCrash):
            ck.wait()
    finally:
        faults.reset()
    ck.wait()                                      # raised once
    assert ck.all_steps() == []


def test_restore_errors(tmp_path):
    ck = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        ck.restore({"x": torch.zeros(1)})
    ck.save(0, {"x": torch.zeros(3)}, block=True)
    with pytest.raises(ValueError, match="shape"):
        ck.restore({"x": torch.zeros(4)})
    with pytest.raises(KeyError, match="missing leaf 'y'"):
        ck.restore({"x": torch.zeros(3), "y": torch.zeros(3)})


def test_restore_onto_another_device(tmp_path):
    """Arrays are stored whole, so they restore onto any device: where the
    template lives by default, or ``device``."""
    ck = CheckpointManager(str(tmp_path))
    ck.save(0, {"x": torch.arange(8.0)}, block=True)
    got, _ = ck.restore({"x": torch.zeros(8, device="meta")})
    assert got["x"].device.type == "meta"
    got, _ = ck.restore({"x": torch.zeros(8, device="meta")}, device=CPU)
    assert got["x"].device == CPU and torch.equal(got["x"], torch.arange(8.0))


def _cfg():
    return get_config("qwen15_0_5b", smoke=True).replace(dtype="float32")


def _run(lm, opt, step, pipe, t0, t1):
    for t in range(t0, t1):
        m = step(opt, pipe.global_batch_at(t), t)
    return m


def test_resume_is_bit_identical(tmp_path):
    """Interrupted at step 3, saved, restored into a fresh model and
    optimizer: steps 3-5 give the uninterrupted run's parameters and
    moments bit for bit."""
    h = Hyper(lr=1e-3, warmup_steps=1, total_steps=10)
    pipe = TokenPipeline(_cfg().vocab_size, 16, 4, seed=5)
    lm = LanguageModel(_cfg(), device=CPU)
    start = {k: v.clone() for k, v in lm.state_dict().items()}
    want_opt = adamw_init(dict(lm.named_parameters()))
    _run(lm, want_opt, build_train_step(lm, h), pipe, 0, 6)
    want = {k: v.clone() for k, v in lm.state_dict().items()}

    lm.load_state_dict(start)
    opt = adamw_init(dict(lm.named_parameters()))
    _run(lm, opt, build_train_step(lm, h), pipe, 0, 3)
    ck = CheckpointManager(str(tmp_path))
    ck.save(3, {"params": lm.state_dict(), "opt": opt}, extra={"data_step": 3}, block=True)
    fresh = LanguageModel(_cfg(), device=CPU, generator=torch.Generator().manual_seed(9))
    fresh_opt = adamw_init(dict(fresh.named_parameters()))
    got, man = ck.restore({"params": fresh.state_dict(), "opt": fresh_opt})
    fresh.load_state_dict(got["params"])
    _run(fresh, got["opt"], build_train_step(fresh, h), pipe, man["extra"]["data_step"], 6)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, want[k]), k
        for name in ("m", "v"):
            assert torch.equal(got["opt"][name][k], want_opt[name][k]), (name, k)
    assert int(got["opt"]["count"]) == 6


@pytest.mark.parametrize("mixed", [False, True])
def test_reference_checkpoint_resumes_in_the_port(tmp_path, mixed):
    """``repro`` trains 3 steps and saves with its CheckpointManager; the
    port reads the directory (params, m, v, count and, in mixed precision,
    bf16 params with an fp32 master) and its step 3 matches ``repro``'s
    step 3 from the same checkpoint."""
    over = dict(dtype="float32", param_dtype="bfloat16" if mixed else "float32")
    rlm = RefLM(ref_config("qwen15_0_5b", smoke=True).replace(**over))
    cfg = get_config("qwen15_0_5b", smoke=True).replace(**over)
    h = Hyper(lr=1e-2, warmup_steps=2, total_steps=8)
    rh = ref_opt.Hyper(lr=1e-2, warmup_steps=2, total_steps=8)
    rstep = jax.jit(ref_build(rlm, rh))
    pipe = TokenPipeline(cfg.vocab_size, 16, 4, seed=6)
    jb = lambda t: {k: jnp.asarray(v) for k, v in pipe.global_batch_at(t).items()}  # noqa: E731
    rparams, _ = rlm.init(jax.random.key(0))
    ropt = ref_opt.adamw_init(rparams, master_fp32=mixed)
    for t in range(3):
        rparams, ropt, _ = rstep(rparams, ropt, jb(t), jnp.int32(t))
    RefManager(str(tmp_path)).save(3, {"params": rparams, "opt": ropt},
                                   extra={"data_step": 3}, block=True)

    params, opt, man = read_reference_checkpoint(str(tmp_path), cfg, device=CPU)
    assert man["extra"]["data_step"] == 3 and int(opt["count"]) == 3
    assert ("master" in opt) == mixed
    lm = LanguageModel(cfg, device=CPU)
    lm.load_state_dict(params)
    want = params_from_reference(jax.tree.map(np.asarray, rparams), cfg)
    for k, v in lm.state_dict().items():            # read bit for bit
        assert v.dtype == want[k].dtype and torch.equal(v, want[k]), k

    m = build_train_step(lm, h)(opt, pipe.global_batch_at(3), 3)
    rparams, ropt, rm = rstep(rparams, ropt, jb(3), jnp.int32(3))
    for k in ("loss", "ce", "grad_norm", "lr"):   # mixed: bf16 gradients round apart
        np.testing.assert_allclose(float(m[k]), float(rm[k]), rtol=1e-3 if mixed else 1e-5,
                                   err_msg=k)
    want = params_from_reference(jax.tree.map(np.asarray, rparams), cfg)
    for k, v in lm.state_dict().items():
        if k.endswith("b_k"):      # a zero gradient in exact arithmetic: see test_torch_training
            continue
        diff = float((v.float() - want[k].float()).norm() / want[k].float().norm())
        assert diff <= (4e-3 if mixed else 1e-5), (k, diff)   # mixed: bf16 roundings


def test_launcher_auto_resumes(tmp_path, capsys):
    """``python -m repro_torch.launch.train --device cpu``: a run to step 4
    checkpoints at 2 and 4; a second run to 6 resumes at 4, and a third to
    6 resumes at 6 and runs nothing."""
    from repro_torch.launch import train

    args = ["--arch", "qwen15_0_5b", "--smoke", "--ckpt-dir", str(tmp_path), "--ckpt-every",
            "2", "--device", "cpu", "--seq", "16", "--batch", "4", "--log-every", "1"]
    train.main(args + ["--steps", "4"])
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 4]
    capsys.readouterr()
    train.main(args + ["--steps", "6"])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "step     4" in out and "step     3" not in out
    train.main(args + ["--steps", "6"])
    out = capsys.readouterr().out
    assert "resumed from step 6" in out and "step     5" not in out
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 4, 6]


def test_examples_run_on_the_cpu(tmp_path):
    """Both examples as a user runs them (``python -m``), on the CPU: the
    training example checkpoints and resumes; the kNN-LM example moves
    probability mass onto the true successors."""
    env = dict(os.environ, PYTHONPATH=SRC)
    base = [sys.executable, "-m", "repro_torch.examples.train_lm", "--device", "cpu",
            "--ckpt", str(tmp_path / "ck")]
    out = subprocess.run(base + ["--steps", "2"], env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    out = subprocess.run(base + ["--steps", "3"], env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and "resumed from checkpoint at step 2" in out.stdout, out
    out = subprocess.run([sys.executable, "-m", "repro_torch.examples.knnlm_serve",
                          "--device", "cpu"], env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    line = [x for x in out.stdout.splitlines() if x.startswith("P(true successor set)")][0]
    lm_alone, mixed = (float(w) for w in line.split()[-4::3])
    assert mixed > lm_alone, line
