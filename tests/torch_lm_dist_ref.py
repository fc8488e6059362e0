"""The reference's side of ``tests/test_torch_lm_dist.py``: ``repro``'s
language model on meshes of forced host devices, in a process of its own.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/torch_lm_dist_ref.py forward OUT.npz
    ... python tests/torch_lm_dist_ref.py train OUT.npz CKPT_DIR

``forward``: the sharded and one-device forward, loss and loss gradients
of each case of ``FORWARD`` (for ``tests/test_torch_lm_dist.py``);
``train``: three steps of ``make_sharded_train_step`` in every param_mode,
and the reference's checkpoint of a sharded tp = 2 training state in
CKPT_DIR (for ``tests/test_torch_lm_dist_train.py``).  Writes the outputs
into OUT.npz, keys ``case/what/<pytree path>``, bf16 leaves widened to
fp32.  Each test file runs its part once, in a process of its own.
"""

import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_cpu_enable_async_dispatch", False)  # see tests/conftest.py

from repro.compat import make_mesh  # noqa: E402
from repro.configs.base import get_config  # noqa: E402
from repro.models.model import LanguageModel  # noqa: E402
from repro.models.transformer import Dist  # noqa: E402
from repro.training.checkpoint import CheckpointManager  # noqa: E402
from repro.training.optimizer import Hyper, adamw_init  # noqa: E402
from repro.training.step import make_sharded_train_step  # noqa: E402

# (case, arch, mesh (data, model), config overrides, seq, batch)
FORWARD = [
    ("qwen15_2x2", "qwen15_0_5b", (2, 2), {}, 16, 4),
    ("qwen2_tp4", "qwen2_7b", (1, 4), {}, 16, 2),
    ("qwen2_tp3", "qwen2_7b", (1, 3), {}, 16, 2),
    ("gemma2_seq", "gemma2_27b", (2, 2), {"seq_shard": True}, 32, 4),
    ("gemma2_noseq", "gemma2_27b", (2, 2), {"seq_shard": False}, 32, 4),
    ("gemma2_seq_bf16", "gemma2_27b", (2, 2), {"seq_shard": True, "dtype": "bfloat16"}, 32, 4),
    ("gemma2_noseq_bf16", "gemma2_27b", (2, 2), {"seq_shard": False, "dtype": "bfloat16"}, 32, 4),
    ("qwen2_s30", "qwen2_7b", (1, 4), {"seq_shard": True}, 30, 2),
    ("moonshot_2x2", "moonshot_v1_16b_a3b", (2, 2), {}, 16, 4),
    ("mamba2_tp2", "mamba2_370m", (1, 2), {}, 32, 2),
    ("rg_tp2", "recurrentgemma_9b", (1, 2), {}, 32, 2),
]
MODES = ("tp", "zero1", "mp_zero1", "fsdp")
TRAIN_STEPS = 3
HYPER = dict(lr=1e-2, warmup_steps=1, total_steps=10)

out = {}


def put(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        a = np.asarray(leaf)
        out[f"{prefix}/{key}" if key else prefix] = (
            a.astype(np.float32) if a.dtype == jnp.bfloat16 else a)


def perturbed(params, seed=0):
    """Seeded noise on the leaves the init sets to a constant (QKV biases,
    norm scales and biases), so that a bias or a norm scale applied on the
    wrong shard changes the function (``tests/test_torch_models.py``)."""
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        if getattr(path[-1], "key", None) in ("b_q", "b_k", "b_v", "scale", "bias"):
            return leaf + jnp.asarray(0.1 * rng.standard_normal(leaf.shape), leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(perturb, params)


def config(arch, overrides):
    """The smoke config in fp32; remat off (the same function, a quicker
    compile: the port runs it under its remat)."""
    return get_config(arch, smoke=True).replace(
        **{"dtype": "float32", "remat": "none", **overrides})


def forward_cases():
    for case, arch, (dp, tp), over, seq, batch in FORWARD:
        cfg = config(arch, over)
        lm = LanguageModel(cfg, tp=tp)
        params = perturbed(lm.init(jax.random.key(0))[0])
        rng = np.random.default_rng(1)
        b = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)}
        mesh = make_mesh((dp, tp), ("data", "model"))
        dist = Dist(mesh=mesh, data_axes=("data",), model_axis="model", tp=tp)

        def run(p, bb, d, grads):
            logits, aux = lm.forward(p, bb, d)
            if not grads:
                return logits, aux, lm.loss(p, bb, d)[1], {}
            (loss, metrics), g = jax.value_and_grad(
                lambda q: lm.loss(q, bb, d), has_aux=True)(p)
            return logits, aux, metrics, g

        want_grads = cfg.dtype == "float32"
        with mesh:
            logits, aux, metrics, grads = jax.jit(
                lambda p, bb: run(p, bb, dist, want_grads))(params, b)
        one = jax.jit(lambda p, bb: run(p, bb, None, False))(params, b)
        put(f"{case}/params", params)
        put(f"{case}/batch", b)
        put(f"{case}/logits", logits)
        put(f"{case}/aux", aux)
        put(f"{case}/metrics", metrics)
        put(f"{case}/grads", grads)
        put(f"{case}/one_logits", one[0])
        put(f"{case}/one_aux", one[1])
        put(f"{case}/one_metrics", one[2])


def train_cases(ckpt_dir):
    mesh = make_mesh((2, 2), ("data", "model"))
    rng = np.random.default_rng(2)
    base = config("qwen15_0_5b", {})
    batches = [{"tokens": rng.integers(0, base.vocab_size, (4, 16)).astype(np.int32),
                "labels": rng.integers(0, base.vocab_size, (4, 16)).astype(np.int32)}
               for _ in range(TRAIN_STEPS)]
    put("train/batches", batches)
    for mode, ga in [(m, 1) for m in MODES] + [("zero1", 2)]:
        case = f"train_{mode}_ga{ga}"
        cfg = base.replace(param_dtype="bfloat16") if mode == "mp_zero1" else base
        lm = LanguageModel(cfg, tp=2)
        params = perturbed(lm.init(jax.random.key(0))[0])
        opt = adamw_init(params, master_fp32=mode == "mp_zero1")
        step, _ = make_sharded_train_step(lm, Hyper(grad_accum=ga, **HYPER), mesh,
                                          param_mode=mode, donate=False)
        put(f"{case}/params0", params)
        with mesh:
            for t, b in enumerate(batches):
                params, opt, metrics = step(params, opt, b, jnp.int32(t))
                put(f"{case}/step{t}/params", params)
                put(f"{case}/step{t}/metrics", metrics)
                if mode == "mp_zero1" or ga > 1:
                    put(f"{case}/step{t}/opt", opt)
                if mode == "tp" and ga == 1 and t == 0:
                    ck = CheckpointManager(ckpt_dir, async_save=False)
                    ck.save(1, {"params": params, "opt": opt}, extra={"data_step": 1})


if __name__ == "__main__":
    if sys.argv[1] == "forward":
        forward_cases()
    else:
        train_cases(sys.argv[3])
    np.savez(sys.argv[2], **out)
    print("REF_OK", len(out))
