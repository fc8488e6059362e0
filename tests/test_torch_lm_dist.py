"""repro_torch's language model across device slots against repro's under
``Dist`` (tensor, sequence and expert parallelism), on CPU slots.

The reference's sharded runs need forced host devices, which
``tests/conftest.py`` keeps out of this process: one module-scoped
subprocess (``tests/torch_lm_dist_ref.py forward``, 8 host devices) runs
``repro``'s ``LanguageModel.forward`` / ``loss`` and its loss gradients under
``Dist(mesh, ("data",), "model", tp)`` and on one device, for each case of
its ``FORWARD`` list, and hands them back as npz.  The port runs the same
weights (``models/convert.py::shards_from_reference``) as a ``ShardedLM``
on ``(cpu,) * P`` slots of the same mesh shape.  The rest runs in-process:
decode against ``repro``'s one-device ``decode_step``, the specs and
``apply_fsdp`` of the ten configs at full width (``abstract_init``, shapes
only), the shard conversion and ``ef_int8_allreduce`` under ``jax.vmap``.

Tolerances (fp32, ``cfg.replace(dtype="float32")``): logits within 1e-4 of
max |logit|, the loss and the MoE metrics within 1e-5 (relative), each
gradient within 1e-4 of its max |value| (the sums over slots and
vocabulary shards associate otherwise than XLA's); bf16 (gemma2, the
reference's own case of ``tests/test_seq_shard.py``): seq_shard on
against off within its 3e-2 of max |logit|, against the reference by the
bf16 rule of ``tests/test_torch_models.py``.  The weights carry seeded
noise on their biases and norm scales (``torch_lm_dist_ref.perturbed``).
The shard round trip and the compressed all-reduce are bit for bit.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_IDS
from repro.configs.base import get_config as ref_config
from repro.launch.mesh import data_axes_of as ref_data_axes_of
from repro.launch.mesh import tp_of as ref_tp_of
from repro.models import attention as ref_attention
from repro.models.layers import resolve_specs as ref_resolve_specs
from repro.models.model import LanguageModel as RefLM
from repro.models.transformer import grow_cache as ref_grow_cache
from repro.training.compression import ef_int8_allreduce as ref_ef_int8_allreduce
from repro.training.step import apply_fsdp as ref_apply_fsdp
from repro_torch.configs import get_config
from repro_torch.distributed.mesh import SlotMesh, shard_shape
from repro_torch.launch.mesh import DryRunNotPorted, data_axes_of, make_production_mesh, tp_of
from repro_torch.models import (
    Dist,
    LanguageModel,
    params_from_reference,
    reference_from_shards,
    shards_from_reference,
)
from repro_torch.models import attention
from repro_torch.models.convert import _nest
from repro_torch.models.model import param_specs
from repro_torch.models.transformer import grow_cache
from repro_torch.training import apply_fsdp, ef_int8_allreduce
from repro_torch.training.step import loss_gradients, stacked_groups

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.abspath(os.path.join(HERE, "..", "src"))
sys.path.insert(0, HERE)
import torch_lm_dist_ref as REF  # noqa: E402  (the case list; its jax runs in the subprocess)

CPU = torch.device("cpu")
LOGIT_TOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
BF16_TOL = 3e-2
BF16_ATOL, BF16_ERR_RATIO = 0.5, 1.25


def start_reference(tmp, part, *args):
    """Start ``torch_lm_dist_ref.py part`` with 8 forced host devices;
    returns (process, npz path, log path)."""
    out, log = tmp / f"{part}.npz", tmp / f"{part}.log"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, os.path.join(HERE, "torch_lm_dist_ref.py"),
                                 part, str(out), *map(str, args)], stdout=f, stderr=f, env=env)
    return proc, out, log


def wait_reference(proc, out, log):
    """The reference's outputs once its process has ended."""
    rc = proc.wait(timeout=900)
    text = open(log).read()
    assert rc == 0 and "REF_OK" in text, text[-3000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module", autouse=True)
def reference_process(tmp_path_factory):
    """The reference's process, started with the module's first test and
    waited for by the tests that read it (the last ones)."""
    proc, out, log = start_reference(tmp_path_factory.mktemp("lm_dist"), "forward")
    yield proc, out, log
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def ref(reference_process):
    return wait_reference(*reference_process)


def _tree(ref, prefix):
    return _nest({k[len(prefix) + 1:]: v for k, v in ref.items() if k.startswith(prefix + "/")})


def _case(name):
    case = next(c for c in REF.FORWARD if c[0] == name)
    _, arch, (dp, tp), over, seq, batch = case
    return arch, dp, tp, over


def _sharded(ref, name):
    """The case's weights as a ShardedLM on (cpu,) * P slots, the port's
    config at its own remat ("full": the reference ran without; same function)."""
    arch, dp, tp, over = _case(name)
    cfg = get_config(arch, smoke=True).replace(**{"dtype": "float32", **over})
    mesh = SlotMesh((CPU,) * (dp * tp), {"data": dp, "model": tp})
    dist = Dist(mesh, ("data",), "model", tp)
    return shards_from_reference(_tree(ref, f"{name}/params"), cfg, dist), cfg


def _rel_max(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / max(np.abs(want).max(), 1e-30))


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------
DECODE = [  # (arch, data, model, the cache's layout)
    ("qwen2_7b", 2, 2, "kv heads split, rows over data, per-row positions"),
    ("qwen2_7b", 1, 4, "length split"),
    ("qwen2_7b", 1, 3, "length split, heads padded 4 -> 6"),
    ("gemma2_27b", 1, 4, "rolling window, length split"),
]
PROMPT, MAX_LEN, STEPS = 20, 32, 6


@pytest.mark.parametrize("arch,dp,tp,layout", DECODE)
def test_decode_matches_reference(arch, dp, tp, layout):
    """Prefill of a 20-token prompt (longer than one slot's share of a
    32-slot cache), then 6 decode steps: the logits against ``repro``'s
    one-device ``prefill`` / ``grow_cache`` / ``decode_step`` of the same
    ``LanguageModel(cfg, tp)`` weights and against the port's one slot;
    the cache shards' specs against ``repro``'s ``abstract_cache``."""
    rcfg = ref_config(arch, smoke=True).replace(dtype="float32")
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    rlm = RefLM(rcfg, tp=tp)
    params = REF.perturbed(rlm.init(jax.random.key(0))[0])
    params_np = jax.tree.map(np.asarray, params)
    b = 2 * dp
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (b, PROMPT + STEPS)).astype(np.int32)
    per_row = dp > 1

    def pos_of(p):
        return np.full((b,), p, np.int32) if per_row else np.int32(p)

    rlog, rc = rlm.prefill(params, {"tokens": jnp.asarray(toks[:, :PROMPT])})
    rc = ref_grow_cache(rc, rcfg, MAX_LEN)
    want = [np.asarray(rlog)]
    dec = jax.jit(rlm.decode_step)
    for i in range(STEPS):
        lg, rc = dec(params, {"tokens": jnp.asarray(toks[:, PROMPT + i:PROMPT + i + 1]),
                              "pos": jnp.asarray(pos_of(PROMPT + i))}, rc)
        want.append(np.asarray(lg))

    mesh = SlotMesh((CPU,) * (dp * tp), {"data": dp, "model": tp})
    slm = shards_from_reference(params_np, cfg, Dist(mesh, ("data",), "model", tp))
    one = LanguageModel(cfg, tp=tp, device=CPU)
    one.load_state_dict(params_from_reference(params_np, cfg))
    got, caches = slm.prefill({"tokens": toks[:, :PROMPT]})
    one_got, one_c = one.prefill({"tokens": toks[:, :PROMPT]})
    caches = slm.grow_cache(caches, MAX_LEN)
    one_c = grow_cache(one_c, cfg, MAX_LEN)
    outs, ones = [got], [one_got]
    for i in range(STEPS):
        step = {"tokens": toks[:, PROMPT + i:PROMPT + i + 1], "pos": pos_of(PROMPT + i)}
        outs.append(slm.decode_step(step, caches)[0])
        ones.append(one.decode_step(step, one_c)[0])
    for t, (g, o, w) in enumerate(zip(outs, ones, want)):
        assert _rel_max(g.numpy(), w) <= LOGIT_TOL, (layout, t)
        assert _rel_max(g.numpy(), o.numpy()) <= LOGIT_TOL, (layout, t)

    # the cache shards: the reference's specs (the group axis dropped), the
    # shapes its GSPMD split gives
    _, rspecs = rlm.abstract_cache(b, MAX_LEN)
    rspecs = ref_resolve_specs(rspecs, ("data",))
    gs, ng = cfg.group_size(), cfg.n_groups()
    full = one.init_cache(b, MAX_LEN)
    for i in range(cfg.n_layers):
        r = rspecs["groups"][i % gs] if i < ng * gs else rspecs["rest"][i - ng * gs]
        strip = i < ng * gs
        mine = slm.cache_specs(i)
        for n, sp in r.items():
            want_spec = tuple(sp)[1:] if strip else tuple(sp)
            assert _norm_spec(mine[n], 4) == _norm_spec(want_spec, 4), (i, n)
            for s in range(mesh.size):
                assert tuple(caches[i][s][n].shape) == shard_shape(full[i][n].shape, mine[n],
                                                                   mesh, s), (i, n, s)
    if layout.startswith("length"):
        assert not attention.kv_sharded(cfg, tp)


# --------------------------------------------------------------------------
# specs, apply_fsdp, mesh helpers (shapes only, every config at full width)
# --------------------------------------------------------------------------
def _norm_spec(spec, ndim):
    """A spec padded to ``ndim`` entries, each entry a tuple of axis names
    (PartitionSpec writes a one-axis tuple as the name)."""
    def entry(e):
        return () if e is None else (e,) if isinstance(e, str) else tuple(e)

    return tuple(entry(e) for e in spec) + ((),) * (ndim - len(tuple(spec)))


def _flat_ref_specs(tree, cfg):
    """The reference's spec tree by the port's state-dict names (the
    stacked group axis dropped)."""
    out = {}

    def walk(prefix, node, strip):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(f"{prefix}.{k}", v, strip)
            else:
                out[f"{prefix}.{k}"] = tuple(v)[1:] if strip else tuple(v)

    walk("embed", tree["embed"], False)
    walk("frontend", tree.get("frontend") or {}, False)
    gs, ng = cfg.group_size(), cfg.n_groups()
    for i in range(ng * gs):
        walk(f"blocks.{i}", tree["blocks"]["groups"][i % gs], True)
    for r, layer in enumerate(tree["blocks"]["rest"]):
        walk(f"blocks.{ng * gs + r}", layer, False)
    walk("final_norm", tree["final_norm"], False)
    return out


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_and_fsdp_match_reference(arch):
    """For each config at full width and tp = 2, 4, 8: ``heads_padded``,
    ``kv_sharded``, the split dimension of every parameter
    (``param_specs`` against the reference's ``abstract_init`` specs) and
    the shapes; ``apply_fsdp``'s choice at data = 2, 4 against the
    reference's on a FakeMesh (on the unstacked tensor, the stacked
    group axis skipped as the reference skips it)."""
    rcfg, cfg = ref_config(arch), get_config(arch)
    for tp in (2, 4, 8):
        assert attention.heads_padded(cfg, tp) == ref_attention.heads_padded(rcfg, tp)
        assert attention.kv_sharded(cfg, tp) == ref_attention.kv_sharded(rcfg, tp)
        sds, rspecs = RefLM(rcfg, tp=tp).abstract_init()
        want = _flat_ref_specs(rspecs, cfg)
        lm = LanguageModel(cfg, tp=tp, device="meta")
        shapes = {n: tuple(p.shape) for n, p in lm.named_parameters()}
        assert set(want) == set(shapes)
        mine = param_specs(cfg, tp)
        for n, sp in want.items():
            assert _norm_spec(mine[n], len(shapes[n])) == _norm_spec(sp, len(shapes[n])), n
        for dp in (2, 4):
            fake = FakeMesh({"data": dp, "model": tp})
            rz = ref_apply_fsdp(ref_resolve_specs(rspecs, ("data",)), sds, ("data",), fake)
            rz = _flat_ref_specs(rz, cfg)
            z = apply_fsdp(mine, shapes, ("data",), fake, groups=stacked_groups(cfg))
            for n, sp in rz.items():
                assert _norm_spec(z[n], len(shapes[n])) == _norm_spec(sp, len(shapes[n])), (
                    n, dp)


def test_parameter_shapes_match_reference():
    """``LanguageModel(cfg, tp)``'s shapes (heads padded) equal the
    reference's ``abstract_init`` shapes, qwen2_7b (28 heads) at tp 8."""
    rcfg, cfg = ref_config("qwen2_7b"), get_config("qwen2_7b")
    sds, _ = RefLM(rcfg, tp=8).abstract_init()
    ref_shapes = {}

    def walk(prefix, node, strip):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(f"{prefix}.{k}", v, strip)
            else:
                ref_shapes[f"{prefix}.{k}"] = tuple(v.shape)[1:] if strip else tuple(v.shape)

    walk("embed", sds["embed"], False)
    gs, ng = cfg.group_size(), cfg.n_groups()
    for i in range(ng * gs):
        walk(f"blocks.{i}", sds["blocks"]["groups"][i % gs], True)
    walk("final_norm", sds["final_norm"], False)
    lm = LanguageModel(cfg, tp=8, device="meta")
    assert {n: tuple(p.shape) for n, p in lm.named_parameters()} == ref_shapes
    assert ref_shapes["blocks.0.mixer.w_q"] == (3584, 32, 128)


def test_mesh_helpers_match_reference():
    """``data_axes_of`` / ``tp_of`` against ``repro.launch.mesh``'s on the
    reference's FakeMesh and on a SlotMesh; the pod meshes raise."""
    for shape in ({"pod": 2, "data": 16, "model": 16}, {"data": 2, "model": 2}):
        fake = FakeMesh(shape)
        assert data_axes_of(fake) == ref_data_axes_of(fake)
        assert tp_of(fake) == ref_tp_of(fake)
    mesh = SlotMesh((CPU,) * 8, {"data": 4, "model": 2})
    assert data_axes_of(mesh) == ("data",) and tp_of(mesh) == 2
    assert mesh.group(5, ("data",)) == [1, 3, 5, 7] and mesh.coords(5) == {"data": 2, "model": 1}
    with pytest.raises(DryRunNotPorted, match="item 19"):
        make_production_mesh()


# --------------------------------------------------------------------------
# the shard conversion
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch,tp", [("qwen2_7b", 2), ("qwen2_7b", 3), ("gemma2_27b", 3),
                                     ("recurrentgemma_9b", 3), ("moonshot_v1_16b_a3b", 2),
                                     ("mamba2_370m", 2), ("llava_next_mistral_7b", 2)])
def test_shards_round_trip_reference_params(arch, tp):
    """``repro``'s ``LanguageModel(cfg, tp).init`` parameters (padded heads
    at qwen2 tp 3, uneven vocabulary / d_ff / width shards at 3) placed on
    2 x tp slots and gathered back: equal to the input bit for bit."""
    cfg = get_config(arch, smoke=True)
    params, _ = RefLM(ref_config(arch, smoke=True), tp=tp).init(jax.random.key(0))
    params_np = jax.tree.map(np.asarray, params)
    mesh = SlotMesh((CPU,) * (2 * tp), {"data": 2, "model": tp})
    slm = shards_from_reference(params_np, cfg, Dist(mesh, ("data",), "model", tp))
    back = reference_from_shards(slm)
    flat_in = jax.tree_util.tree_flatten_with_path(params_np)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_in) == len(flat_back)
    for path, a in flat_in:
        b = flat_back[path]
        assert b.shape == a.shape and np.array_equal(b, np.asarray(a, b.dtype)), path
    # each slot holds its own shards only
    if "blocks.0.mixer.w_q" in slm.specs:
        for s in range(mesh.size):
            w_q = slm.params[s]["blocks.0.mixer.w_q"]
            assert w_q.shape[1] == attention.heads_padded(cfg, tp) // tp


# --------------------------------------------------------------------------
# int8 gradient compression
# --------------------------------------------------------------------------
def _ref_ef(g, e):
    def body(gg, ee):
        m, e2 = ref_ef_int8_allreduce({"w": gg}, {"w": ee}, "dp")
        return m["w"], e2["w"]

    m, e2 = jax.jit(jax.vmap(body, axis_name="dp"))(jnp.asarray(g), jnp.asarray(e))
    return np.asarray(m), np.asarray(e2)


@pytest.mark.parametrize("shape", [(4, 1000), (2, 37, 5), (3, 64)])
def test_ef_int8_allreduce_matches_reference(shape):
    """``ef_int8_allreduce`` over P slots against the reference's under
    ``jax.vmap`` (its ``pmax`` / ``psum`` over the mapped axis): the mean
    and the error feedback bit for bit, then two more steps fed back."""
    rng = np.random.default_rng(sum(shape))
    g = rng.normal(size=shape).astype(np.float32)
    e = np.zeros(shape, np.float32)
    errs = [{"w": torch.zeros(shape[1:])} for _ in range(shape[0])]
    for _ in range(3):
        want_m, e = _ref_ef(g, e)
        means, errs = ef_int8_allreduce([{"w": torch.from_numpy(x)} for x in g], errs)
        for i in range(shape[0]):
            np.testing.assert_array_equal(means[i]["w"].numpy(), want_m[i])
            np.testing.assert_array_equal(errs[i]["w"].numpy(), e[i])
        g = rng.normal(size=shape).astype(np.float32)
    # the quantized mean is close to the exact one
    exact = g.mean(0)
    means, _ = ef_int8_allreduce([{"w": torch.from_numpy(x)} for x in g],
                                 [{"w": torch.zeros(shape[1:])} for _ in range(shape[0])])
    assert np.abs(means[0]["w"].numpy() - exact).max() <= 0.05 * np.abs(exact).max()


# --------------------------------------------------------------------------
# forward, loss and gradients against the reference's sharded runs (last:
# the reference's process runs while the tests above run)
# --------------------------------------------------------------------------
FP32_CASES = [c[0] for c in REF.FORWARD if not c[0].endswith("bf16")]


@pytest.mark.parametrize("name", FP32_CASES)
def test_forward_loss_and_gradients_match_reference(ref, name):
    """``ShardedLM.forward`` / ``loss`` / their gradients against
    ``repro``'s ``LanguageModel.forward`` / ``loss`` under ``Dist`` on the
    same mesh shape, and against its one-device forward: kv split
    (qwen15 2 x 2), kv replicated (qwen2 tp 4), padded heads (qwen2 tp 3),
    seq_shard on and off (gemma2 2 x 2), S = 30 at tp 4, MoE under EP with
    data = 2 (moonshot), the SSM and RG-LRU widths split (tp 2)."""
    slm, cfg = _sharded(ref, name)
    batch = _tree(ref, f"{name}/batch")
    with torch.no_grad():
        logits, aux = slm.forward(batch)
    assert _rel_max(logits.numpy(), ref[f"{name}/logits"]) <= LOGIT_TOL
    grads, metrics = loss_gradients(slm, batch)
    want = _tree(ref, f"{name}/metrics")
    assert set(metrics) == set(want)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), float(want[k]), rtol=LOSS_RTOL, atol=1e-12,
                                   err_msg=k)
    ref_grads = params_from_reference(_tree(ref, f"{name}/grads"), cfg)
    for k, g in grads.items():
        assert _rel_max(g.numpy(), ref_grads[k].numpy()) <= GRAD_TOL, k
    one = ref[f"{name}/one_logits"]
    if cfg.n_experts:
        # the reference's EP capacity is one data row's tokens': its drops,
        # and so its logits, differ from the one-device run's
        one_m = _tree(ref, f"{name}/one_metrics")
        assert float(metrics["moe_drop"]) != pytest.approx(float(one_m["moe_drop"]), rel=1e-3)
        assert float(metrics["moe_load_balance"]) != pytest.approx(
            float(one_m["moe_load_balance"]), rel=1e-3)
    else:
        assert _rel_max(logits.numpy(), one) <= LOGIT_TOL


def test_bf16_seq_shard_matches_reference(ref):
    """gemma2 smoke in bf16 on 2 x 2 slots, ``seq_shard`` on and off: the
    reference's own case (``tests/test_seq_shard.py``): the two within its
    3e-2 of max |logit|; against ``repro``'s sharded bf16 runs by the bf16
    rule of ``tests/test_torch_models.py`` (XLA fuses chains the port rounds
    op by op): the mean error against the fp32 function within 1.25x the
    reference's own, and every logit within 0.5 of the reference's."""
    outs = {}
    for name in ("gemma2_seq_bf16", "gemma2_noseq_bf16"):
        slm, _ = _sharded(ref, name)
        with torch.no_grad():
            out = outs[name] = slm.forward(_tree(ref, f"{name}/batch"))[0].numpy()
        want, f32 = ref[f"{name}/logits"], ref[name.replace("_bf16", "") + "/logits"]
        np.testing.assert_allclose(out, want, rtol=0, atol=BF16_ATOL)
        port_err, ref_err = np.abs(out - f32).mean(), np.abs(want - f32).mean()
        assert port_err <= BF16_ERR_RATIO * ref_err + 1e-3, (name, port_err, ref_err)
    assert _rel_max(outs["gemma2_seq_bf16"], outs["gemma2_noseq_bf16"]) < BF16_TOL
