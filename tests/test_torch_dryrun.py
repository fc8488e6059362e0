"""The port's dry run (``repro_torch.launch.dryrun`` / ``.perf``, the
production meshes, the collective counter) against ``repro``'s.

``repro``'s side needs four host devices: one subprocess
(``tests/torch_dryrun_ref.py``) runs it while the in-process tests run,
and the tests that read it come last.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_config
from repro.roofline.model_flops import model_flops as ref_model_flops
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.distributed.mesh import SlotMesh, all_gather, all_sum, reduce_scatter
from repro_torch.launch import dryrun as dr
from repro_torch.launch import perf
from repro_torch.roofline.analysis import HW, collective_bytes
from repro_torch.roofline.calibrate import calibrated_costs
from repro_torch.roofline.model_flops import model_flops

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.abspath(os.path.join(HERE, "..", "src"))
sys.path.insert(0, HERE)
import torch_dryrun_ref as REF  # noqa: E402  (the case list; its jax runs in the subprocess)

META = torch.device("meta")
CPU = torch.device("cpu")


def _mesh(device=META):
    return SlotMesh((device,) * 4, {"data": 2, "model": 2})


@pytest.fixture(scope="module", autouse=True)
def reference_process(tmp_path_factory):
    """``torch_dryrun_ref.py`` with 4 forced host devices, started with the
    module's first test."""
    log = tmp_path_factory.mktemp("dryrun_ref") / "ref.log"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, os.path.join(HERE, "torch_dryrun_ref.py")],
                                stdout=f, stderr=f, env=env)
    yield proc, log
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def ref(reference_process):
    proc, log = reference_process
    rc = proc.wait(timeout=900)
    text = open(log).read()
    line = next((x for x in text.splitlines() if x.startswith("REF_JSON ")), None)
    assert rc == 0 and line, text[-3000:]
    return json.loads(line[len("REF_JSON "):])


def _smoke_shape(kind):
    s, b = {k: (s, b) for k, s, b in REF.CELLS}[kind]
    return ShapeSpec(kind[0], kind, s, b)


def _step(arch, kind):
    cfg = get_config(arch, smoke=True)
    kw = {"policy": REF.POLICY} if kind == "train" else {}
    return dr._COMPILERS[kind](cfg, _smoke_shape(kind), _mesh(), None, **kw)


# --------------------------------------------------------------------------
# in-process
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", REF.ARCHS)
def test_smoke_cells_trace_on_a_meta_mesh(arch):
    """train, prefill and decode of the smoke config run on a 2 x 2 mesh of
    meta slots under the counters (``dr.compile_*`` as the dry run builds
    them); the train step's MODEL_FLOPS / counted FLOPs lands in (0.1, 1.0)
    (``tests/test_dryrun_small.py:60``), and ``model_flops`` equals
    ``repro.roofline.model_flops``'s for the cell."""
    cfg = get_config(arch, smoke=True)
    for kind, _, _ in REF.CELLS:
        if kind == "decode" and not cfg.supports_decode():
            continue
        c = _step(arch, kind).count()
        assert c.flops > 0 and c.bytes > 0 and c.temp_bytes > 0, (kind, c)
        if kind == "train":
            sh = _smoke_shape(kind)
            mf = model_flops(cfg, sh)
            assert mf == ref_model_flops(ref_config(arch, smoke=True), sh)
            ratio = mf["spec"] / (c.flops * 4)
            assert 0.1 < ratio < 1.0, ratio


def test_calibration_consistency_small_mesh():
    """``tests/test_dryrun_small.py::test_calibration_consistency_small_mesh``
    on the port: Qwen1.5-0.5B cut to 4 layers, vocabulary 2048, zero1 fp32
    at grad_accum 1 on a 2 x 2 meta mesh; the extrapolated total lands in
    (0.1, 1.0) of MODEL_FLOPS and equals a direct count at 4 layers."""
    cfg = get_config("qwen15_0_5b").replace(n_layers=4, vocab_size=2048,
                                            vocab_pad_multiple=16)
    sh = ShapeSpec("t", "train", 128, 8)
    pol = {"param_mode": "zero1", "grad_accum": 1, "param_dtype": "float32"}
    mesh = _mesh()
    costs = calibrated_costs(lambda g: dr.compile_train(cfg, sh, mesh, g, policy=pol).count(),
                             cfg.n_groups(), scanned=True)
    direct = dr.compile_train(cfg, sh, mesh, None, policy=pol).count()
    assert costs.flops_per_device == pytest.approx(direct.flops, rel=1e-6)
    assert costs.bytes_per_device == pytest.approx(direct.bytes, rel=1e-6)
    assert costs.coll_bytes_per_device == pytest.approx(direct.coll.total, rel=1e-6)
    ratio = model_flops(cfg, sh)["spec"] / (costs.flops_per_device * 4)
    assert 0.1 < ratio < 1.0, ratio


def test_dryrun_cli_writes_the_h100_roofline_without_jax(tmp_path):
    """``python -m repro_torch.launch.dryrun`` on the knn_service cell writes
    a JSON with the H100 constants, and never imports jax."""
    code = ("import runpy, sys\n"
            "sys.argv = ['dryrun', '--arch', 'knn_service', '--shape', 'knn_1M', "
            f"'--out', {str(tmp_path)!r}]\n"
            "runpy.run_module('repro_torch.launch.dryrun', run_name='__main__')\n"
            "assert 'jax' not in sys.modules and not any(m == 'repro' or "
            "m.startswith('repro.') for m in sys.modules)\n"
            "print('NO_JAX')\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0 and "NO_JAX" in out.stdout, out.stderr[-3000:]
    res = json.load(open(tmp_path / "knn_service__knn_1M__single.json"))
    assert res["chips"] == 256 and res["roofline"]["hw"] == HW
    assert res["memory"]["capacity_bytes"] == 80e9 and res["memory"]["fits_80g"]
    assert res["dominant"] in ("compute", "memory", "collective")


def test_knn_reckoning_equals_the_rings_launches(monkeypatch):
    """``knn_ring_launches`` lists the launches ``ring_knn_brute`` makes (on
    the CPU its plain leaf scan takes the same plan, TQ = 16), at an n the
    slots do not divide and more than one launch a step."""
    from repro_torch.api import IndexSpec, KNNIndex
    from repro_torch.distributed import ring_knn
    from repro_torch.kernels import ops as kops

    seen = []
    real = kops.leaf_scan_units

    def spy(q, slab, unit_leaf, unit_query, n_units, **kw):
        seen.append((unit_leaf.shape[0], unit_query.shape[1], slab.shape[1], slab.shape[2]))
        return real(q, slab, unit_leaf, unit_query, n_units, **kw)

    monkeypatch.setattr(kops, "leaf_scan_units", spy)
    monkeypatch.setattr(ring_knn, "RING_SLAB", 64)
    monkeypatch.setattr(ring_knn, "RING_UNITS", 8)
    rng = np.random.default_rng(0)
    n, m, d, p = 1001, 150, 3, 4
    pts = rng.normal(size=(n, d)).astype(np.float32)
    idx = KNNIndex.build(pts, IndexSpec(engine="ring", devices=(CPU,) * p))
    idx.query(rng.normal(size=(m, d)).astype(np.float32), 5)
    want = dr.knn_ring_launches(n, m, d, p, tq=16)
    assert sorted(seen) == sorted(want) and len(set(want)) > 1
    ops = sum(dr.leaf_scan_work(*w, k=1)[0] for w in seen)
    assert ops == sum(w * tq * lp * (2 * dd + 3) for w, tq, lp, dd in want)


def test_perf_exps_run_through_the_port():
    """``a_bf16_ring`` reckons the ring at 2 bytes an element: the memory
    term falls, the compute term stays."""
    base = dr.run_cell(dr.KNN_ARCH, "knn_1M", False)
    half = perf.exp_a_bf16_ring()
    assert half["roofline"]["compute_s"] == base["roofline"]["compute_s"]
    assert half["roofline"]["memory_s"] < 0.6 * base["roofline"]["memory_s"]
    assert "no bf16 code type" in half["note"]


def _run_cell_smoke(monkeypatch):
    """The port's ``run_cell`` with the reference script's replacements."""
    mesh = _mesh()
    monkeypatch.setattr(dr, "make_production_mesh", lambda multi_pod=False: mesh)
    monkeypatch.setattr(dr, "get_config", lambda arch: get_config(arch, smoke=True))
    monkeypatch.setattr(dr, "SHAPES", {"t": ShapeSpec("t", "train", 64, 8)})
    monkeypatch.setattr(dr, "TRAIN_POLICY", dict(dr.TRAIN_POLICY, qwen2_7b=REF.POLICY))
    monkeypatch.setattr(dr, "KNN_N", 1 << 12)
    monkeypatch.setattr(dr, "KNN_M", 1 << 8)
    return dr.run_cell("qwen2_7b", "t", False), dr.run_cell(dr.KNN_ARCH, "knn_1M", False)


# --------------------------------------------------------------------------
# against the reference's process
# --------------------------------------------------------------------------
@pytest.mark.parametrize("op", ["all_sum", "all_gather", "reduce_scatter"])
def test_collective_counter_matches_reference_hlo(ref, op):
    """The counter of the port's collectives over the ``model`` axis of a
    2 x 2 mesh of CPU slots equals ``repro.roofline.collective_bytes`` of
    the same collective's HLO under ``shard_map``: per_op, count, total and
    the ring-model wire bytes, per slot."""
    mesh = _mesh(CPU)
    x = torch.arange(REF.ROW * 16, dtype=torch.float32).reshape(REF.ROW, 16)
    per = REF.ROW // mesh.size
    parts = [x[s * per:(s + 1) * per] for s in range(mesh.size)]

    def run():
        for row in mesh.groups(("model",)):
            ps, devs = [parts[s] for s in row], [mesh.devices[s] for s in row]
            if op == "all_sum":
                all_sum(ps, devs)
            elif op == "all_gather":
                all_gather(ps, 0, devs)
            else:
                reduce_scatter(ps, 0, devs)

    got = collective_bytes(run, mesh.size).as_dict()
    assert got == ref["collectives"][op]


@pytest.mark.parametrize("arch", REF.ARCHS)
def test_argument_bytes_match_reference(ref, arch):
    """Each slot's ``argument_bytes`` of the train (mp_zero1, bf16), prefill
    and decode cells equals the reference's
    ``memory_analysis().argument_size_in_bytes`` of the same cell."""
    cfg = get_config(arch, smoke=True)
    for kind, _, _ in REF.CELLS:
        if kind == "decode" and not cfg.supports_decode():
            continue
        kw = {"policy": REF.POLICY} if kind == "train" else {}
        st = dr._COMPILERS[kind](cfg, _smoke_shape(kind), _mesh(), None, build=False, **kw)
        assert st.argument_bytes == ref["argument_bytes"][f"{arch}/{kind}"], kind


def test_run_cell_keys_match_reference(ref, monkeypatch):
    """``run_cell``'s keys (and its memory entry's) equal the reference's,
    the capacity key renamed for the H100's 80 GB and given beside it."""
    lm, knn = _run_cell_smoke(monkeypatch)
    keys = ref["run_cell_keys"]

    def renamed(ks):
        return sorted(["fits_80g" if k == "fits_16g" else k for k in ks] + ["capacity_bytes"])

    assert sorted(lm) == keys["lm"] and sorted(knn) == keys["knn"]
    assert sorted(set(lm["memory"]) - {"microbatch_points", "accumulator_bytes"}) == renamed(
        keys["lm_memory"])
    assert sorted(knn["memory"]) == renamed(keys["knn_memory"])
    assert lm["memory"]["argument_bytes"] == ref["argument_bytes"]["qwen2_7b/train"]


def test_perf_exps_names_match_reference(ref):
    assert sorted(perf.EXPS) == ref["exps"]
