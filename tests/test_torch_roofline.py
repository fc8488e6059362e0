"""The port's roofline (``repro_torch.roofline``) and dry-run shapes
(``repro_torch.configs.shapes``) against ``repro``'s, and its counters."""

import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_IDS
from repro.configs.base import get_config as ref_config
from repro.configs import shapes as ref_shapes
from repro.roofline import analysis as ref_analysis
from repro.roofline.model_flops import model_flops as ref_model_flops
from repro.roofline.model_flops import param_counts as ref_param_counts
from repro_torch.configs import get_config
from repro_torch.configs import shapes
from repro_torch.models import LanguageModel
from repro_torch.roofline import HW, dominant_term, model_flops, param_counts, roofline_terms
from repro_torch.roofline.analysis import count_collectives, record_collective
from repro_torch.roofline.calibrate import calibrated_costs, count_ops

META = torch.device("meta")
CPU = torch.device("cpu")


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = [FakeMesh({"data": 16, "model": 16}), FakeMesh({"pod": 2, "data": 16, "model": 16}),
          None]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_and_model_flops_match_reference(arch):
    """``param_counts`` and ``model_flops`` (every shape cell) equal
    ``repro.roofline.model_flops``'s."""
    cfg, rcfg = get_config(arch), ref_config(arch)
    assert param_counts(cfg) == ref_param_counts(rcfg)
    for name, sh in shapes.SHAPES.items():
        assert model_flops(cfg, sh) == ref_model_flops(rcfg, ref_shapes.SHAPES[name]), name


@pytest.mark.parametrize("arch", ["qwen2_7b", "gemma2_27b", "olmoe_1b_7b",
                                  "mamba2_370m", "recurrentgemma_9b", "hubert_xlarge"])
def test_param_counts_match_meta_model(arch):
    """The analytic total equals the numel of the port's
    ``LanguageModel(cfg, tp=1, device="meta")`` (the reference's
    ``tests/test_roofline.py:111`` against its abstract init)."""
    cfg = get_config(arch)
    lm = LanguageModel(cfg, tp=1, device=META)
    assert sum(p.numel() for p in lm.parameters()) == param_counts(cfg)["total"]


def _spec_tuple(spec):
    return tuple(spec)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shapes_and_input_specs_match_reference(arch):
    """``SHAPES``, ``cell_supported``, ``effective_data_axes`` and
    ``input_specs`` (shapes, dtypes, specs as tuples) equal
    ``repro.configs.shapes``'s on the pod meshes and without one."""
    assert {k: tuple(vars(v).values()) for k, v in shapes.SHAPES.items()} == {
        k: tuple(vars(v).values()) for k, v in ref_shapes.SHAPES.items()}
    cfg, rcfg = get_config(arch), ref_config(arch)
    for name, sh in shapes.SHAPES.items():
        rsh = ref_shapes.SHAPES[name]
        assert shapes.cell_supported(cfg, sh) == ref_shapes.cell_supported(rcfg, rsh)
        for mesh in MESHES:
            dax = tuple(a for a in (mesh.axis_names if mesh else ("data",)) if a != "model")
            assert shapes.effective_data_axes(sh.global_batch, dax, mesh) == \
                ref_shapes.effective_data_axes(rsh.global_batch, dax, mesh)
            batch, specs = shapes.input_specs(cfg, sh, dax, mesh)
            rbatch, rspecs = ref_shapes.input_specs(rcfg, rsh, dax, mesh)
            assert list(batch) == list(rbatch) and list(specs) == list(rspecs)
            for k, t in batch.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == tuple(rbatch[k].shape)
                assert str(t.dtype).split(".")[-1] == str(rbatch[k].dtype)
                assert specs[k] == _spec_tuple(rspecs[k]), (name, k)
    assert shapes.batch_specs(cfg, shapes.SHAPES["train_4k"]) == {
        k: _spec_tuple(v) for k, v in ref_shapes.batch_specs(rcfg,
                                                             ref_shapes.SHAPES["train_4k"]).items()}


def test_h100_constants_and_terms():
    """The roofline's constants are an H100 SXM's (data sheet) and the terms
    follow the reference's formulas with them."""
    assert HW["peak_flops"] == 989e12 and HW["hbm_bw"] == 3.35e12
    assert HW["link_bw"] == 450e9 and HW["fp32_flops"] == 67e12 and HW["hbm_bytes"] == 80e9
    assert not set(HW.values()) & set(ref_analysis.HW.values())
    t = roofline_terms(4e15, 2e12, 1e10, 4)
    assert t == {"compute_s": 4e15 / (4 * 989e12), "memory_s": 2e12 / (4 * 3.35e12),
                 "collective_s": 1e10 / (4 * 450e9)}
    for terms in (t, {"compute_s": 1, "memory_s": 3, "collective_s": 2},
                  {"compute_s": 0, "memory_s": 0, "collective_s": 5}):
        assert dominant_term(terms) == ref_analysis.dominant_term(terms)


def test_collective_counter_per_slot():
    """A collective over p slots counts once for each of its slots, per
    slot of the mesh; nothing is recorded outside a count."""
    record_collective("all-reduce", 100, 4)            # no count open: dropped
    with count_collectives(8) as c:
        for _ in range(2):                             # two groups of 4 slots
            record_collective("all-reduce", 100, 4)
        record_collective("all-gather", 10, 8)
        record_collective("all-reduce", 7, 1)          # one slot: no collective
    st = c.stats()
    assert st.per_op == {"all-reduce": 100, "all-gather": 10}
    assert st.count == {"all-reduce": 1, "all-gather": 1}
    assert st.total == 110 and st.wire_ring == pytest.approx(2 * 100 * 3 / 4 + 10 * 7)


def _chain(g, device):
    d = 64
    x = torch.ones((32, d), device=device)
    ws = torch.ones((g, d, d), device=device)

    def fn():
        h = x
        for i in range(g):
            h = torch.tanh(h @ ws[i])
        return h.sum()
    return fn


def test_unrolled_calibration_identity():
    """Extrapolation from G in {1, 2} reproduces a direct count at G = 5
    (``tests/test_roofline.py:87``): FLOPs and bytes."""
    costs = calibrated_costs(lambda g: count_ops(_chain(g, META)), 5, scanned=True)
    truth = count_ops(_chain(5, META))
    assert costs.flops_per_device == pytest.approx(truth.flops, rel=1e-6)
    assert costs.bytes_per_device == pytest.approx(truth.bytes, rel=1e-6)
    assert truth.flops == 5 * 2 * 32 * 64 * 64


def test_counts_equal_flop_counter_mode_on_cpu_and_meta():
    """``count_ops`` (flop_counter's formulas behind the memo) equals
    ``FlopCounterMode`` over a smoke train step on the CPU, and the same
    step on ``meta`` counts the same FLOPs (and bytes, but for one scalar
    moved to the device) as on the CPU."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.training import Hyper, adamw_init, build_train_step

    cfg = get_config("qwen15_0_5b", smoke=True)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 32)),
             "labels": rng.integers(0, cfg.vocab_size, (2, 32))}
    got = {}
    for dev in (CPU, META):
        lm = LanguageModel(cfg, device=dev)
        step = build_train_step(lm, Hyper())
        opt = adamw_init(dict(lm.named_parameters()))
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        got[dev.type] = count_ops(lambda: step(opt, b, 0))
        if dev == CPU:
            with FlopCounterMode(display=False) as fc:
                step(opt, b, 1)
            assert got["cpu"].flops == fc.get_total_flops() > 0
    assert got["meta"].flops == got["cpu"].flops
    # the meta step also copies a host scalar to the model's device (a
    # no-op on the CPU): 64 bytes of 39 MB
    assert got["meta"].bytes == pytest.approx(got["cpu"].bytes, rel=1e-5)
    assert got["meta"].memo_hits > 0 and got["cpu"].memo_hits == 0


def test_live_bytes_track_allocation_and_free():
    """The peak of the live bytes is what was held at once: two 4 MB
    temporaries alive together, then freed, then one more."""
    def fn():
        a = torch.empty((1 << 20,), device=META) + 1.0
        b = a * 2.0
        del a, b
        c = torch.zeros((1 << 20,), device=META) + 1.0
        return c.sum()
    c = count_ops(fn)
    assert c.temp_bytes == pytest.approx(2 * 4 * (1 << 20), rel=0.01)
