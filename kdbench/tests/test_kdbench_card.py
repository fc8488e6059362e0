"""One tiny run on the card, through the harness's own look for it
(marked ``cuda``: skips without a card)."""

import io
import json

import pytest

from kdbench import harness
from kdbench.tests.helpers import tiny_root


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [{}, {"engine": "jit"}])
def test_a_tiny_cell_runs_on_the_card(tmp_path, spec):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = tiny_root(tmp_path, n=2 ** 16, batch=4096, spec=spec, check_rows=512)
    out, err = io.StringIO(), io.StringIO()
    for trace in (0, 1):
        rc = harness.main(["--workload", "tiny_d10.tiny_batch", "--seed", str(2 ** 32 + 1),
                           "--seconds", "1", "--trace", str(trace)],
                          root=root, stdout=out, stderr=err)
        assert rc == 0, err.getvalue()
        res = json.loads(out.getvalue().strip().splitlines()[-1])
        assert res["correct"] is True, res["checked"]
        assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert res["device"]["busy_s"] > 0 and res["metrics"]["device_idle_pct"]["value"] < 100
    assert res["metrics"]["device_busy_s_per_batch"]["value"] > 0
