"""The frozen generator gives chip_smoke.py::main_data's arrays, and the
run's seed only orders them."""

import importlib.util

import numpy as np
import pytest

from kdbench import catalog
from kdbench.data import mixture

SHAPE = dict(components=64, center_scale=3.0, scale_low=0.3, scale_high=1.5)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", catalog.ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed,shift", [(0, 12), (7, 11)])
def test_draw_is_main_data(seed, shift):
    points, queries = _chip_smoke().main_data(seed, shift)
    p, q = mixture.draw(seed, 2 ** (24 - shift), 10, 2 ** (20 - shift), **SHAPE)
    np.testing.assert_array_equal(p, points)
    np.testing.assert_array_equal(q, queries)


def test_config_shape_is_main_datas():
    cfg = catalog.load_json(catalog.ROOT / "kdbench" / "configs" / "sdss_psf_d10.json")
    shape = {k: v for k, v in cfg["generator"].items() if k not in ("name", "data_seed")}
    assert shape == SHAPE and cfg["generator"]["data_seed"] == 0


def test_make_orders_the_same_catalogue_by_seed():
    args = (4096, 10, 256)
    p0, q0 = mixture.draw(0, *args, **SHAPE)
    pa, qa = mixture.make(2 ** 31 + 3, *args, data_seed=0, **SHAPE)
    pb, qb = mixture.make(2 ** 31 + 3, *args, data_seed=0, **SHAPE)
    pc, _ = mixture.make(5, *args, data_seed=0, **SHAPE)
    np.testing.assert_array_equal(pa, pb)
    np.testing.assert_array_equal(qa, qb)
    assert not (pa == pc).all()
    key = lambda a: a[np.lexsort(a.T[::-1])]
    np.testing.assert_array_equal(key(pa), key(p0))
    np.testing.assert_array_equal(key(qa), key(q0))
