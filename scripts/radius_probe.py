#!/usr/bin/env python3
"""Which side returns the wrong radius distances: the JAX oracle or the port's?

``tests/test_torch_dualtree.py::TestRadius::test_parity_all_store_variants``
holds the port's ``radius_brute`` bit for bit against ``repro``'s, on
integer-lattice points where every squared pair distance is an exact fp32
integer.  This probe runs both oracles in one process, in the test's order
and on the test's inputs (``lattice(2000, 3, seed=2000)`` points,
``lattice(150, 3, seed=2001)`` queries, r = sqrt(7.5)), and holds EACH side
against a float64 computation of the same pairs: the pair set of d2 <= r2
and, per pair, fp32 sqrt of the exact integer d2 (IEEE sqrt is correctly
rounded, so that is the only right fp32 value).  On a mismatch it prints the
side at fault, how many entries, the wrong value and the d2 it came from,
and the process's floating-point state.

    PYTHONPATH=src python scripts/radius_probe.py --repeats 200

Exit code 1 when any repeat found a side off.  ``probe_once`` is what a
pytest wrapper calls to run the probe under xdist workers, as the test
suite runs (it returns the findings; an empty list means both sides exact).
"""

from __future__ import annotations

import argparse
import ctypes
import mmap
import os
import sys

import numpy as np

RADIUS = float(np.sqrt(7.5))


def lattice(n, d, seed=0, span=12):
    rng = np.random.default_rng(seed)
    return rng.integers(0, span, size=(n, d)).astype(np.float32)


def read_mxcsr():
    """The calling thread's MXCSR (x86-64 only), read by four bytes of
    machine code (``stmxcsr [rdi]; ret``) in an executable page; None where
    that cannot run."""
    try:
        import platform

        if platform.machine() not in ("x86_64", "AMD64"):
            return None
        code = bytes([0x0F, 0xAE, 0x1F, 0xC3])
        buf = mmap.mmap(-1, mmap.PAGESIZE,
                        prot=mmap.PROT_READ | mmap.PROT_WRITE | mmap.PROT_EXEC)
        buf.write(code)
        addr = ctypes.addressof(ctypes.c_char.from_buffer(buf))
        fn = ctypes.CFUNCTYPE(None, ctypes.POINTER(ctypes.c_uint32))(addr)
        out = ctypes.c_uint32(0)
        fn(ctypes.byref(out))
        del fn
        return int(out.value)
    except Exception:   # noqa: BLE001 - a probe must not die on this
        return None


def fp_state() -> dict:
    """The settings that could change an fp32 result in this process."""
    import torch

    st = {
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
        "mkldnn_enabled": bool(torch.backends.mkldnn.enabled),
        "mkldnn_available": bool(torch.backends.mkldnn.is_available()),
        "cpu_capability": torch.backends.cpu.get_cpu_capability(),
        "num_threads": torch.get_num_threads(),
    }
    mx = read_mxcsr()
    if mx is None:
        st["mxcsr"] = "not readable here"
    else:
        st["mxcsr"] = (f"0x{mx:04x} (rounding {(mx >> 13) & 3}, FTZ {(mx >> 15) & 1}, "
                       f"DAZ {(mx >> 6) & 1}; the calling thread's)")
    try:
        import jax

        st["jax_cpu_enable_async_dispatch"] = bool(
            jax.config.read("jax_cpu_enable_async_dispatch"))
    except Exception:   # noqa: BLE001
        st["jax_cpu_enable_async_dispatch"] = "jax not importable"
    return st


def exact_pairs(q: np.ndarray, pts: np.ndarray, r: float):
    """CSR of the pairs with exact (float64) d2 <= fp32(r^2), ascending by
    distance within a row, and each pair's right fp32 distance and d2."""
    r2 = float(np.float32(r * r))
    d2 = ((q[:, None, :].astype(np.float64) - pts[None, :, :].astype(np.float64)) ** 2).sum(-1)
    rows, cols = np.nonzero(d2 <= r2)
    dd = np.sqrt(d2[rows, cols].astype(np.float32))   # IEEE fp32 sqrt: correctly rounded
    order = np.lexsort((cols, dd, rows))
    rows, cols, dd = rows[order], cols[order], dd[order]
    indptr = np.zeros(q.shape[0] + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=q.shape[0]), out=indptr[1:])
    return indptr, cols.astype(np.int64), dd, d2


def check_side(name, got, want, d2):
    """Findings for one side's (indptr, indices, dists) against the exact
    ones: indptr, the pair set per row, then each distance bit for bit."""
    gi, gj, gd = got
    wi, wj, wd = want
    out = []
    if not np.array_equal(gi, wi):
        out.append(f"{name}: indptr differs in {int((gi != wi).sum())} of {gi.size} rows")
        return out
    m = gi.size - 1
    bad_sets = 0
    for i in range(m):
        a, b = gi[i], gi[i + 1]
        if not np.array_equal(np.sort(gj[a:b]), np.sort(wj[a:b])):
            bad_sets += 1
    if bad_sets:
        out.append(f"{name}: pair sets differ in {bad_sets} rows")
    rows = np.repeat(np.arange(m), np.diff(gi))
    right = np.sqrt(d2[rows, gj].astype(np.float32))
    off = np.nonzero(gd.view(np.uint32) != right.view(np.uint32))[0]
    if off.size:
        e = off[0]
        v = np.float32(gd[e])
        out.append(
            f"{name}: {off.size} of {gd.size} distances off; first at pair {e} "
            f"(query {rows[e]}, point {gj[e]}): got {v!r} (its square {np.float32(v * v)!r}, "
            f"1 - {1 - float(v) * float(v):.3e}), right {right[e]!r} from exact d2 "
            f"{d2[rows[e], gj[e]]!r}"
        )
    return out


def probe_once(seed_pts: int = 2000, seed_q: int = 2001, n: int = 2000, m: int = 150,
               d: int = 3) -> list:
    """One run, in the failing test's order: ``repro``'s oracle, then the
    port's on the CPU; returns the findings (empty: both sides exact)."""
    import torch

    from repro.core.dualtree import radius_brute as jax_radius_brute
    from repro_torch.core.dualtree import _pairwise_direct_d2, radius_brute

    pts = lattice(n, d, seed=seed_pts)
    q = lattice(m, d, seed=seed_q)
    jax_out = jax_radius_brute(q, pts, RADIUS)
    port_out = radius_brute(q, pts, RADIUS, device=torch.device("cpu"))
    want = exact_pairs(q, pts, RADIUS)
    d2 = want[3]
    findings = check_side("repro (JAX)", tuple(np.asarray(a) for a in jax_out), want[:3], d2)
    port = check_side("repro_torch", port_out, want[:3], d2)
    if port:
        # d2 before the sqrt, as the port computes it, for the same pairs
        qt = torch.from_numpy(q.copy())
        pt = torch.from_numpy(pts.copy())
        pd2 = _pairwise_direct_d2(qt, pt).numpy()
        wrong = int((pd2 != d2.astype(np.float32)).sum())
        port.append(f"repro_torch: its d2 before the sqrt differs from the exact d2 "
                    f"at {wrong} of {pd2.size} pairs")
    findings += port
    if findings:
        findings.append(f"state: {fp_state()}")
    return findings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=100)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))
    import jax

    # the test suite's setting (tests/conftest.py)
    jax.config.update("jax_cpu_enable_async_dispatch", False)
    print(f"state: {fp_state()}", flush=True)
    failed = {"repro (JAX)": 0, "repro_torch": 0}
    for rep in range(args.repeats):
        found = probe_once()
        for side in failed:
            if any(f.startswith(side + ":") for f in found):
                failed[side] += 1
        for line in found:
            print(f"[repeat {rep}] {line}", flush=True)
    print(f"repeats={args.repeats} jax_side_off={failed['repro (JAX)']} "
          f"port_side_off={failed['repro_torch']}", flush=True)
    return 1 if any(failed.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
