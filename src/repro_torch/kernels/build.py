"""Build and load the port's CUDA kernels (plain C interface + ctypes).

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library under ``build/kernels/`` at the repository root (listed in
``.gitignore``), named by a hash of the source, the flags and the
preprocessor defines, so an edited source rebuilds and an unchanged one
loads at once.  One source may be built into several libraries, one per
set of defines (the leaf scan builds one per instance width), and
``build_all`` runs their ``nvcc`` processes side by side.  Nothing is
built at import time: the first kernel call builds what it needs.  A
missing ``nvcc`` or a failed compile raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

__all__ = ["KernelLibrary", "load", "build_all", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

Spec = Tuple[str, Tuple[str, ...]]   # (source name, defines such as "X=1")


@dataclasses.dataclass
class KernelLibrary:
    """A loaded kernel library and how it was obtained."""

    name: str
    defines: Tuple[str, ...]
    path: Path
    lib: ctypes.CDLL
    build_s: float      # seconds its nvcc ran (0.0 when loaded from cache)
    ptxas_log: str      # nvcc -Xptxas -v output (registers, spills)


_LOADED: Dict[Spec, KernelLibrary] = {}
_BUILD_S: Dict[Spec, float] = {}
_LOAD_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
            "CUDA kernels are built from source at first use"
        )
    return found


def _output(spec: Spec) -> Path:
    name, defines = spec
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS + defines).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(spec: Spec) -> Optional[Tuple[subprocess.Popen, Path, float]]:
    out = _output(spec)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in spec[1]),
           "-o", str(tmp), str(CSRC / f"{spec[0]}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, time.perf_counter()


def _finish(spec: Spec, started) -> None:
    proc, tmp, t0 = started
    log = proc.communicate()[0]
    _BUILD_S[spec] = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {spec[0]}.cu with {spec[1]} (exit {proc.returncode}):\n{log}"
        )
    out = _output(spec)
    out.with_suffix(".ptxas.txt").write_text(log)
    os.replace(tmp, out)


def build_all(specs: Iterable[Spec]) -> float:
    """Build every missing library of ``specs`` at once (one nvcc each);
    returns the wall seconds it took."""
    t0 = time.perf_counter()
    specs = [(n, tuple(d)) for n, d in specs]
    started = [(s, _start(s)) for s in specs]
    errors = []
    for spec, st in started:
        if st is not None:
            try:
                _finish(spec, st)
            except RuntimeError as e:
                errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str, defines: Tuple[str, ...] = ()) -> KernelLibrary:
    """Build (if needed) and load ``csrc/<name>.cu`` with ``defines``;
    cached per process."""
    spec = (name, tuple(defines))
    if spec in _LOADED:
        return _LOADED[spec]
    # threads that launch at once (the mutable index's fan-out) would start
    # two nvcc runs writing the same temporary file: one builds, the others
    # wait and load its result
    with _LOAD_LOCK:
        if spec not in _LOADED:
            _LOADED[spec] = _load(spec)
    return _LOADED[spec]


def _load(spec: Spec) -> KernelLibrary:
    name = spec[0]
    st = _start(spec)
    if st is not None:
        _finish(spec, st)
    out = _output(spec)
    log_path = out.with_suffix(".ptxas.txt")
    return KernelLibrary(
        name=name, defines=spec[1], path=out, lib=ctypes.CDLL(str(out)),
        build_s=_BUILD_S.get(spec, 0.0),
        ptxas_log=log_path.read_text() if log_path.exists() else "",
    )
