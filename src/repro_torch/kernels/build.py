"""Build and load the port's CUDA kernels (plain C interface + ctypes).

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library under ``build/kernels/`` at the repository root (listed in
``.gitignore``), named by a hash of the source and the flags, so an edited
source rebuilds and an unchanged one loads at once.  Nothing is built at
import time: the first kernel call builds.  A missing ``nvcc`` or a failed
compile raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

__all__ = ["KernelLibrary", "load", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass
class KernelLibrary:
    """A loaded kernel library and how it was obtained."""

    name: str
    path: Path
    lib: ctypes.CDLL
    build_s: float      # seconds spent in nvcc (0.0 when loaded from cache)
    ptxas_log: str      # nvcc -Xptxas -v output (registers, shared memory)


_LOADED: Dict[str, KernelLibrary] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
            "CUDA kernels are built from source at first use"
        )
    return found


def load(name: str) -> KernelLibrary:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    if name in _LOADED:
        return _LOADED[name]
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"{name}-{digest}.so"
    log_path = out.with_suffix(".ptxas.txt")
    build_s = 0.0
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True,
        )
        build_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {src} (exit {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    loaded = KernelLibrary(
        name=name, path=out, lib=lib, build_s=build_s,
        ptxas_log=log_path.read_text() if log_path.exists() else "",
    )
    _LOADED[name] = loaded
    return loaded
