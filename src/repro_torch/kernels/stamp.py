"""Phase stamps and work tallies on the card: the wrapper of ``csrc/stamp.cu``.

``stamp_cuda(clock, phase)`` launches one thread on the current stream that
adds the nanoseconds since the previous stamp (``clock[0]``) into
``clock[phase]`` (phase >= 1) and sets ``clock[0]`` to the card's clock;
phase 0 only sets ``clock[0]``.  ``clock`` is a contiguous i64 CUDA tensor
of 1 + phases entries.

``tally_cuda(log, leaf, leaf_size, n_units, rounds)`` adds one round's leaf
visits (``leaf >= 0``), their pairs (Σ ``leaf_size[leaf]``) and
``n_units`` into row min(``rounds``, rows - 1) of ``log`` i64[rows, 3].

A CUDA graph captures either launch, so every replay stamps and counts;
``launches`` counts the launches that passed these wrappers (the eager
rounds and the captures, not the replays), by kernel.
``kernels/ops.py::stamp`` / ``tally`` pick these or the host by the device.

``trace_bounds`` lays the stamps over a device trace of the rounds (a
``torch.profiler`` trace of the card), to check what they measured
against the trace's own timestamps of the kernels between them.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Iterable, Tuple

import numpy as np
import torch

from repro_torch.kernels import build

__all__ = ["stamp_cuda", "tally_cuda", "trace_bounds", "launches", "reset_launches"]

launches = {"stamp": 0, "tally": 0}
_COUNT_LOCK = threading.Lock()


def reset_launches() -> None:
    with _COUNT_LOCK:
        launches.update(stamp=0, tally=0)


def _lib() -> ctypes.CDLL:
    lib = build.load("stamp").lib
    if not getattr(lib, "_argtypes_set", False):
        lib.stamp.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        lib.stamp.restype = ctypes.c_int
        lib.tally.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                              ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_void_p, ctypes.c_void_p]
        lib.tally.restype = ctypes.c_int
        lib.stamp_error_string.argtypes = [ctypes.c_int]
        lib.stamp_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _launched(lib, kernel: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed ({err}): "
                           f"{lib.stamp_error_string(err).decode()}")
    with _COUNT_LOCK:
        launches[kernel] += 1


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, device) -> None:
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor on {device}, got "
                         f"{t.dtype} on {t.device}")


def stamp_cuda(clock: torch.Tensor, phase: int) -> None:
    if clock.device.type != "cuda":
        raise ValueError(f"clock must be a CUDA tensor, got one on {clock.device}")
    _check("clock", clock, torch.int64, clock.device)
    if not 0 <= phase < clock.numel():
        raise ValueError(f"phase {phase} outside a clock of {clock.numel()} entries")
    lib = _lib()
    err = lib.stamp(clock.data_ptr(), phase, torch.cuda.current_stream(clock.device).cuda_stream)
    _launched(lib, "stamp", err)


def tally_cuda(log: torch.Tensor, leaf: torch.Tensor, leaf_size: torch.Tensor,
               n_units: torch.Tensor, rounds: torch.Tensor) -> None:
    dev = log.device
    if dev.type != "cuda":
        raise ValueError(f"log must be a CUDA tensor, got one on {dev}")
    _check("log", log, torch.int64, dev)
    if log.dim() != 2 or log.shape[1] != 3:
        raise ValueError(f"log must be i64[rows, 3], got {tuple(log.shape)}")
    _check("leaf", leaf, torch.int32, dev)
    _check("leaf_size", leaf_size, torch.int32, dev)
    for name, t in (("n_units", n_units), ("rounds", rounds)):
        _check(name, t, torch.int32, dev)
        if t.numel() != 1:
            raise ValueError(f"{name} must hold one value, got {t.numel()}")
    lib = _lib()
    err = lib.tally(log.data_ptr(), log.shape[0], leaf.data_ptr(), leaf.numel(),
                    leaf_size.data_ptr(), n_units.data_ptr(), rounds.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream)
    _launched(lib, "tally", err)


def trace_bounds(events: Iterable[Tuple[str, int, int]], stamps_per_round: int = 5
                 ) -> np.ndarray:
    """Each stamped phase's bounds in a device trace of whole rounds.

    ``events``: the trace's device activities on the rounds' stream as
    (name, start ns, end ns), the stamp kernels among them (their name holds
    ``stamp_kernel``), ``stamps_per_round`` to a round.  Returns f64[2,
    rounds, stamps_per_round - 1] seconds: for each round and phase, [0] the
    span of the activities between the phase's two stamps, from the first's
    start to the last's end (the gaps between them included; 0 with none),
    and [1] the span from the earlier stamp's start to the later stamp's
    end.  A stamp reads the clock between its own start and end, after
    the phase's last activity and before the next phase's first, so the
    time it adds to a phase lies between the two."""
    ev = sorted(events, key=lambda e: e[1])
    at = [i for i, e in enumerate(ev) if "stamp_kernel" in e[0]]
    if not at or len(at) % stamps_per_round:
        raise ValueError(f"{len(at)} stamps are not whole rounds of {stamps_per_round}")
    out = np.zeros((2, len(at) // stamps_per_round, stamps_per_round - 1))
    for r in range(out.shape[1]):
        mine = at[r * stamps_per_round: (r + 1) * stamps_per_round]
        for p, (a, b) in enumerate(zip(mine, mine[1:])):
            own = ev[a + 1: b]
            if own:
                out[0, r, p] = (max(e[2] for e in own) - own[0][1]) / 1e9
            out[1, r, p] = (ev[b][2] - ev[a][1]) / 1e9
    return out
