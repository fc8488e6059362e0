"""Seeded, env-gated fault injection for the index lifecycle.

Counterpart of ``repro.faults`` (host code, the port's own copy; the
registry names every injection point of the reference, so the modules
still to be ported fire the same names).

The crash-safety story (persist/ snapshots + WAL, background merges,
multi-device placement) is only as good as its failure testing.  This
module provides *injection points*: named call sites threaded through
``core/dynamic.py``, ``distributed/dynamic_shards.py``,
``training/checkpoint.py``, ``persist/`` and ``serving/knn_server.py``
(the ``serve.*`` points) that normally cost one global
boolean check, and that a chaos test (or an operator drill, via env vars)
can arm to raise a typed fault at a precise boundary:

    faults.arm("wal.torn", after=2)        # 2nd WAL append tears mid-record
    faults.arm("device.scan", device_index=1, sticky=True)   # device 1 dies

Design rules:
  * **zero overhead when disarmed** — ``fire()`` is a single module-global
    check before touching any lock, so production code paths pay ~nothing;
  * **typed faults** — ``SimulatedCrash`` (kill-points: the process state
    is assumed lost), ``DeviceLost`` (a device stops answering; the
    dynamic engine degrades instead of raising), plain ``FaultError``
    (component failure, e.g. a merge worker exception);
  * **deterministic** — faults trigger on exact hit counts (``after=``),
    never on wall-clock or randomness; the CI chaos leg derives the armed
    point/count from ``REPRO_FAULT_SEED`` so a failing seed replays.

Env gating (for drills / CI, programmatic ``arm()`` preferred in tests):
    REPRO_FAULTS="wal.torn:2,device.scan:1:sticky"
        comma list of ``point[:after][:sticky]`` specs, applied at the
        first ``load_env()`` call (``repro_torch.persist`` calls it on
        import).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

__all__ = [
    "FaultError",
    "SimulatedCrash",
    "DeviceLost",
    "INJECTION_POINTS",
    "arm",
    "disarm",
    "reset",
    "fire",
    "hits",
    "count_hits",
    "load_env",
]


class FaultError(RuntimeError):
    """Base class for injected faults (also raised for component faults)."""


class SimulatedCrash(FaultError):
    """A kill-point fired: treat the in-process object as lost.

    Chaos tests abandon the live index when they catch this and recover
    via ``KNNIndex.load`` — exactly what a process restart would do.
    """


class DeviceLost(FaultError):
    """A device stopped answering mid-scan.

    Carries ``device`` (the device object, attached at the fan-out
    site) so ``DynamicIndex`` can re-place that device's shards onto the
    survivors instead of propagating the error.
    """

    def __init__(self, msg: str, device: Any = None, device_index: Optional[int] = None):
        super().__init__(msg)
        self.device = device
        self.device_index = device_index


#: Every injection point threaded through the codebase.  ``fire()`` on an
#: unknown point raises — typos must not silently never fire.
INJECTION_POINTS = (
    "wal.append",       # before a WAL record hits the file (record lost whole)
    "wal.torn",         # mid-record: a prefix of the frame lands, then crash
    "persist.slab_write",   # before snapshot arrays are written (empty tmp dir)
    "persist.commit",   # after manifest write, before the atomic rename
    "checkpoint.write", # CheckpointManager._write: after arrays, before manifest
    "merge.build",      # background carry merge, during the staging build
    "merge.swap",       # background carry merge, just before the atomic swap
    "device.scan",      # per-device query fan-out -> DeviceLost for that device
    "serve.launch",     # KNNServer batch launch crashes before the query runs
    "serve.stream",     # mid-stream failure: some rows delivered, then DeviceLost
    "serve.stall",      # the scheduler's policy step dies (watchdog fail-fast)
)


@dataclass
class _Armed:
    after: int = 1          # fire on the Nth matching hit
    sticky: bool = False    # keep firing on every later matching hit
    exc: Optional[BaseException] = None  # override the default fault type
    match: Dict[str, Any] = field(default_factory=dict)  # ctx filters (e.g. device_index)
    seen: int = 0


_mu = threading.Lock()
_armed: Dict[str, _Armed] = {}
_hits: Dict[str, int] = {}
_counting = False
# Fast-path gate: True only while something is armed or hit-counting is on.
_active = False


def _default_exc(point: str, ctx: Dict[str, Any]) -> BaseException:
    if point in ("device.scan", "serve.stream"):
        return DeviceLost(
            f"injected device loss at {point!r}",
            device=ctx.get("device"),
            device_index=ctx.get("device_index"),
        )
    if point.startswith(("wal.", "persist.", "checkpoint.")):
        return SimulatedCrash(f"injected crash at {point!r}")
    return FaultError(f"injected fault at {point!r}")


def arm(
    point: str,
    *,
    after: int = 1,
    sticky: bool = False,
    exc: Optional[BaseException] = None,
    **match: Any,
) -> None:
    """Arm ``point`` to raise on its ``after``-th matching ``fire()``.

    ``match`` keys are compared against the ``fire()`` context (a hit
    only counts when every match key is present and equal), e.g.
    ``arm("device.scan", device_index=2, sticky=True)``.
    """
    global _active
    if point not in INJECTION_POINTS:
        raise ValueError(f"unknown injection point {point!r}")
    if after < 1:
        raise ValueError("after must be >= 1")
    with _mu:
        _armed[point] = _Armed(after=after, sticky=sticky, exc=exc, match=dict(match))
        _active = True


def disarm(point: Optional[str] = None) -> None:
    global _active
    with _mu:
        if point is None:
            _armed.clear()
        else:
            _armed.pop(point, None)
        _active = bool(_armed) or _counting


def reset() -> None:
    """Disarm everything and clear hit counters (test teardown)."""
    global _active, _counting
    with _mu:
        _armed.clear()
        _hits.clear()
        _counting = False
        _active = False


def count_hits(enable: bool = True) -> None:
    """Enable hit counting even with nothing armed (used by the chaos
    harness to enumerate how many crash boundaries a workload has)."""
    global _active, _counting
    with _mu:
        _counting = enable
        _active = bool(_armed) or _counting


def hits(point: str) -> int:
    with _mu:
        return _hits.get(point, 0)


def fire(point: str, **ctx: Any) -> None:
    """Injection call site.  No-op (one global read) unless armed."""
    if not _active:
        return
    with _mu:
        if _counting:
            _hits[point] = _hits.get(point, 0) + 1
        spec = _armed.get(point)
        if spec is None:
            return
        for key, want in spec.match.items():
            if key not in ctx or ctx[key] != want:
                return
        spec.seen += 1
        if spec.seen < spec.after:
            return
        if not spec.sticky:
            del _armed[point]
            _update_active_locked()
        exc = spec.exc if spec.exc is not None else _default_exc(point, ctx)
    raise exc


def _update_active_locked() -> None:
    global _active
    _active = bool(_armed) or _counting


_env_loaded = False


def load_env() -> None:
    """Apply ``REPRO_FAULTS`` once (idempotent).  Malformed specs raise —
    a drill that silently arms nothing is worse than a crash."""
    global _env_loaded
    if _env_loaded:
        return
    _env_loaded = True
    raw = os.environ.get("REPRO_FAULTS", "").strip()
    if not raw:
        return
    for item in raw.split(","):
        parts = item.strip().split(":")
        point = parts[0]
        after = 1
        sticky = False
        for p in parts[1:]:
            if p == "sticky":
                sticky = True
            else:
                after = int(p)
        arm(point, after=after, sticky=sticky)
