"""Engine protocol + registry (counterpart of ``repro.api.engine``).

An engine is one execution strategy for exact kNN.  It declares its
capabilities (``EngineCaps``) so the planner selects by constraint, and
implements ``build(points, spec, plan)``, ``query(state, queries, k)`` and
``resident_bytes(plan, state)``; engines declaring the dual-tree ops in
``caps.ops`` implement ``radius`` / ``kde`` / ``pair_count`` and
``warm_ops``; engines with a host-side snapshot implement
``snapshot_state`` / ``restore_state`` (``KNNIndex.save`` / ``load``);
engines declaring ``caps.mutable`` implement ``insert`` / ``delete`` (on
the others ``KNNIndex`` raises ``MutabilityError``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Type

import numpy as np

from repro_torch.core.lazysearch import SearchStats
from repro_torch.persist.format import PersistUnsupported

__all__ = [
    "Engine",
    "EngineBase",
    "EngineCaps",
    "KNOWN_OPS",
    "MutabilityError",
    "OpUnsupported",
    "PersistUnsupported",
    "StreamingUnsupported",
    "register_engine",
    "get_engine",
    "available_engines",
]

KNOWN_OPS = frozenset({"knn", "radius", "kde", "pair_count"})

class MutabilityError(TypeError):
    """``insert``/``delete`` on an engine with ``caps.mutable=False``."""


class StreamingUnsupported(TypeError):
    """``query_stream`` on an engine with ``caps.streaming=False``."""


class OpUnsupported(TypeError):
    """``radius``/``kde``/``pair_count`` on an engine that does not declare
    the op in ``caps.ops``."""


@dataclasses.dataclass(frozen=True)
class EngineCaps:
    """Static capability declaration used by the planner."""

    exact: bool = True
    out_of_core: bool = False
    multi_device: bool = False
    needs_build: bool = True
    stateful_query: bool = False  # query mutates state: one batch at a time
    mutable: bool = False       # incremental insert/delete
    device_parallel_mutable: bool = False  # insert/delete compose with
                                # placement over several devices
    streaming: bool = False
    batch_stream: bool = False  # query_stream delivers each batch whole
                                # (the mutable forest has no per-row
                                # retirement); KNNServer fronts it too
    ops: frozenset = frozenset({"knn"})
    description: str = ""


class EngineBase:
    """Base class for registered engines."""

    name: str = ""
    caps: EngineCaps = EngineCaps()

    def build(self, points: np.ndarray, spec, plan):
        raise NotImplementedError

    def query(
        self, state, queries: np.ndarray, k: int
    ) -> Tuple[np.ndarray, np.ndarray, SearchStats]:
        raise NotImplementedError

    def resident_bytes(self, plan, state=None) -> int:
        """Device bytes of the reference structure under ``plan`` (measured
        from ``state`` where the engine can)."""
        return plan.slab_bytes

    def warm(self, state, m: int, k: int) -> None:
        """Run the kNN path once for batches of ``m`` at ``k`` (the state's
        own ``warm`` where it has one)."""
        warm = getattr(state, "warm", None)
        if warm is not None:
            warm(m, k)

    def warm_ops(self, state, ops, m: Optional[int] = None, n_edges: int = 9) -> None:
        """Run the leaf-pair functions of the given non-kNN ops at their
        rung shapes (``m`` = expected query batch size, ``n_edges`` =
        expected pair_count edge count).  Default: nothing to warm."""
        return None

    def snapshot_state(self, state) -> Tuple[Dict[str, np.ndarray], dict]:
        """Serialize the built state: (flat {path: ndarray} map, JSON-able
        meta dict), what ``KNNIndex.save`` hands to ``repro_torch.persist``.
        Engines without a host-side snapshot raise the typed
        ``PersistUnsupported``."""
        raise PersistUnsupported(
            f"engine {self.name!r} has no snapshot representation; "
            "rebuild from source points on restart (docs/OPERATIONS.md)"
        )

    def restore_state(self, arrays: Dict[str, np.ndarray], meta: dict, spec, plan):
        """Reconstruct engine state from ``snapshot_state``'s output (or the
        reference's, the same format) on ``spec.devices[0]``, without the
        build-phase work that was persisted."""
        raise PersistUnsupported(
            f"engine {self.name!r} has no snapshot representation; "
            "rebuild from source points on restart (docs/OPERATIONS.md)"
        )


Engine = EngineBase

_REGISTRY: Dict[str, EngineBase] = {}


def register_engine(cls: Type[EngineBase]) -> Type[EngineBase]:
    """Class decorator: instantiate and register under ``cls.name``."""
    if not cls.name:
        raise ValueError(f"{cls.__name__} must set a non-empty .name")
    if cls.name in _REGISTRY:
        raise ValueError(f"engine {cls.name!r} already registered")
    _REGISTRY[cls.name] = cls()
    return cls


def get_engine(name: str) -> EngineBase:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown engine {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def available_engines(
    *, exact: Optional[bool] = None, out_of_core: Optional[bool] = None,
    multi_device: Optional[bool] = None, op: Optional[str] = None,
) -> Dict[str, EngineCaps]:
    """Registered engines, optionally filtered by capability or op."""
    if op is not None and op not in KNOWN_OPS:
        raise ValueError(f"unknown op {op!r}; known: {sorted(KNOWN_OPS)}")
    out = {}
    for name, eng in sorted(_REGISTRY.items()):
        c = eng.caps
        if exact is not None and c.exact != exact:
            continue
        if out_of_core is not None and c.out_of_core != out_of_core:
            continue
        if multi_device is not None and c.multi_device != multi_device:
            continue
        if op is not None and op not in c.ops:
            continue
        out[name] = c
    return out
