"""Costs of a step counted while it runs, and their extrapolation over
layer groups (counterpart of ``repro.roofline.calibrate``).

The reference reads XLA's ``cost_analysis`` of compiled programs.  The
port counts a step as it runs, usually on ``meta`` tensors (shapes only:
nothing is allocated and nothing is computed):

  * **FLOPs** from ``torch.utils.flop_counter.FlopCounterMode``: matrix
    products, convolutions and attention only.  XLA's count also holds
    the elementwise work, so the port's is the smaller of the two.
  * **bytes accessed** from a ``TorchDispatchMode`` (``_OpMeter``) that
    adds each aten op's input and output bytes: op-by-op traffic with no
    fusion (a chain of elementwise ops reads and writes every intermediate,
    where a fused kernel would not), views and allocations counted as 0.
  * **peak live bytes**: the same mode adds the bytes of each storage an op
    creates and takes them off when the storage is freed (a weak-reference
    finalizer), and keeps the largest sum seen: the activation and
    temporary memory over what existed before the step (its arguments).
  * **collectives** from ``analysis.count_collectives``.

All four are divided by the mesh's slot count: per slot, as the
reference's per-device ``cost_analysis``.

One Python thread runs every slot's ops, and on ``meta`` tensors an
elementwise op's shape function runs in Python (``torch._refs``): a full
256-slot step would take minutes.  Two things keep it short:

  * ``_OpMeter`` memoizes the output shapes of functional (neither
    aliasing nor mutating) ops whose inputs are all on ``meta``: the slots
    of a mesh run the same ops at the same shapes, so the first slot
    computes each one's shape and the others reuse it;
  * ``calibrated_costs`` counts the step at G in {1, 2} layer groups and
    extrapolates to the true depth, costs being exactly linear in G:

    F_group = F(2) - F(1);   F0 = F(1) - F_group;   F(G) = F0 + G * F_group

PyTorch runs eagerly and has no scan, so nothing is counted once for many
trips: the extrapolation is only the way to keep a deep model's count
cheap (``tests/test_torch_roofline.py`` holds it equal to a direct count).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import weakref
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.roofline.analysis import CollectiveStats, count_collectives

__all__ = ["CellCosts", "OpCounts", "calibrated_costs", "count_ops", "extrapolate",
           "meta_memo", "temp_bytes_of"]

_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
               "lift_fresh", "_local_scalar_dense"}
_LEAF = (int, float, bool, str, type(None), torch.dtype, torch.device, torch.memory_format,
         torch.layout)


@dataclasses.dataclass
class OpCounts:
    """One counted run, per slot."""
    flops: float
    bytes: float
    temp_bytes: float            # peak live bytes created during the run
    coll: CollectiveStats
    ops: int                     # aten ops dispatched (all slots)
    memo_hits: int
    seconds: float


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _sig(x):
    """A hashable signature of an op argument on ``meta`` for the memo
    (TypeError for an argument it cannot key)."""
    if isinstance(x, torch.Tensor):
        return (x.shape, x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_sig(y) for y in x)
    if isinstance(x, _LEAF):
        return (type(x), x)
    raise TypeError(type(x))


def _tensors(args, kwargs) -> list:
    out = []
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(x for x in a if isinstance(x, torch.Tensor))
    return out


def _out_tensors(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [t for x in out for t in _out_tensors(x)]
    return []


@dataclasses.dataclass(frozen=True)
class _FuncInfo:
    flop_fn: object              # flop_counter's formula, or None
    decompose: bool              # no formula, a CompositeImplicitAutograd kernel
    view: bool                   # returns alias an input, nothing written
    mutable: bool
    inplace: Optional[tuple]     # in-place op: the argument each return is
    traffic: bool


def _func_info(func) -> _FuncInfo:
    from torch.utils.flop_counter import flop_registry

    schema = func._schema
    packet = func._overloadpacket
    flop_fn = flop_registry.get(packet)
    alias = any(r.alias_info is not None for r in schema.returns)
    inplace = None
    if schema.is_mutable and packet.__name__.endswith("_") and func._overloadname != "out":
        sets = [a.alias_info.before_set if a.alias_info is not None else None
                for a in schema.arguments]
        idx = []
        for r in schema.returns:
            hit = [i for i, st in enumerate(sets)
                   if r.alias_info is not None and st == r.alias_info.before_set]
            idx.append(hit[0] if len(hit) == 1 else None)
        if None not in idx and all(not str(r.type).startswith("Tensor[]")
                                   for r in schema.returns):
            inplace = tuple(idx)
    return _FuncInfo(
        flop_fn=flop_fn,
        decompose=flop_fn is None and torch._C._dispatch_has_kernel_for_dispatch_key(
            func.name(), torch._C.DispatchKey.CompositeImplicitAutograd),
        view=alias and not schema.is_mutable,
        mutable=schema.is_mutable,
        inplace=inplace,
        traffic=packet.__name__ not in _NO_TRAFFIC)


class _OpMeter(TorchDispatchMode):
    """FLOPs (``torch.utils.flop_counter``'s formulas, applied as
    ``FlopCounterMode`` applies them), bytes accessed, live bytes, and the
    memo of meta outputs."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.ops = 0
        self.hits = 0
        self._info: Dict[object, _FuncInfo] = {}
        self._memo: Dict[tuple, tuple] = {}
        self._tracked: set = set()

    def _free(self, key: int, nbytes: int) -> None:
        if key in self._tracked:
            self._tracked.discard(key)
            self.live -= nbytes

    def _track(self, tensors_in, tensors_out) -> None:
        seen = {t.untyped_storage()._cdata for t in tensors_in}
        for t in tensors_out:
            st = t.untyped_storage()
            k = st._cdata
            if k in seen or k in self._tracked:
                continue
            n = st.nbytes()
            self._tracked.add(k)
            self.live += n
            weakref.finalize(st, self._free, k, n)
        if self.live > self.peak:
            self.peak = self.live

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        info = self._info.get(func)
        if info is None:
            info = self._info[func] = _func_info(func)
        if info.decompose:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        self.ops += 1
        tin = _tensors(args, kwargs)
        on_meta = all(t.is_meta for t in tin)
        if info.view:
            return func(*args, **kwargs)
        if info.mutable:
            if on_meta and info.inplace is not None:
                # an in-place op on meta tensors changes nothing: its
                # returns are its mutated arguments
                out = tuple(args[i] if i < len(args) else
                            kwargs[func._schema.arguments[i].name] for i in info.inplace)
                out = out[0] if len(out) == 1 else (out or None)
            else:
                out = func(*args, **kwargs)
            if info.traffic:
                self.bytes += sum(_nbytes(t) for t in tin) + sum(
                    _nbytes(t) for t in _out_tensors(out))
            return out
        key = None
        if on_meta and tin:
            try:
                key = (func, _sig(args), _sig(tuple(kwargs.items())))
            except TypeError:
                key = None
        hit = self._memo.get(key) if key is not None else None
        if hit is not None:
            self.hits += 1
            leaves, spec, flops, nbytes = hit
            out = tree_unflatten([torch.empty_strided(m[0], m[1], dtype=m[2], device="meta")
                                  if m[0] is not None else m[3] for m in leaves], spec)
        else:
            out = func(*args, **kwargs)
            flops = info.flop_fn(*args, **kwargs, out_val=out) if info.flop_fn else 0
            nbytes = (sum(_nbytes(t) for t in tin) + sum(_nbytes(t) for t in _out_tensors(out))
                      if info.traffic else 0)
            if key is not None:
                leaves, spec = tree_flatten(out)
                self._memo[key] = ([(tuple(t.shape), t.stride(), t.dtype, None)
                                    if isinstance(t, torch.Tensor) else (None, None, None, t)
                                    for t in leaves], spec, flops, nbytes)
        self.flops += flops
        self.bytes += nbytes
        self._track(tin, _out_tensors(out))
        return out


@contextlib.contextmanager
def meta_memo():
    """The memo of ``_OpMeter`` alone (nothing is reported): for building a
    step's per-slot tensors on ``meta`` slots."""
    with _OpMeter():
        yield


def count_ops(fn: Callable[[], object], slots: int = 1) -> OpCounts:
    """Run ``fn()`` under the counters; every count per slot of a mesh of
    ``slots`` (``fn``'s result is dropped before the peak is read, so what
    it returns still counts as live at its end)."""
    t0 = time.perf_counter()
    meter = _OpMeter()
    with count_collectives(slots) as coll:
        with meter:
            fn()
    s = max(1, int(slots))
    return OpCounts(flops=meter.flops / s, bytes=meter.bytes / s,
                    temp_bytes=meter.peak / s, coll=coll.stats(), ops=meter.ops,
                    memo_hits=meter.hits, seconds=time.perf_counter() - t0)


@dataclasses.dataclass
class CellCosts:
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_detail: Dict
    points: Dict[int, Dict[str, float]]   # raw per-calibration-point values

    def as_dict(self):
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "coll_bytes_per_device": self.coll_bytes_per_device,
            "coll_detail": self.coll_detail,
            "points": {str(k): v for k, v in self.points.items()},
        }


def _costs_of(counts: OpCounts) -> Dict[str, float]:
    return {"flops": float(counts.flops), "bytes": float(counts.bytes),
            "temp_bytes": float(counts.temp_bytes), "seconds": counts.seconds}


def extrapolate(v1: float, v2: float, n_groups: int) -> float:
    """The value at ``n_groups`` of a quantity linear in the group count,
    from its values at 1 and 2 groups."""
    slope = v2 - v1
    return (v1 - slope) + n_groups * slope


def calibrated_costs(
    count_at_groups: Callable[[int], OpCounts],
    n_groups_true: int,
    *,
    scanned: bool = True,
) -> CellCosts:
    """``count_at_groups(g)`` must return the ``OpCounts`` of the same step
    with ``g`` layer groups (identical mesh and specs).

    With ``scanned=False`` (or one group) a single count at the true
    depth is taken directly.  ``points[g]`` also holds the peak live bytes
    (``temp_bytes``), which ``extrapolate`` carries to the true depth.
    """
    if not scanned or n_groups_true <= 1:
        c = count_at_groups(n_groups_true)
        return CellCosts(c.flops, c.bytes, float(c.coll.total), c.coll.as_dict(),
                         {n_groups_true: _costs_of(c)})

    points, colls = {}, {}
    for g in (1, 2):
        c = count_at_groups(g)
        points[g] = _costs_of(c)
        colls[g] = c.coll

    def extrap(v1: float, v2: float) -> float:
        return extrapolate(v1, v2, n_groups_true)

    flops = extrap(points[1]["flops"], points[2]["flops"])
    bytes_ = extrap(points[1]["bytes"], points[2]["bytes"])
    coll = extrap(float(colls[1].total), float(colls[2].total))
    detail = {
        "per_op_g2": colls[2].per_op,
        "count_g2": colls[2].count,
        "wire_ring_extrap": extrap(colls[1].wire_ring, colls[2].wire_ring),
    }
    return CellCosts(flops, bytes_, coll, detail, points)


def temp_bytes_of(costs: CellCosts, n_groups_true: int) -> Optional[float]:
    """The peak live bytes per slot at the true depth: the direct count, or
    the extrapolation of the G = 1 and G = 2 counts."""
    p = costs.points
    if len(p) == 1:
        return next(iter(p.values()))["temp_bytes"]
    return extrapolate(p[1]["temp_bytes"], p[2]["temp_bytes"], n_groups_true)
