"""A mesh of device slots, the placement of a tensor on it by a spec, and
the collectives between its slots.

Counterpart of ``repro.compat.make_mesh`` / ``jax.sharding.Mesh`` with
``PartitionSpec`` placement, for the language model across slots.  A slot
is a position in the device list (``distributed/slots.py``):
``SlotMesh((cuda:0,) * 4, {"data": 2, "model": 2})`` lays four slots of
one card out as a 2 x 2 mesh, row-major like ``jax.make_mesh`` (slot =
data_index * 2 + model_index); ``(cpu,) * 4`` does the same on the CPU.

A **spec** is a tuple with one entry per tensor dimension: None
(replicated), an axis name, or a tuple of axis names (split over their
product, row-major); ``P(None, "model")`` in the reference is
``(None, "model")`` here, and a spec shorter than the tensor leaves the
trailing dimensions replicated.  A dimension that its axes do not divide
is split as GSPMD splits it: every shard ``ceil(n / parts)`` long but the
last ones, which are shorter (or empty).

The collectives (``all_sum``, ``all_gather``, ``reduce_scatter``,
``all_max``) take one tensor per slot of a group, in the group's order,
and return one per slot.  They are ``torch.autograd.Function``s, so the
backward of each is its transpose (all-sum <-> all-sum, all-gather <->
reduce-scatter), and every sum over slots, forward or backward, adds slot
0 first, then 1, ...: two runs give the same bits.  One Python thread
issues every slot's work on the current stream; a value moves between
slots by ``.to(device)`` (nothing on one card, where the slots' outputs
are views of one result).  ``torch.distributed`` is not used: NCCL refuses
two ranks on one GPU, and the reference is one controller too.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch

__all__ = ["SlotMesh", "Spec", "spec_axes", "split_bounds", "shard_slices", "shard_shape",
           "place", "gather", "all_sum", "all_gather", "reduce_scatter", "all_max", "reduce_to"]

Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (None: none)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def split_bounds(n: int, parts: int, i: int) -> Tuple[int, int]:
    """Shard ``i`` of ``parts`` of a dimension of length ``n``: GSPMD's
    ``ceil(n / parts)`` rows each, the last shards shorter or empty."""
    c = -(-n // parts)
    start = min(i * c, n)
    return start, min(start + c, n)


def _normalize(d: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current>``: a tensor's device always has its index."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class SlotMesh:
    """``devices`` (one per slot) laid out row-major over named axes."""

    def __init__(self, devices: Sequence, shape: Union[Mapping[str, int], Sequence[int]],
                 axis_names: Optional[Sequence[str]] = None):
        if isinstance(shape, Mapping):
            axis_names, sizes = tuple(shape), tuple(int(s) for s in shape.values())
        else:
            sizes = tuple(int(s) for s in shape)
            if axis_names is None or len(axis_names) != len(sizes):
                raise ValueError("give one axis name per mesh dimension")
        self.devices = tuple(_normalize(torch.device(d)) for d in devices)
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, sizes))
        if math.prod(sizes) != len(self.devices):
            raise ValueError(f"mesh shape {self.shape} needs {math.prod(sizes)} slots, "
                             f"got {len(self.devices)} devices")

    def __repr__(self) -> str:
        return f"SlotMesh({self.shape}, devices={[str(d) for d in self.devices]})"

    @property
    def size(self) -> int:
        return len(self.devices)

    def coords(self, slot: int) -> Dict[str, int]:
        out, rest = {}, slot
        for a in reversed(self.axis_names):
            out[a] = rest % self.shape[a]
            rest //= self.shape[a]
        return {a: out[a] for a in self.axis_names}

    def slot_of(self, coords: Mapping[str, int]) -> int:
        s = 0
        for a in self.axis_names:
            s = s * self.shape[a] + coords[a]
        return s

    def axis_size(self, axes: Sequence[str]) -> int:
        return math.prod(self.shape[a] for a in axes)

    def index_along(self, slot: int, axes: Sequence[str]) -> int:
        """The slot's row-major index over ``axes`` (in that order)."""
        c, i = self.coords(slot), 0
        for a in axes:
            i = i * self.shape[a] + c[a]
        return i

    def group(self, slot: int, axes: Sequence[str]) -> List[int]:
        """The slots that differ from ``slot`` only along ``axes``, ordered
        by their index along them."""
        axes = tuple(axes)
        base = self.coords(slot)
        out = []
        for i in range(self.axis_size(axes)):
            c, rest = dict(base), i
            for a in reversed(axes):
                c[a] = rest % self.shape[a]
                rest //= self.shape[a]
            out.append(self.slot_of(c))
        return out

    def groups(self, axes: Sequence[str]) -> List[List[int]]:
        """Every group along ``axes``, ordered by its first slot."""
        seen, out = set(), []
        for s in range(self.size):
            if s not in seen:
                g = self.group(s, axes)
                seen.update(g)
                out.append(g)
        return out


# --------------------------------------------------------------------------
# placement by spec
# --------------------------------------------------------------------------
def _entries(spec: Spec, ndim: int) -> list:
    spec = tuple(spec or ())
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's {ndim} dims")
    return list(spec) + [None] * (ndim - len(spec))


def shard_slices(shape: Sequence[int], spec: Spec, mesh: SlotMesh, slot: int) -> tuple:
    """The index (a tuple of slices) of ``slot``'s shard of a tensor of
    ``shape`` placed by ``spec``."""
    out = []
    for n, entry in zip(shape, _entries(spec, len(shape))):
        axes = spec_axes(entry)
        if not axes:
            out.append(slice(None))
            continue
        lo, hi = split_bounds(n, mesh.axis_size(axes), mesh.index_along(slot, axes))
        out.append(slice(lo, hi))
    return tuple(out)


def shard_shape(shape: Sequence[int], spec: Spec, mesh: SlotMesh, slot: int) -> Tuple[int, ...]:
    """The shape of ``slot``'s shard of a tensor of ``shape`` placed by ``spec``."""
    return tuple(len(range(*s.indices(n)))
                 for s, n in zip(shard_slices(shape, spec, mesh, slot), shape))


def place(full: torch.Tensor, spec: Spec, mesh: SlotMesh, dtype=None) -> List[torch.Tensor]:
    """One shard of ``full`` per slot (a copy of its own on its device)."""
    return [full[shard_slices(full.shape, spec, mesh, s)].to(
                device=mesh.devices[s], dtype=dtype or full.dtype, copy=True)
            for s in range(mesh.size)]


def gather(shards: Sequence[torch.Tensor], shape: Sequence[int], spec: Spec, mesh: SlotMesh,
           device=None) -> torch.Tensor:
    """The full tensor of ``shape`` from its per-slot ``shards``."""
    device = torch.device(device) if device is not None else shards[0].device
    full = torch.empty(tuple(shape), dtype=shards[0].dtype, device=device)
    done = set()
    for s, t in enumerate(shards):
        idx = shard_slices(shape, spec, mesh, s)
        key = tuple((x.start, x.stop) for x in idx)
        if key not in done:
            done.add(key)
            full[idx] = t.to(device)
    return full


# --------------------------------------------------------------------------
# collectives over the slots of one group
# --------------------------------------------------------------------------
def _sum_on(ts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """ts[0] + ts[1] + ... on ``device``, slot 0 first."""
    out = ts[0].to(device)
    for t in ts[1:]:
        out = out + t.to(device)
    return out


def _spread(t: torch.Tensor, devices: Sequence[torch.device]) -> tuple:
    """``t`` on every device: the tensor itself for the first, a view where
    a slot shares its device, a copy otherwise."""
    return tuple(t if i == 0 else (t.view_as(t) if d == t.device else t.to(d))
                 for i, d in enumerate(devices))


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, devices, *parts):
        ctx.devices = [p.device for p in parts]
        return _spread(_sum_on(parts, devices[0]), devices)

    @staticmethod
    def backward(ctx, *grads):
        total = _sum_on(grads, grads[0].device)
        return (None,) + tuple(total if d == total.device else total.to(d)
                               for d in ctx.devices)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, devices, *parts):
        ctx.dim, ctx.devices = dim, [p.device for p in parts]
        ctx.sizes = [p.shape[dim] for p in parts]
        full = torch.cat([p.to(devices[0]) for p in parts], dim=dim)
        return _spread(full, devices)

    @staticmethod
    def backward(ctx, *grads):
        total = _sum_on(grads, grads[0].device)
        pieces = torch.split(total, ctx.sizes, dim=ctx.dim)
        return (None, None) + tuple(g.to(d) for g, d in zip(pieces, ctx.devices))


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, devices, *parts):
        ctx.dim, ctx.devices = dim, [p.device for p in parts]
        total = _sum_on(parts, devices[0])
        n, k = total.shape[dim], len(parts)
        ctx.sizes = [hi - lo for lo, hi in (split_bounds(n, k, i) for i in range(k))]
        pieces = torch.split(total, ctx.sizes, dim=dim)
        return tuple(p.to(d) for p, d in zip(pieces, devices))

    @staticmethod
    def backward(ctx, *grads):
        full = torch.cat([g.to(grads[0].device) for g in grads], dim=ctx.dim)
        return (None, None) + tuple(full if d == full.device else full.to(d)
                                    for d in ctx.devices)


def all_sum(parts: Sequence[torch.Tensor], devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """Σ parts on every slot (the reference's ``psum``); its backward sums
    the slots' gradients the same way (Megatron's all-reduce, both ways)."""
    if len(parts) == 1:
        return [parts[0]]
    return list(_AllSum.apply(list(devices), *parts))


def all_gather(parts: Sequence[torch.Tensor], dim: int,
               devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """The parts concatenated along ``dim``, on every slot; backward: a
    reduce-scatter of the slots' gradients."""
    if len(parts) == 1:
        return [parts[0]]
    return list(_AllGather.apply(dim, list(devices), *parts))


def reduce_scatter(parts: Sequence[torch.Tensor], dim: int,
                   devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """Σ parts, split along ``dim`` (``split_bounds``): slot i gets piece
    i; backward: an all-gather of the pieces' gradients."""
    if len(parts) == 1:
        return [parts[0]]
    return list(_ReduceScatter.apply(dim, list(devices), *parts))


def all_max(parts: Sequence[torch.Tensor], devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """The elementwise max over the slots, on every slot (no gradient: a
    softmax's shift, or ``pmax`` of a quantization scale)."""
    with torch.no_grad():
        out = parts[0].detach().to(devices[0])
        for p in parts[1:]:
            out = torch.maximum(out, p.detach().to(devices[0]))
    return list(_spread(out, devices))


def reduce_to(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """Σ parts on one slot's ``device``, slot 0 first (plain autograd: each
    part's gradient is the result's)."""
    return _sum_on(parts, torch.device(device))
