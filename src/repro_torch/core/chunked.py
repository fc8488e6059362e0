"""Chunked leaf-structure processing (paper §3): two device chunk buffers.

Counterpart of ``repro.core.chunked`` (fp32 store).  The leaf structure
stays on the host, in pinned memory; only two chunk-sized device slots
exist.  The paper's 3-phase pipeline per chunk j —

  (1) Brute: launch the scan on chunk j (non-blocking),
  (2) Copy : transfer chunk j+1 host->device into the slot not in use,
  (3) Wait : block on (1),

maps onto two CUDA streams: the consumer's compute runs on the current
stream, the copy of the next chunk on a side stream.  The ordering is
explicit in both directions, with events:

  * compute on a slot waits for that slot's copy (``ready`` event);
  * a copy into a slot waits until the compute that last read the slot
    has finished (``free`` event, recorded when the consumer asks for the
    next chunk).  JAX's immutable buffers gave this for free; on CUDA it
    is a write-after-read race without the event.

Chunks are leaf-aligned: chunk j owns leaves [chunk_lo[j], chunk_hi[j]).
``uniform=True`` pads the host array with PAD_COORD leaves (quantized
stores: code 0, scale 1, offset 0, dead) so every slab has the same shape.
The host slabs are pinned when they are streamed (N >= 2); on the CPU the
copies are plain copies.

``precision="fp16"`` / ``"int8"`` keep the slabs as codes
(``core/quantize.py``): float16, or uint8 with a per-leaf, per-feature
scale and offset; a ``QuantizedSlabs`` (a snapshot's, from
``quantized_state``) is adopted as it is.  Chunks of codes stream like fp32 chunks, at 1/2 or 1/4
of the bytes.  The dequantize metadata (int8 scale and offset, and the
bit-packed dead-row mask of every leaf) is uploaded once and stays
resident (``device_meta``); the leaf scan reads the codes and the metadata
itself, so no fp32 copy of a chunk is ever made on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.quantize import (
    PRECISIONS,
    QuantizedSlabs,
    pack_dead,
    quantize_slabs,
)
from repro_torch.kernels.ops import PAD_COORD, resolve_device

__all__ = ["ChunkedLeafStore"]


@dataclasses.dataclass
class _Slot:
    chunk_id: int = -1
    buf: Optional[torch.Tensor] = None
    ready: Optional[torch.cuda.Event] = None   # copy into buf finished
    free: Optional[torch.cuda.Event] = None    # last compute reading buf finished


class ChunkedLeafStore:
    """Host-resident padded leaf structure streamed through two device
    slots; ``n_chunks == 1`` keeps the whole structure device-resident."""

    def __init__(
        self,
        leaf_slabs,
        n_chunks: int = 1,
        *,
        device=None,
        uniform: bool = False,
        precision: str = "fp32",
        leaf_sizes: Optional[np.ndarray] = None,
    ):
        adopted = isinstance(leaf_slabs, QuantizedSlabs)
        if adopted:
            precision = leaf_slabs.precision
        elif leaf_slabs.ndim != 3:
            raise ValueError(
                f"leaf_slabs must be [n_leaves, leaf_pad, d], got {leaf_slabs.shape}"
            )
        if precision not in PRECISIONS or (adopted and precision == "fp32"):
            raise ValueError(f"precision={precision!r} not in {PRECISIONS}"
                             + (" (adopted codes are fp16 or int8)" if adopted else ""))
        self.precision = precision
        self.quantized = precision != "fp32"
        if self.quantized:
            # adopted codes (a snapshot's) are kept as they are: quantizing
            # the restored points again would re-fit the scales
            qs = leaf_slabs if adopted else quantize_slabs(leaf_slabs, precision, leaf_sizes)
            host, scale, offset, dead = qs.codes, qs.scale, qs.offset, qs.dead
            self.quant_eps = float(qs.eps)
        else:
            host = np.ascontiguousarray(leaf_slabs, np.float32)
            scale = offset = dead = None
            self.quant_eps = 0.0
        self.n_leaves = host.shape[0]
        self.device = resolve_device(device)
        n_chunks = int(n_chunks)
        if not 1 <= n_chunks <= self.n_leaves:
            raise ValueError(f"n_chunks={n_chunks} out of range [1, {self.n_leaves}]")
        self.n_chunks = n_chunks
        self.uniform = bool(uniform)
        if self.uniform:
            c = -(-self.n_leaves // n_chunks)
            extra = c * n_chunks - self.n_leaves
            if extra:
                fill = 0 if self.quantized else np.float32(PAD_COORD)
                pad = np.full((extra,) + host.shape[1:], fill, host.dtype)
                host = np.concatenate([host, pad], axis=0)
                if self.quantized:
                    scale = np.concatenate(
                        [scale, np.ones((extra, scale.shape[1]), np.float32)])
                    offset = np.concatenate(
                        [offset, np.zeros((extra, offset.shape[1]), np.float32)])
                    dead = np.concatenate(
                        [dead, np.ones((extra, dead.shape[1]), bool)])
            self.chunk_leaves = c
            lo = np.arange(n_chunks, dtype=np.int64) * c
            self.chunk_lo = lo
            self.chunk_hi = np.minimum(lo + c, self.n_leaves)
        else:
            bounds = np.ceil(
                np.arange(n_chunks + 1) * self.n_leaves / n_chunks
            ).astype(np.int64)
            self.chunk_lo = bounds[:-1]
            self.chunk_hi = bounds[1:]
            self.chunk_leaves = int((self.chunk_hi - self.chunk_lo).max())
        self._cuda = self.device.type == "cuda"
        self.host = torch.from_numpy(host)
        if self._cuda and n_chunks > 1:
            self.host = self.host.pin_memory()
        # host copies of the dequantize metadata (None for fp32 stores)
        self.q_scale, self.q_offset, self.dead = scale, offset, dead
        self._meta: Optional[Tuple] = None
        if self.quantized:
            def up(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

            self._meta = (
                up(scale) if self.affine else None,
                up(offset) if self.affine else None,
                up(pack_dead(dead)),
            )
        self._slots = (_Slot(), _Slot())
        self._copy_stream = (
            torch.cuda.Stream(self.device) if self._cuda and n_chunks > 1 else None
        )
        self.copies = 0   # host->device chunk transfers issued (lifetime)
        self._resident: Optional[torch.Tensor] = None
        if n_chunks == 1:
            self._resident = self.host.to(self.device)

    # -- chunk metadata -----------------------------------------------------
    def chunk_of_leaf(self, leaf: np.ndarray) -> np.ndarray:
        """Chunk id owning each leaf (leaf-aligned chunks)."""
        return np.searchsorted(self.chunk_hi, np.asarray(leaf), side="right").astype(np.int32)

    def chunk_leaf_range(self, j: int) -> Tuple[int, int]:
        """Real leaves owned by chunk j (traversal targets)."""
        return int(self.chunk_lo[j]), int(self.chunk_hi[j])

    def _slab_range(self, j: int) -> Tuple[int, int]:
        lo = int(self.chunk_lo[j])
        if self.uniform:
            return lo, lo + self.chunk_leaves
        return lo, int(self.chunk_hi[j])

    @property
    def chunk_bytes(self) -> int:
        lo, hi = self._slab_range(0)
        return int((hi - lo) * self.host.shape[1] * self.host.shape[2]
                   * self.host.element_size())

    # -- quantization metadata ---------------------------------------------
    @property
    def affine(self) -> bool:
        """True when dequantize needs the per-leaf scale/offset (int8);
        fp16 is a plain cast and keeps only the dead mask resident."""
        return self.precision == "int8"

    def device_meta(self) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], torch.Tensor]:
        """Device-resident dequantize metadata ``(scale f32[L, d], offset
        f32[L, d], dead u8[L, ceil(L_pad/8)])`` over every leaf of the
        (padded) store, uploaded once at construction; scale and offset are
        None for fp16.  Only quantized stores have it."""
        if self._meta is None:
            raise ValueError("an fp32 store has no dequantize metadata")
        return self._meta

    def meta_bytes(self) -> int:
        """Device bytes of the dequantize metadata (0 for fp32 stores):
        the packed dead mask, plus scale/offset for int8 stores."""
        if not self.quantized:
            return 0
        packed = self.dead.shape[0] * (-(-self.dead.shape[1] // 8))
        if not self.affine:
            return packed
        return int(self.q_scale.nbytes + self.q_offset.nbytes) + packed

    def kill_rows(self, leaf_ids, rows) -> None:
        """Disable slab rows ``(leaf_ids[i], rows[i])`` for good, so they
        never again win a distance contest (the tombstone reclaim of the
        mutable index's tree shards, ``core/dynamic.py``).  fp32 stores
        write PAD_COORD into the rows of the host slab and, in place, of
        the resident device slab (no upload of the slab); a chunk slot
        holding one of the rows' chunks is invalidated, so the next visit
        copies it again.  Code stores flip the dead mask and rewrite only
        the affected leaves' rows of the resident packed mask, in place:
        the engines hold that tensor (``device_meta``)."""
        leaf_ids = np.asarray(leaf_ids, np.int64).ravel()
        rows = np.asarray(rows, np.int64).ravel()
        if leaf_ids.size == 0:
            return
        if self.quantized:
            self.dead[leaf_ids, rows] = True
            touched = np.unique(leaf_ids)
            packed = torch.from_numpy(pack_dead(self.dead[touched]))
            self._meta[2][torch.from_numpy(touched).to(self.device)] = packed.to(self.device)
            return
        pad = float(PAD_COORD)
        self.host[torch.from_numpy(leaf_ids), torch.from_numpy(rows)] = pad
        if self._resident is not None:
            self._resident[torch.from_numpy(leaf_ids).to(self.device),
                           torch.from_numpy(rows).to(self.device)] = pad
        chunks = set(self.chunk_of_leaf(leaf_ids).tolist())
        for slot in self._slots:
            if slot.chunk_id in chunks:
                slot.chunk_id = -1

    def quantized_state(self) -> QuantizedSlabs:
        """Snapshot view of a quantized store: codes, scale, offset and dead
        mask of the real leaves (the uniform chunk padding is made again
        when a store adopts it), and eps."""
        if not self.quantized:
            raise ValueError("an fp32 store has no codes to snapshot")
        n = self.n_leaves
        return QuantizedSlabs(self.precision, self.host[:n].numpy(), self.q_scale[:n],
                              self.q_offset[:n], self.dead[:n], self.quant_eps)

    # -- streaming ----------------------------------------------------------
    def _copy_chunk(self, j: int, slot: _Slot) -> None:
        """Phase (2): host->device transfer of chunk j into ``slot``, on the
        side stream, after the last compute that read the slot."""
        lo, hi = self._slab_range(j)
        src = self.host[lo:hi]
        if slot.buf is None or slot.buf.shape != src.shape:
            slot.buf = torch.empty(src.shape, dtype=src.dtype, device=self.device)
        if self._copy_stream is None:
            slot.buf.copy_(src)
        else:
            if slot.free is not None:
                self._copy_stream.wait_event(slot.free)
            with torch.cuda.stream(self._copy_stream):
                slot.buf.copy_(src, non_blocking=True)
                slot.ready = torch.cuda.Event()
                slot.ready.record(self._copy_stream)
        slot.chunk_id = j
        self.copies += 1

    def stream(self, chunk_ids: Sequence[int]) -> Iterator[Tuple[int, torch.Tensor, int]]:
        """Yield ``(chunk_id, device_slab, leaf_lo)`` per requested chunk,
        double-buffered: the copy of chunk_ids[i+1] is issued before the
        consumer computes on chunk_ids[i]."""
        if self.n_chunks == 1:
            for j in chunk_ids:
                yield j, self._resident, 0
            return
        chunk_ids = list(chunk_ids)
        if not chunk_ids:
            return
        if self._slots[0].chunk_id != chunk_ids[0]:
            self._copy_chunk(chunk_ids[0], self._slots[0])
        cur = 0
        for i, j in enumerate(chunk_ids):
            slot = self._slots[cur]
            nxt = self._slots[1 - cur]
            if i + 1 < len(chunk_ids) and nxt.chunk_id != chunk_ids[i + 1]:
                self._copy_chunk(chunk_ids[i + 1], nxt)
            if self._cuda and slot.ready is not None:
                torch.cuda.current_stream(self.device).wait_event(slot.ready)
            lo, _ = self.chunk_leaf_range(j)
            try:
                yield j, slot.buf, lo
            finally:
                if self._cuda:
                    slot.free = torch.cuda.Event()
                    slot.free.record(torch.cuda.current_stream(self.device))
            cur = 1 - cur

    def resident_bytes(self) -> int:
        """Device bytes held by the store (two slots, or full structure),
        including the dequantize metadata of quantized stores."""
        if self.n_chunks == 1:
            return int(self.host.numel() * self.host.element_size()) + self.meta_bytes()
        return 2 * self.chunk_bytes + self.meta_bytes()
