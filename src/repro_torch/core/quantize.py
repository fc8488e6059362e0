"""Per-leaf affine quantization of leaf coordinate slabs.

A numpy copy of ``repro.core.quantize`` (the port imports nothing of the
JAX package); the codes match the reference bit for bit.  The port keeps
slab rows at the points' own width d where the reference pads them to a
multiple of 8: int8 codes, scales and offsets are the reference's without
its pad columns (whose scale is 0), and the fp16 ``eps`` lacks the 2^-24
that ``_fp16_eps`` adds per pad column.  ``pack_dead`` / ``unpack_dead``
are the bit-packed dead mask the quantized store keeps on the device and
the leaf scan reads.

The leaf structure is the only O(n d) device payload; storing it in fp16 or
int8 multiplies how many reference points fit a fixed ``memory_budget`` by
2x / 4x.  Exactness is preserved by the existing two-phase split: the scan
phase selects candidates from DEQUANTIZED coordinates, and the rank-merge /
finalize phase rescores the surviving candidate rows from the host-resident
fp32 ``tree.points`` (``lazysearch.finalize_candidates``) — so returned
indices and distances are computed at full precision.

Safety argument (why quantized traversal cannot *prune* a true neighbor):
let ``e = quant_eps`` bound the L2 reconstruction error per point,
``||x - x_hat|| <= e``.  Every quantized distance satisfies
``|d_hat(q, x) - d(q, x)| <= e``, so the true k-th neighbor distance is at
most ``d_hat_(k) + e`` where ``d_hat_(k)`` is the running k-th best
*quantized* distance.  Inflating the traversal radius by ``e`` therefore
keeps every leaf that could hold a true neighbor on the visit schedule.
In-leaf top-k selection by quantized distance can still swap candidates
whose true distances differ by less than ``2e``; the engines overfetch
(``k_eff = k + QUANT_OVERFETCH``) so the exact re-rank sees past that band.
That holds only while fewer than QUANT_OVERFETCH points lie in the band,
so the port proves each row's answer after the re-rank and searches the
rest again with ``QUANT_REFINE_OVERFETCH`` extra candidates
(``lazysearch.BufferKDTree.search``).

Generalizes the symmetric int8 scheme in ``training/compression.py`` to a
per-leaf, per-dimension affine code (offset = min, scale = range/255): leaf
slabs are spatially local by construction (a leaf is a k-d cell), so the
per-leaf range — hence the reconstruction error — is far tighter than any
global scale.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "PRECISIONS",
    "BYTES_PER_ELEM",
    "QUANT_OVERFETCH",
    "QUANT_REFINE_OVERFETCH",
    "QuantizedSlabs",
    "pack_dead",
    "quantize_slabs",
    "slab_dtype",
    "unpack_dead",
]

# Supported slab storage precisions (spec/plan vocabulary).
PRECISIONS = ("fp32", "fp16", "int8")

# Device bytes per slab element at each precision (planner cost model).
BYTES_PER_ELEM: Dict[str, int] = {"fp32": 4, "fp16": 2, "int8": 1}

# Extra candidates fetched per query under quantized scans; the exact fp32
# re-rank (finalize_candidates) then reduces back to the caller's k.  Covers
# the 2*eps selection band around the k-th distance (see module docstring).
QUANT_OVERFETCH = 8

# The port's second pass (``lazysearch.BufferKDTree.search``): rows whose
# first answer the quantization band leaves unproven run again with this
# many extra candidates.
QUANT_REFINE_OVERFETCH = 64

_UINT8_LEVELS = 255.0

# Rows carrying the PAD_COORD sentinel (1e18) in any dimension are padding
# baked into the slab itself (the dynamic forest's rung slabs pad to their
# capacity BEFORE the tree build, so ``leaf_sizes`` counts them as real).
# They must never enter a range fit — one sentinel row would blow an int8
# leaf's scale to ~4e15 — so they are detected and marked dead here.
_PAD_DETECT = 1.0e17


def pack_dead(dead: np.ndarray) -> np.ndarray:
    """Bit-packed dead mask: bool[n_leaves, L_pad] -> u8[n_leaves,
    ceil(L_pad/8)], row r of a leaf in bit 7 - (r % 8) of byte r // 8
    (``np.packbits`` big-endian, as the reference's ``device_meta``)."""
    return np.packbits(np.asarray(dead, bool), axis=1)


def unpack_dead(bits, l_pad: int):
    """Inverse of ``pack_dead`` for a torch u8[..., ceil(L_pad/8)] tensor:
    bool[..., L_pad], on the tensor's device."""
    import torch

    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=bits.device)
    unpacked = (bits[..., None] >> shifts) & 1
    return unpacked.reshape(*bits.shape[:-1], -1)[..., :l_pad].bool()


def slab_dtype(precision: str) -> np.dtype:
    if precision == "fp32":
        return np.dtype(np.float32)
    if precision == "fp16":
        return np.dtype(np.float16)
    if precision == "int8":
        return np.dtype(np.uint8)
    raise ValueError(f"precision={precision!r} not in {PRECISIONS}")


@dataclasses.dataclass
class QuantizedSlabs:
    """Quantized leaf structure: codes + per-leaf per-dim affine transform.

    ``codes`` is ``[n_leaves, leaf_pad, d_pad]`` in the storage dtype;
    dequantization is uniformly ``codes.astype(f32) * scale + offset`` for
    every precision (fp16 uses scale=1, offset=0, fp32 is the identity).
    ``dead`` marks rows that must never win a distance contest: structural
    pad rows (row >= leaf_size) and tombstoned rows.  ``eps`` is the global
    worst-case L2 reconstruction error (0 for fp32).
    """

    precision: str
    codes: np.ndarray    # [n_leaves, L_pad, d_pad] storage dtype
    scale: np.ndarray    # f32[n_leaves, d_pad]
    offset: np.ndarray   # f32[n_leaves, d_pad]
    dead: np.ndarray     # bool[n_leaves, L_pad]
    eps: float

    def to_arrays(self, prefix: str = "quant") -> Dict[str, np.ndarray]:
        """Flat array dict for snapshot persistence (see repro/persist)."""
        return {
            f"{prefix}/codes": self.codes,
            f"{prefix}/scale": self.scale,
            f"{prefix}/offset": self.offset,
            f"{prefix}/dead": self.dead,
            f"{prefix}/eps": np.asarray([self.eps], np.float64),
        }

    def reference_layout(self, multiple: int = 8) -> "QuantizedSlabs":
        """The codes and their scale and offset with feature columns padded
        to a ``multiple`` (at least one), as the reference lays them out in
        a snapshot: pad columns of code 0, scale 0 (int8) or 1 (fp16) and
        offset 0 dequantize to the zeros it stores."""

        def pad(a: np.ndarray, fill: float = 0.0) -> np.ndarray:
            d = a.shape[-1]
            width = max(multiple, -(-d // multiple) * multiple)
            if width == d:
                return np.asarray(a)
            cols = np.full(a.shape[:-1] + (width - d,), fill, a.dtype)
            return np.concatenate([a, cols], axis=-1)

        return dataclasses.replace(
            self, codes=pad(self.codes),
            scale=pad(self.scale, 1.0 if self.precision == "fp16" else 0.0),
            offset=pad(self.offset))

    @classmethod
    def from_arrays(
        cls, arrays, precision: str, prefix: str = "quant"
    ) -> "QuantizedSlabs":
        return cls(
            precision=precision,
            codes=np.asarray(arrays[f"{prefix}/codes"]),
            scale=np.ascontiguousarray(arrays[f"{prefix}/scale"], np.float32),
            offset=np.ascontiguousarray(arrays[f"{prefix}/offset"], np.float32),
            dead=np.ascontiguousarray(arrays[f"{prefix}/dead"], bool),
            eps=float(np.asarray(arrays[f"{prefix}/eps"]).reshape(-1)[0]),
        )


def _fp16_eps(slabs: np.ndarray, live: np.ndarray) -> float:
    """Worst-case L2 rounding error of a direct fp16 cast over live rows.
    fp16 carries 11 significand bits: |x - fp16(x)| <= |x| * 2^-11 (plus
    underflow at |x| < 2^-14, bounded by the smallest subnormal step)."""
    mags = np.where(live[..., None], np.abs(slabs), 0.0)
    per_dim = mags.max(axis=(0, 1)) * 2.0**-11 + 2.0**-24
    return float(np.sqrt(np.sum(per_dim.astype(np.float64) ** 2)))


def quantize_slabs(
    slabs: np.ndarray,
    precision: str,
    leaf_sizes: Optional[np.ndarray] = None,
) -> QuantizedSlabs:
    """Quantize padded leaf slabs ``[n_leaves, L_pad, d_pad]`` to ``precision``.

    ``leaf_sizes`` gives the REAL row count per leaf; rows at or beyond it
    (structural PAD_COORD padding) are excluded from the per-leaf range fit
    and marked dead — their codes are zeroed, and the scan-time dequantize
    masks them back to PAD_COORD.  Without ``leaf_sizes`` every row is
    treated as live (callers that pre-clean their slabs).
    """
    if precision not in PRECISIONS:
        raise ValueError(f"precision={precision!r} not in {PRECISIONS}")
    slabs = np.asarray(slabs, np.float32)
    if slabs.ndim != 3:
        raise ValueError(f"slabs must be [n_leaves, L_pad, d], got {slabs.shape}")
    n_leaves, l_pad, d_pad = slabs.shape
    if leaf_sizes is None:
        sizes = np.full((n_leaves,), l_pad, np.int64)
    else:
        sizes = np.asarray(leaf_sizes, np.int64)
        if sizes.shape != (n_leaves,):
            raise ValueError(
                f"leaf_sizes shape {sizes.shape} != ({n_leaves},)"
            )
    live = np.arange(l_pad)[None, :] < sizes[:, None]        # [n_leaves, L_pad]
    live &= ~(np.abs(slabs) >= _PAD_DETECT).any(axis=-1)     # sentinel rows
    dead = ~live

    if precision == "fp32":
        return QuantizedSlabs(
            precision,
            np.ascontiguousarray(slabs),
            np.ones((n_leaves, d_pad), np.float32),
            np.zeros((n_leaves, d_pad), np.float32),
            dead,
            0.0,
        )

    if precision == "fp16":
        codes = np.where(live[..., None], slabs, 0.0).astype(np.float16)
        return QuantizedSlabs(
            precision,
            np.ascontiguousarray(codes),
            np.ones((n_leaves, d_pad), np.float32),
            np.zeros((n_leaves, d_pad), np.float32),
            dead,
            _fp16_eps(slabs, live),
        )

    # int8 (uint8 codes): per-leaf per-dim affine over live rows only.
    masked = np.ma.MaskedArray(slabs, mask=np.broadcast_to(dead[..., None], slabs.shape))
    lo = np.ma.filled(masked.min(axis=1), 0.0).astype(np.float32)   # [n_leaves, d_pad]
    hi = np.ma.filled(masked.max(axis=1), 0.0).astype(np.float32)
    scale = (hi - lo) / np.float32(_UINT8_LEVELS)
    # degenerate dims (constant within the leaf, or empty leaf): scale 0 is
    # exact on dequantize (code * 0 + lo == lo) but unusable for encoding —
    # encode against a safe divisor instead
    enc_scale = np.where(scale > 0, scale, 1.0)
    codes = np.rint((slabs - lo[:, None, :]) / enc_scale[:, None, :])
    codes = np.clip(codes, 0.0, _UINT8_LEVELS).astype(np.uint8)
    codes = np.where(live[..., None], codes, np.uint8(0))
    # worst-case per-element error is scale/2 (round-to-nearest); eps is the
    # max over leaves of the per-leaf L2 bound
    per_leaf = 0.5 * np.sqrt(np.sum(scale.astype(np.float64) ** 2, axis=1))
    eps = float(per_leaf.max()) if per_leaf.size else 0.0
    return QuantizedSlabs(
        precision,
        np.ascontiguousarray(codes),
        np.ascontiguousarray(scale),
        np.ascontiguousarray(lo),
        dead,
        eps,
    )
