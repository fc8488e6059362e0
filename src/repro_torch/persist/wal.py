"""Mutation write-ahead log: framed, checksummed, torn-tail tolerant.

Record frame (little-endian)::

    u32 magic ("WAL1")  u64 seq  u8 op  u32 payload_len  u32 crc32(payload)
    payload_len bytes   # the batch array, ``np.save`` encoding

``seq`` is the index's monotonically increasing mutation counter: the
N-th acknowledged ``insert``/``delete`` since build carries seq N-1.  A
snapshot manifest records ``mutation_seq`` = number of mutations it
contains; restore replays exactly the records with ``seq >=
mutation_seq`` — so a crash *between* committing a snapshot and rotating
the log can never double-apply a batch.

Segments: ``wal_<startseq>.log`` files; ``rotate(seq)`` starts a fresh
segment at each snapshot so ``gc(min_seq)`` can drop whole files once no
retained snapshot needs them.

Torn tails: a crash mid-``append`` leaves a partial frame at the end of
the *last* segment.  ``replay`` stops cleanly at the first bad frame of
the final segment (a bad frame in an earlier segment is real corruption
and raises); opening the log for append truncates the torn bytes so new
records never land after garbage.

Durability: each ``append`` flushes and (by default) fsyncs before the
mutation is acknowledged.  ``fsync=False`` trades the crash-durability
of the last few batches for mutation latency (page-cache-only writes).
"""

from __future__ import annotations

import io
import os
import re
import struct
import threading
import zlib
from typing import List, Optional, Tuple

import numpy as np

from repro_torch import faults
from repro_torch.persist.format import PersistError, fsync_dir

__all__ = ["WriteAheadLog", "OPS"]

_MAGIC = 0x57414C31  # "WAL1"
_HEADER = struct.Struct("<IQBII")  # magic, seq, op, payload_len, crc32

OPS = {"insert": 1, "delete": 2}
_OP_NAMES = {v: k for k, v in OPS.items()}

_SEG_RE = re.compile(r"^wal_(\d{12})\.log$")


def _encode(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(arr), allow_pickle=False)
    return buf.getvalue()


def _decode(payload: bytes) -> np.ndarray:
    return np.load(io.BytesIO(payload), allow_pickle=False)


class WriteAheadLog:
    def __init__(self, root: str, *, fsync: bool = True):
        self.root = root
        self.fsync = fsync
        self._mu = threading.Lock()
        self._fh = None  # active segment handle, opened lazily
        os.makedirs(root, exist_ok=True)
        if not self._segments():
            self._create_segment(0)
        else:
            self._truncate_torn_tail()

    # -- segments ------------------------------------------------------
    def _segments(self) -> List[int]:
        out = []
        for name in os.listdir(self.root):
            m = _SEG_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def _seg_path(self, start: int) -> str:
        return os.path.join(self.root, f"wal_{start:012d}.log")

    def _create_segment(self, start: int) -> None:
        path = self._seg_path(start)
        with open(path, "ab") as f:
            f.flush()
            os.fsync(f.fileno())
        fsync_dir(self.root)

    def _open_active(self):
        if self._fh is None:
            self._fh = open(self._seg_path(self._segments()[-1]), "ab")
        return self._fh

    def close(self) -> None:
        with self._mu:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    # -- write ---------------------------------------------------------
    def append(self, op: str, arr: np.ndarray, seq: int) -> None:
        """Durably log one mutation batch.  Raises before any bytes land
        if the ``wal.append`` kill-point is armed; the ``wal.torn``
        kill-point writes a partial frame first (simulating a crash
        mid-write) and then raises."""
        code = OPS[op]
        payload = _encode(arr)
        frame = _HEADER.pack(_MAGIC, seq, code, len(payload), zlib.crc32(payload)) + payload
        with self._mu:
            faults.fire("wal.append", seq=seq, op=op)
            f = self._open_active()
            try:
                faults.fire("wal.torn", seq=seq, op=op)
            except BaseException:
                f.write(frame[: max(1, len(frame) // 2)])
                f.flush()
                os.fsync(f.fileno())
                raise
            f.write(frame)
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())

    def rotate(self, next_seq: int) -> None:
        """Start a fresh segment for records with seq >= ``next_seq``
        (called right after a snapshot commit)."""
        with self._mu:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            starts = self._segments()
            if starts and starts[-1] >= next_seq:
                return  # already rotated at (or past) this snapshot
            self._create_segment(next_seq)

    def gc(self, min_seq: int) -> None:
        """Drop segments whose every record has seq < ``min_seq`` (i.e.
        segments fully covered by every retained snapshot)."""
        with self._mu:
            starts = self._segments()
            # segment i spans [starts[i], starts[i+1]); the last spans to inf
            for i, start in enumerate(starts[:-1]):
                if starts[i + 1] <= min_seq:
                    os.remove(self._seg_path(start))

    # -- read ----------------------------------------------------------
    def _scan_segment(
        self, path: str, is_last: bool
    ) -> Tuple[List[Tuple[int, str, bytes]], int]:
        """-> (records, clean_byte_length).  Stops at a torn tail when
        ``is_last``; raises on mid-log corruption otherwise."""
        records: List[Tuple[int, str, bytes]] = []
        with open(path, "rb") as f:
            data = f.read()
        off = 0
        n = len(data)
        while off < n:
            if off + _HEADER.size > n:
                break  # torn header
            magic, seq, op, plen, crc = _HEADER.unpack_from(data, off)
            if magic != _MAGIC or op not in _OP_NAMES:
                if is_last:
                    break
                raise PersistError(f"corrupt WAL record at {path}:{off}")
            body = data[off + _HEADER.size : off + _HEADER.size + plen]
            if len(body) < plen or zlib.crc32(body) != crc:
                break  # torn payload
            records.append((seq, _OP_NAMES[op], body))
            off += _HEADER.size + plen
        if off < n and not is_last:
            raise PersistError(
                f"torn WAL record in non-final segment {path} (offset {off})"
            )
        return records, off

    def _truncate_torn_tail(self) -> None:
        starts = self._segments()
        path = self._seg_path(starts[-1])
        _, clean = self._scan_segment(path, is_last=True)
        if clean < os.path.getsize(path):
            with open(path, "r+b") as f:
                f.truncate(clean)
                f.flush()
                os.fsync(f.fileno())

    def replay(self, min_seq: int = 0) -> List[Tuple[int, str, np.ndarray]]:
        """All clean records with seq >= ``min_seq``, in order."""
        out: List[Tuple[int, str, np.ndarray]] = []
        starts = self._segments()
        last_seq = None
        for i, start in enumerate(starts):
            recs, _ = self._scan_segment(
                self._seg_path(start), is_last=(i == len(starts) - 1)
            )
            for seq, op, body in recs:
                if last_seq is not None and seq <= last_seq:
                    raise PersistError(
                        f"WAL seq went backwards ({seq} after {last_seq})"
                    )
                last_seq = seq
                if seq >= min_seq:
                    out.append((seq, op, _decode(body)))
        return out
