"""Versioned snapshot store: manifest + slab arrays, atomic commit, keep-k GC.

On-disk layout (format version 2; history at ``FORMAT_VERSION``)::

    <root>/
      v_0000000001/
        manifest.json       # format, engine, n, d, mutation_seq, spec, meta
        arrays.npz          # flat {path: ndarray} map (npz, uncompressed)
      v_0000000002/
        ...

Invariants (same fault-tolerance contract as ``training/checkpoint.py``):
  * a version directory is written as ``v_XXXX.tmp`` and ``os.replace``-d
    into place only after every array and the manifest are flushed to
    disk — a crash can never leave a half version that ``read()`` picks
    up (a version *without* a manifest.json is treated as absent);
  * ``commit`` fsyncs the array file, the manifest, and the parent
    directory, so the rename itself is durable;
  * keep-k GC removes old complete versions AND any ``*.tmp`` leftovers
    from crashed commits.

This module is deliberately api-free (numpy + stdlib only) so the api
layer, the dynamic engine and the serving layer can all import it
without cycles.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import zipfile
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch import faults

__all__ = [
    "FORMAT_VERSION",
    "READABLE_FORMATS",
    "PersistError",
    "PersistUnsupported",
    "VersionStore",
    "fsync_dir",
]

# Format history:
#   1  original layout (manifest.json + arrays.npz)
#   2  quantized leaf slabs: snapshots may carry per-shard/engine
#      ``quant/...`` arrays (codes, scale, offset, dead mask, eps) and
#      ``precision``/``strict_budget`` spec fields.  Structurally identical
#      to 1 — format-1 snapshots load unchanged (absent fields => fp32).
FORMAT_VERSION = 2
READABLE_FORMATS = (1, 2)

_VERSION_RE = re.compile(r"^v_(\d{10})$")


class PersistError(RuntimeError):
    """Snapshot/WAL store corruption or misuse."""


class PersistUnsupported(PersistError):
    """The engine has no snapshot representation (see docs/OPERATIONS.md)."""


def fsync_dir(path: str) -> None:
    """Flush a directory entry (makes a just-committed rename durable)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _mmap_npz(path: str) -> Dict[str, np.ndarray]:
    """Map the members of an UNCOMPRESSED ``.npz`` as copy-on-write
    ``np.memmap`` views — the warm-restart fast path.

    ``np.savez`` stores members with ``ZIP_STORED`` (no deflate), so each
    member's array body sits contiguously in the outer file at a fixed
    offset: local zip header, then the ``.npy`` magic + header, then raw
    C-order bytes.  Mapping those bytes directly makes "reading" a
    multi-GB snapshot a page-table operation; bulk data is paged in
    lazily on first touch (free on a warm page cache — the restart
    scenario this exists for).

    Mode ``'c'`` (copy-on-write) means callers may mutate the arrays in
    place (tombstone bits, brute-shard pad writes) without corrupting
    the snapshot: dirtied pages go to private anonymous memory, never
    back to disk.  Any member this trick cannot map (compressed, object
    dtype, Fortran order, zero-size) silently falls back to an eager
    read, so the result is always a complete array map.
    """
    out: Dict[str, np.ndarray] = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as raw:
        for info in zf.infolist():
            name = info.filename
            if name.endswith(".npy"):
                name = name[: -len(".npy")]
            arr = None
            if info.compress_type == zipfile.ZIP_STORED:
                # the central directory's extra-field length can differ
                # from the local header's: parse the local header itself
                raw.seek(info.header_offset)
                lhdr = raw.read(30)
                if len(lhdr) == 30 and lhdr[:4] == b"PK\x03\x04":
                    name_len = int.from_bytes(lhdr[26:28], "little")
                    extra_len = int.from_bytes(lhdr[28:30], "little")
                    raw.seek(info.header_offset + 30 + name_len + extra_len)
                    try:
                        version = np.lib.format.read_magic(raw)
                        if version == (1, 0):
                            shape, fortran, dtype = (
                                np.lib.format.read_array_header_1_0(raw)
                            )
                        else:
                            shape, fortran, dtype = (
                                np.lib.format.read_array_header_2_0(raw)
                            )
                        n_items = int(np.prod(shape, dtype=np.int64))
                        if not fortran and not dtype.hasobject and n_items:
                            arr = np.memmap(
                                path, dtype=dtype, mode="c",
                                offset=raw.tell(), shape=shape, order="C",
                            )
                    except ValueError:
                        arr = None
            if arr is None:  # fallback: eager, always correct
                with zf.open(info) as f:
                    arr = np.lib.format.read_array(f)
            out[name] = arr
    return out


class VersionStore:
    """Monotonic version directories of (manifest.json, arrays.npz)."""

    MANIFEST = "manifest.json"
    ARRAYS = "arrays.npz"

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    # -- discovery -----------------------------------------------------
    def _dir(self, version: int) -> str:
        return os.path.join(self.root, f"v_{version:010d}")

    def versions(self) -> List[int]:
        """Complete (manifest-bearing) versions, ascending."""
        out = []
        for name in os.listdir(self.root):
            m = _VERSION_RE.match(name)
            if m and os.path.exists(os.path.join(self.root, name, self.MANIFEST)):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest(self) -> Optional[int]:
        vs = self.versions()
        return vs[-1] if vs else None

    # -- read ----------------------------------------------------------
    def read_manifest(self, version: Optional[int] = None) -> dict:
        if version is None:
            version = self.latest()
        if version is None:
            raise PersistError(f"no complete snapshot versions in {self.root}")
        with open(os.path.join(self._dir(version), self.MANIFEST)) as f:
            manifest = json.load(f)
        if manifest.get("format") not in READABLE_FORMATS:
            raise PersistError(
                f"snapshot v{version} has format {manifest.get('format')!r}; "
                f"this build reads formats {READABLE_FORMATS}"
            )
        return manifest

    def read(
        self, version: Optional[int] = None, *, mmap: bool = False
    ) -> Tuple[Dict[str, np.ndarray], dict, int]:
        """-> (arrays, manifest, version).  Picks the latest complete
        version when ``version`` is None.

        ``mmap=True`` returns copy-on-write ``np.memmap`` views instead
        of eager copies (lazy page-in; safe to mutate in place, never
        written back — see ``_mmap_npz``).  On Linux the mapping outlives
        any later GC of the version directory, so long-lived restored
        indexes are safe even under ``keep``-driven pruning.
        """
        if version is None:
            version = self.latest()
        if version is None:
            raise PersistError(f"no complete snapshot versions in {self.root}")
        manifest = self.read_manifest(version)
        apath = os.path.join(self._dir(version), self.ARRAYS)
        if mmap:
            arrays = _mmap_npz(apath)
        else:
            with np.load(apath) as z:
                arrays = {k: z[k] for k in z.files}
        return arrays, manifest, version

    # -- write ---------------------------------------------------------
    def commit(
        self,
        arrays: Dict[str, np.ndarray],
        manifest: dict,
        *,
        keep: int = 2,
    ) -> int:
        """Atomically write the next version; GC down to ``keep`` complete
        versions.  Returns the committed version number."""
        latest = self.latest()
        version = 1 if latest is None else latest + 1
        final = self._dir(version)
        tmp = final + ".tmp"
        if os.path.exists(final):
            # manifest-less debris (version > latest COMPLETE version can
            # only be incomplete): clear it or os.replace below fails
            shutil.rmtree(final)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = dict(manifest)
        manifest["format"] = FORMAT_VERSION
        faults.fire("persist.slab_write", version=version)
        apath = os.path.join(tmp, self.ARRAYS)
        with open(apath, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        with open(os.path.join(tmp, self.MANIFEST), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        faults.fire("persist.commit", version=version)
        os.replace(tmp, final)
        fsync_dir(self.root)
        self._gc(keep)
        return version

    def _gc(self, keep: int) -> None:
        vs = self.versions()
        protected = set(vs[-keep:]) if keep else set(vs)
        for name in os.listdir(self.root):
            path = os.path.join(self.root, name)
            if name.endswith(".tmp"):
                shutil.rmtree(path, ignore_errors=True)
                continue
            m = _VERSION_RE.match(name)
            if m and int(m.group(1)) not in protected:
                shutil.rmtree(path, ignore_errors=True)
