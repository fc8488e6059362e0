"""Crash-safe index persistence: versioned snapshots + mutation WAL.

Counterpart of ``repro.persist`` (host numpy and zip), the same on-disk
format: each package loads the other's snapshots.  See docs/OPERATIONS.md
for the format, replay semantics and the recovery guarantees;
``KNNIndex.save``/``KNNIndex.load`` are the front-door entry points.
"""

from repro_torch import faults as _faults
from repro_torch.persist.format import (
    FORMAT_VERSION,
    PersistError,
    PersistUnsupported,
    VersionStore,
)
from repro_torch.persist.wal import WriteAheadLog

_faults.load_env()

__all__ = [
    "FORMAT_VERSION",
    "PersistError",
    "PersistUnsupported",
    "VersionStore",
    "WriteAheadLog",
]
