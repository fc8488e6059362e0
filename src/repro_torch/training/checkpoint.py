"""Checkpointing: atomic, asynchronous, keep-k, restorable onto any device.

Counterpart of ``repro.training.checkpoint.CheckpointManager``, with its
contract and its on-disk layout (the reference reads the port's
checkpoints and ``models/convert.py::read_reference_checkpoint`` the
reference's):

  * **atomic commit**: a checkpoint is written to ``step_%010d.tmp``; the
    arrays are fsynced before the manifest that vouches for them, then the
    directory is renamed (``os.replace``) and the rename made durable
    (``persist/format.py::fsync_dir``), so a crash never leaves a half
    checkpoint that restore would pick up (``faults.fire("checkpoint.write")``
    sits between the arrays and the manifest);
  * **async save**: the state is copied to host memory at ``save`` (the
    train step updates the parameters in place right after) and written on
    a background thread, one save in flight; a failed write is raised again
    at the next ``wait()``;
  * **keep-k GC** with optional keep-every-n archival; ``.tmp`` leftovers
    of a crashed commit are removed;
  * **restore onto any device or mesh**: arrays are stored whole (host
    values, a sharded state gathered first: ``training/step.py::
    gather_train_state``); ``restore(template, device=...)`` places them on
    any device, ``restore(template, shardings=(mesh, specs))`` each slot's
    shard on its slot (the elastic restart: saved on one mesh, resumed on
    another), so a checkpoint saved on one device resumes on another bit
    for bit;
  * the data pipeline's step rides in the manifest (``extra``).

Arrays go into one ``arrays.npz`` per checkpoint keyed by ``/``-joined
paths of the state's nested dicts (``params/<state-dict name>``,
``opt/m/<name>``, ``opt/count``).  bf16 tensors are stored as their uint16
bits (``Tensor.view``) with ``"bfloat16"`` in the manifest's ``dtypes``.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import faults
from repro_torch.persist.format import _mmap_npz, fsync_dir

__all__ = ["CheckpointManager"]

_STEP_RE = re.compile(r"^step_(\d+)$")


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts -> {"a/b/c": leaf}."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as (numpy copy, its dtype's name); bf16 as uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to(device="cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.array(leaf)
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, dtype: Optional[str], device) -> torch.Tensor:
    if not arr.flags.c_contiguous:
        arr = arr.copy()   # (np.ascontiguousarray would make a 0-d leaf 1-d)
    t = torch.from_numpy(arr.view(np.int16) if dtype == "bfloat16" else arr)
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device, copy=True)   # off the file's mapping, also on the CPU


def _unflatten_like(template, flat: Dict[str, np.ndarray], dtypes: Dict[str, str],
                    device, prefix: str = "", placement=None):
    if isinstance(template, dict):
        return {k: _unflatten_like(v, flat, dtypes, device, f"{prefix}/{k}" if prefix
                                   else str(k), None if placement is None else
                                   (placement[0], placement[1][k])) for k, v in template.items()}
    if prefix not in flat:
        raise KeyError(f"checkpoint missing leaf {prefix!r}")
    arr = flat[prefix]
    want = tuple(template.shape) if hasattr(template, "shape") else None
    if want is not None and tuple(arr.shape) != want:
        raise ValueError(f"leaf {prefix!r} shape {arr.shape} != expected {want}")
    if placement is not None:   # each slot's shard, read from the mapped array
        from repro_torch.distributed.mesh import shard_slices

        mesh, spec = placement
        return [_to_tensor(np.array(arr[shard_slices(arr.shape, spec, mesh, s)]),
                           dtypes.get(prefix), mesh.devices[s]) for s in range(mesh.size)]
    if device is None:
        device = template.device if isinstance(template, torch.Tensor) else "cpu"
    return _to_tensor(arr, dtypes.get(prefix), device)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3, keep_every: int = 0,
                 async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.keep_every = keep_every
        self.async_save = async_save
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------
    def _write(self, step: int, host: Dict[str, np.ndarray], manifest: dict) -> None:
        tmp = os.path.join(self.dir, f"step_{step:010d}.tmp")
        final = os.path.join(self.dir, f"step_{step:010d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        try:
            # the arrays reach the disk before the manifest that vouches for them
            with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
                np.savez(f, **host)
                f.flush()
                os.fsync(f.fileno())
            faults.fire("checkpoint.write", step=step)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, final)   # atomic commit
            fsync_dir(self.dir)      # make the rename itself durable
            self._gc()
        except BaseException as e:
            self._error = e
            raise

    def _gc(self) -> None:
        steps = self.all_steps()
        protected = set(steps[-self.keep:]) if self.keep else set(steps)
        if self.keep_every:
            protected |= {s for s in steps if s % self.keep_every == 0}
        for s in steps:
            if s not in protected:
                shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"), ignore_errors=True)
        for name in os.listdir(self.dir):   # crashed-commit leftovers
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, name), ignore_errors=True)

    # ------------------------------------------------------------------
    def save(self, step: int, state: Any, *, extra: Optional[dict] = None,
             block: bool = False) -> None:
        """Snapshot ``state`` (nested dicts of tensors or arrays) at ``step``."""
        self.wait()   # one save in flight
        host, dtypes = {}, {}
        for key, leaf in _flatten(state).items():
            host[key], dtypes[key] = _to_host(leaf)
        manifest = {"step": int(step), "time": time.time(), "extra": extra or {},
                    "dtypes": dtypes}
        if self.async_save:
            self._thread = threading.Thread(target=self._write, args=(step, host, manifest),
                                            daemon=True)
            self._thread.start()
            if block:
                self.wait()
        else:
            try:
                self._write(step, host, manifest)
            finally:
                # a synchronous save raises here; leave nothing for wait()
                self._error = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ------------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.dir, name, "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def nbytes(self, step: Optional[int] = None) -> int:
        """Bytes on disk of checkpoint ``step`` (the newest by default)."""
        step = self.latest_step() if step is None else step
        path = os.path.join(self.dir, f"step_{step:010d}")
        return sum(os.path.getsize(os.path.join(path, n)) for n in os.listdir(path))

    def restore(self, template: Any, *, step: Optional[int] = None,
                device=None, shardings=None) -> Tuple[Any, dict]:
        """Restore into ``template``'s structure (its shapes are checked; a
        missing leaf raises ``KeyError``, another shape ``ValueError``).
        Each tensor goes to ``device``, or where the template's leaf lives;
        with ``shardings = (mesh, specs)`` (a ``SlotMesh`` and a spec per
        leaf, in the template's structure) each leaf becomes a list of its
        per-slot shards instead, each on its slot
        (``training/step.py::place_train_state`` takes that tree)."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        # the members mapped, not read through zipfile (5x faster for GBs)
        flat = _mmap_npz(os.path.join(path, "arrays.npz"))
        tree = _unflatten_like(template, flat, manifest.get("dtypes", {}), device,
                               placement=shardings)
        return tree, manifest
