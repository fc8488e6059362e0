"""Mesh helpers (counterpart of ``repro.launch.mesh``).

``data_axes_of`` and ``tp_of`` read any mesh with ``axis_names`` and
``shape`` (a ``distributed.mesh.SlotMesh``).  The reference's
``make_production_mesh`` builds the 256 / 512-chip pod meshes its dry run
lowers for; the port's dry run is ROADMAP Queue 1 item 19, so it raises
``DryRunNotPorted``.  A mesh of slots is built directly:
``SlotMesh((torch.device("cuda", 0),) * 4, {"data": 2, "model": 2})``.
"""

from __future__ import annotations

from typing import Tuple

__all__ = ["DryRunNotPorted", "make_production_mesh", "data_axes_of", "tp_of"]


class DryRunNotPorted(NotImplementedError):
    """The pod-scale dry run (``repro.launch.dryrun``) is not ported yet
    (ROADMAP Queue 1 item 19)."""


def make_production_mesh(*, multi_pod: bool = False):
    raise DryRunNotPorted(
        f"the {'512' if multi_pod else '256'}-chip production mesh belongs to the dry run, "
        "which waits for ROADMAP Queue 1 item 19 (roofline, configs/shapes.py, "
        "launch/dryrun.py); build a SlotMesh of device slots instead")


def data_axes_of(mesh) -> Tuple[str, ...]:
    """The batch-sharding axes: every axis but ``model``."""
    return tuple(a for a in mesh.axis_names if a != "model")


def tp_of(mesh) -> int:
    return mesh.shape["model"]
