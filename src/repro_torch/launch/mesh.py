"""Production mesh construction (counterpart of ``repro.launch.mesh``).

``make_production_mesh`` lays the reference's pod layouts out as a
``distributed.mesh.SlotMesh`` of ``meta`` slots: 256 slots as
``{"data": 16, "model": 16}`` (one pod), or 512 as ``{"pod": 2, "data":
16, "model": 16}``.  A meta slot holds shapes alone, so the dry run
(``launch/dryrun.py``) runs a pod-scale step on one host without
allocating.  ``data_axes_of`` and ``tp_of`` read any mesh with
``axis_names`` and ``shape``.  A mesh of real slots is built directly:
``SlotMesh((torch.device("cuda", 0),) * 4, {"data": 2, "model": 2})``.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["make_production_mesh", "data_axes_of", "tp_of"]


def make_production_mesh(*, multi_pod: bool = False):
    """(16, 16) = one 256-slot pod; (2, 16, 16) = two pods / 512 slots,
    every slot on the ``meta`` device."""
    from repro_torch.distributed.mesh import SlotMesh

    shape = {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}
    n = 512 if multi_pod else 256
    return SlotMesh((torch.device("meta"),) * n, shape)


def data_axes_of(mesh) -> Tuple[str, ...]:
    """The batch-sharding axes: every axis but ``model``."""
    return tuple(a for a in mesh.axis_names if a != "model")


def tp_of(mesh) -> int:
    return mesh.shape["model"]
