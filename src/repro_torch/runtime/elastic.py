"""Restore a checkpoint onto another topology: the port of
``repro.runtime.elastic``.

The JAX package re-places every leaf with a sharding resolved against the
new mesh.  The port runs on one device, so ``restore_on_mesh`` restores a
defs-described tree onto that device (a checkpoint taken on the card
restores onto the CPU and back); ``degraded_mesh``, which only computes the
shape of the fallback topology from a mesh's ``axis_names`` and
``devices.shape``, is a copy."""
from __future__ import annotations

from typing import Optional

import torch

from ..checkpoint import ckpt
from ..models.params import tree_map_defs


def restore_on_mesh(path: str, defs, device, *, step: Optional[int] = None):
    """Restore a checkpoint of a defs-described tree (``ParamDef`` leaves)
    onto ``device``.  Returns (tree, step, extra)."""
    like = tree_map_defs(
        lambda _, d: torch.empty(d.shape, dtype=d.dtype, device="meta"), defs)
    return ckpt.restore(path, like, step=step, device=device)


def degraded_mesh(original: Mesh, lost_axis: str = "pod") -> dict:
    """Describe the fallback topology after losing one unit of ``lost_axis``
    (used by launch scripts to compute the restart mesh)."""
    shape = dict(zip(original.axis_names, original.devices.shape))
    if lost_axis in shape and shape[lost_axis] > 1:
        shape[lost_axis] -= 1
    return shape
