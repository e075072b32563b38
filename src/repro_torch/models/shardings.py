"""Divisibility-aware sharding rules, for planning: the port of
``repro.models.shardings``.

Each parameter def names *logical* axes (e.g. ``("embed", "heads")``);
``resolve`` maps them to mesh axes and silently drops any assignment that
does not divide evenly (e.g. qwen2's 14 heads over a 16-way ``model`` axis
-> replicated heads), exactly as the JAX package does.  ``LOGICAL_RULES``,
``dp_axes``, ``axis_sizes`` and ``resolve`` are copies of the JAX
definitions.

The port runs each process's whole model; its only multi-process layout is
the paper's MapReduce data parallelism (``core.mapreduce.DPGroups`` over
``pod`` x ``data``).  So nothing here places a tensor: a mesh is a
``MeshSpec`` (what the planning functions read of a ``jax.sharding.Mesh``)
and a spec is a ``PartitionSpec`` tuple, which the dry run
(``launch/dryrun.py``) turns into each device's local shape and bytes.
The JAX package's ``shard_map_compat``, ``make_mesh_compat``, ``named`` and
``constrain`` have no counterpart: the eager port has no jit to constrain,
and ``DPGroups`` stands for the mesh's data axes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A device mesh as the planning functions read one: ``MeshSpec(shape,
    axis_names)``, e.g. ``MeshSpec((2, 256), ("pod", "data"))``.  ``.shape``
    is a dict of axis sizes and ``.devices`` an array of that shape, as a
    ``jax.sharding.Mesh``'s are; its entries are the process ranks
    ``core.mapreduce.dp_groups`` lays out (rank ``r`` is process ``r %
    n_data`` of pod ``r // n_data``)."""
    dims: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        object.__setattr__(self, "dims", tuple(int(n) for n in self.dims))
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        if len(self.dims) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.dims} and axes "
                             f"{self.axis_names} differ in length")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return math.prod(self.dims)

    @property
    def devices(self) -> np.ndarray:
        return np.arange(self.size).reshape(self.dims)


Mesh = MeshSpec


class PartitionSpec(tuple):
    """A tensor's spec: one entry a dim, None (replicated), a mesh axis
    name, or a tuple of names, as ``jax.sharding.PartitionSpec`` holds
    them."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)


P = PartitionSpec

# logical axis -> preferred mesh axis (in priority order)
LOGICAL_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("dp",),            # dp is the compound data axis (pod+data)
    "seq": (),
    "seq_sp": ("model",),
    "embed": (),                 # d_model is replicated by default (TP on other dims)
    "embed_tp": ("model",),      # d_model sharded (used as fallback / ZeRO dim)
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "ff": ("model",),
    "experts": ("model",),
    "lora": (),
    "state": (),
    "rnn": ("model",),
    "conv": (),
    "layers": (),
    "zero": ("data",),           # optimizer-state sharding dim (ZeRO-1)
}


def dp_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The compound data-parallel axes present in this mesh."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def axis_sizes(mesh: Mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def resolve(
    logical: Sequence[Optional[str]],
    shape: Sequence[int],
    mesh: Mesh,
    *,
    used: Optional[set] = None,
) -> P:
    """Map logical axes to a PartitionSpec, dropping non-dividing assignments.

    Each mesh axis is used at most once per tensor.
    """
    sizes = axis_sizes(mesh)
    taken = set() if used is None else used
    out = []
    for ax, dim in zip(logical, shape):
        assigned = None
        if ax is not None:
            candidates = LOGICAL_RULES.get(ax, ())
            for cand in candidates:
                if cand == "dp":
                    dps = dp_axes(mesh)
                    total = 1
                    for a in dps:
                        total *= sizes[a]
                    if dps and dim % total == 0 and not (set(dps) & taken):
                        assigned = dps if len(dps) > 1 else dps[0]
                        taken.update(dps)
                        break
                elif cand in sizes and dim % sizes[cand] == 0 and cand not in taken:
                    assigned = cand
                    taken.add(cand)
                    break
        out.append(assigned)
    return P(*out)


def tree_specs(defs, mesh: Mesh):
    """defs: nested dict of ``ParamDef`` -> the same tree of
    ``PartitionSpec`` (the JAX function's tree of ``NamedSharding``)."""
    from .params import tree_map_defs
    return tree_map_defs(lambda _, d: resolve(d.logical, d.shape, mesh),
                         defs)
