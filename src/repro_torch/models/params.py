"""Parameter-definition machinery.

Models declare their parameters as a nested dict of ``ParamDef`` leaves
(shape, dtype, init rule) — the same trees ``repro.models.params`` builds,
leaf for leaf, so a JAX parameter tree maps onto the port's by key path
(``models.convert``).  ``init_tree`` turns a def tree into tensors on a
given device; ``abstract_tree`` into ``meta`` tensors (the dry run's
stand-ins: no generator, no allocation, at each device's local shape
under ``models.shardings.resolve`` when given a mesh), and
``param_bytes`` / ``sharded_bytes`` / ``param_count`` size a tree as the
JAX package's functions do.

Initialization draws each leaf from its own ``torch.Generator`` seeded by
``(seed, crc32(key path))``: stable across processes (the JAX package's
``fold_in(key, hash(path))`` depends on PYTHONHASHSEED), but a CPU and a
CUDA generator give different numbers for the same seed, so weights drawn
on the card differ from weights drawn on the CPU.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Any, Dict, Optional, Tuple

import torch

from . import shardings


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    dtype: Any = torch.bfloat16
    init: str = "kernel"      # kernel | embed | zeros | ones | const:<v>

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


def _init_leaf(path: str, d: ParamDef, seed: int,
               device: torch.device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=device)
    if d.init.startswith("const:"):
        return torch.full(d.shape, float(d.init.split(":")[1]),
                          dtype=d.dtype, device=device)
    if d.init == "embed":
        scale = 0.02
    else:  # kernel: variance scaling on fan-in (all dims but last)
        fan_in = max(1, math.prod(d.shape[:-1]))
        scale = 1.0 / math.sqrt(fan_in)
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 1_000_003 + zlib.crc32(path.encode())) % 2**63)
    x = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return x.mul_(scale).to(d.dtype)    # in place: one fp32 copy at a time


def tree_map_defs(fn, defs, path: str = ""):
    """Apply ``fn(path, ParamDef)`` to every leaf of a nested def dict."""
    if isinstance(defs, ParamDef):
        return fn(path, defs)
    return {k: tree_map_defs(fn, v, f"{path}/{k}" if path else k)
            for k, v in defs.items()}


def init_tree(defs, seed: int, device) -> Dict[str, Any]:
    device = torch.device(device)
    return tree_map_defs(lambda p, d: _init_leaf(p, d, seed, device), defs)


def stack_defs(d: ParamDef, n: int) -> ParamDef:
    """Stack a per-layer def into a layer-major [n, ...] def."""
    return ParamDef((n,) + d.shape, ("layers",) + d.logical, d.dtype, d.init)


def stack_tree(defs, n: int) -> Any:
    return tree_map_defs(lambda _, d: stack_defs(d, n), defs)


def tree_leaves(tree, path: str = ""):
    """(key path, leaf) pairs of a tree of dicts and lists (a list's keys
    are its indices), in insertion order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield path, tree
        return
    for k, v in items:
        yield from tree_leaves(v, f"{path}/{k}" if path else str(k))


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``, which share its structure (the role ``jax.tree.map`` plays
    in the JAX package)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def layer(tree, i: int):
    """Layer ``i`` of a layer-stacked tree: views, so in-place writes to a
    layer's cache leaves land in the stacked pool."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _local_shape(d: ParamDef, mesh) -> Tuple[int, ...]:
    """``d``'s shape on one device of ``mesh``: each dim divided by the
    mesh axes ``shardings.resolve`` assigns it."""
    sizes = shardings.axis_sizes(mesh)
    out = []
    for dim, entry in zip(d.shape, shardings.resolve(d.logical, d.shape,
                                                     mesh)):
        for a in () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,)):
            dim //= sizes[a]
        out.append(dim)
    return tuple(out)


def abstract_tree(defs, mesh=None, device="meta") -> Dict[str, Any]:
    """Stand-ins for a def tree, as JAX's ``ShapeDtypeStruct`` trees: empty
    tensors on ``device`` (``meta``: no storage, no generator), at each
    device's local shape under ``mesh`` (None: the whole shape)."""
    def mk(_, d: ParamDef):
        shape = d.shape if mesh is None else _local_shape(d, mesh)
        return torch.empty(shape, dtype=d.dtype, device=device)
    return tree_map_defs(mk, defs)


def _def_leaves(defs):
    return [d for _, d in tree_leaves(defs)]


def param_bytes(defs) -> int:
    return sum(math.prod(d.shape) * d.dtype.itemsize
               for d in _def_leaves(defs))


def sharded_bytes(defs, mesh) -> int:
    """Per-device bytes of a defs tree under its resolved shardings (the
    JAX package's arithmetic: each leaf's bytes floor-divided by the
    product of the mesh axes its spec names)."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    total = 0
    for d in _def_leaves(defs):
        spec = shardings.resolve(d.logical, d.shape, mesh)
        shards = 1
        for entry in spec:
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            for a in axes:
                shards *= sizes[a]
        total += math.prod(d.shape) * d.dtype.itemsize // shards
    return total


def param_count(defs) -> int:
    return sum(math.prod(d.shape) for d in _def_leaves(defs))
