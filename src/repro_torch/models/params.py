"""Parameter-definition machinery.

Models declare their parameters as a nested dict of ``ParamDef`` leaves
(shape, dtype, init rule) — the same trees ``repro.models.params`` builds,
leaf for leaf, so a JAX parameter tree maps onto the port's by key path
(``models.convert``).  ``init_tree`` turns a def tree into tensors on a
given device.

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
    return (x * scale).to(d.dtype)


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
    """(key path, leaf) pairs of a nested dict, in insertion order."""
    if not isinstance(tree, dict):
        yield path, tree
        return
    for k, v in tree.items():
        yield from tree_leaves(v, f"{path}/{k}" if path else k)


def layer(tree, i: int):
    """Layer ``i`` of a layer-stacked tree: views, so in-place writes to a
    layer's cache leaves land in the stacked pool."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}
