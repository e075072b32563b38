"""Parameter bridge from the JAX package's trees to the port's.

``params_from_numpy`` takes a ``repro`` parameter tree as nested dicts of
numpy arrays (what ``jax.device_get`` returns; bf16 leaves arrive as
``ml_dtypes.bfloat16``) and returns the port's tree on a device, leaf for
leaf: both packages build the same key paths and layer-stacked shapes.
bf16 goes through fp32, which represents every bf16 value exactly.  The
port never imports jax; callers that hold a JAX tree convert it to numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ArchConfig
from .params import ParamDef, tree_map_defs
from .registry import build_model


def params_from_numpy(cfg: ArchConfig, tree, device="cpu"):
    """Convert a numpy parameter tree for ``cfg`` into torch tensors on
    ``device``; raises on a missing or extra key or a shape mismatch."""
    defs = build_model(cfg).param_defs()

    def convert(path: str, d: ParamDef):
        node = tree
        for key in path.split("/"):
            if not isinstance(node, dict) or key not in node:
                raise KeyError(f"parameter {path!r} missing from the tree")
            node = node[key]
        a = np.asarray(node)
        if tuple(a.shape) != tuple(d.shape):
            raise ValueError(f"parameter {path!r}: shape {a.shape}, "
                             f"expected {d.shape}")
        t = torch.from_numpy(np.asarray(a, np.float32).copy())
        return t.to(device=device, dtype=d.dtype)

    out = tree_map_defs(convert, defs)
    extra = _paths(tree) - _paths(out)
    if extra:
        raise KeyError(f"parameters not in {cfg.name}'s tree: {sorted(extra)}")
    return out


def _paths(tree, prefix: str = ""):
    if not isinstance(tree, dict):
        return {prefix}
    out = set()
    for k, v in tree.items():
        out |= _paths(v, f"{prefix}/{k}" if prefix else k)
    return out
