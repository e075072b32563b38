"""Parameter bridge from the JAX package's trees to the port's.

``params_from_numpy`` takes a ``repro`` parameter tree as nested dicts of
numpy arrays (what ``jax.device_get`` returns; bf16 leaves arrive as
``ml_dtypes.bfloat16``) and returns the port's tree on a device, leaf for
leaf: both packages build the same key paths and layer-stacked shapes.
bf16 goes through fp32, which represents every bf16 value exactly.  The
port never imports jax; callers that hold a JAX tree convert it to numpy.

The paper's RBM/DBN family has no ``ArchConfig`` tree: ``rbm_stack_from_numpy``
maps a pre-trained RBM stack (a list of {"W", "bv", "bh"}) and
``dbn_tree_from_numpy`` a classifier or autoencoder tree (dicts of lists of
fp32 arrays, ``core.finetune`` / ``core.autoencoder``), leaf to leaf.
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


RBM_KEYS = ("W", "bv", "bh")
DBN_TREES = {"classifier": ("W", "b", "head_W", "head_b"),
             "autoencoder": ("enc_W", "enc_b", "dec_W", "dec_b")}


def _fp32(a, device):
    return torch.from_numpy(np.asarray(a, np.float32).copy()).to(device)


def rbm_stack_from_numpy(stack, device="cpu"):
    """A list of RBM layers {"W" [n_vis, n_hid], "bv", "bh"} as fp32
    tensors on ``device``; raises on a missing or extra key or a layer whose
    shapes do not chain."""
    out = []
    for i, layer_p in enumerate(stack):
        if set(layer_p) != set(RBM_KEYS):
            raise KeyError(f"RBM layer {i}: keys {sorted(layer_p)}, expected "
                           f"{sorted(RBM_KEYS)}")
        w = np.asarray(layer_p["W"])
        if np.shape(layer_p["bv"]) != w.shape[:1] \
                or np.shape(layer_p["bh"]) != w.shape[1:] \
                or (out and out[-1]["W"].shape[1] != w.shape[0]):
            raise ValueError(f"RBM layer {i}: shapes W {w.shape}, bv "
                             f"{np.shape(layer_p['bv'])}, bh "
                             f"{np.shape(layer_p['bh'])} do not chain")
        out.append({k: _fp32(layer_p[k], device) for k in RBM_KEYS})
    return out


def dbn_tree_from_numpy(kind: str, tree, device="cpu"):
    """A ``kind`` ("classifier" or "autoencoder") parameter tree of fp32
    arrays as fp32 tensors on ``device``, leaf to leaf; raises on a
    missing or extra key."""
    keys = DBN_TREES[kind]
    if set(tree) != set(keys):
        raise KeyError(f"{kind} tree: keys {sorted(tree)}, expected "
                       f"{sorted(keys)}")
    return {k: [_fp32(a, device) for a in tree[k]]
            if isinstance(tree[k], (list, tuple)) else _fp32(tree[k], device)
            for k in keys}
