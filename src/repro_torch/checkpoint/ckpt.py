"""Checkpoint / restore with async save: the port of
``repro.checkpoint.ckpt``.

Format, as in the JAX package: ``<path>/ckpt_<step>/arrays.npz`` holding
every leaf keyed by its tree path (``['params']['embed']['tok']``, ``[0]``
for a sequence element: ``jax.tree_util.keystr``'s spelling) and a
``manifest.json`` with the step, the keys and the caller's ``extra``.
numpy has no bfloat16, so a bf16 leaf is stored by its bits (uint16) and
the manifest's ``dtypes`` names the dtype of every leaf.  A save writes a
``.tmp`` directory and renames it (atomic), keeps the newest 3 checkpoints,
and may run on a background thread; every leaf is copied to the host
before that thread starts, so the caller may go on changing its tensors.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.params import tree_leaves, tree_unflatten

_BITS = {torch.bfloat16: np.uint16}


def _keystr(path: str, tree) -> str:
    """``jax.tree_util.keystr`` of a '/'-joined path of ``tree``."""
    out, node = "", tree
    for part in path.split("/") if path else []:
        if isinstance(node, dict):
            out += f"[{part!r}]"
            node = node[part]
        else:
            out += f"[{part}]"
            node = node[int(part)]
    return out


def _flatten_with_paths(tree) -> Dict[str, Any]:
    return {_keystr(p, tree): leaf for p, leaf in tree_leaves(tree)}


def _to_host(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(numpy copy, dtype name) of one tensor."""
    t = leaf.detach().to("cpu", copy=True)
    name = str(t.dtype).replace("torch.", "")
    if t.dtype in _BITS:
        return t.view(torch.int16).numpy().view(_BITS[t.dtype]), name
    return t.numpy(), name


def save(path: str, step: int, tree, *, extra: Optional[dict] = None,
         _async: bool = False) -> Optional[threading.Thread]:
    """Atomically write ``<path>/ckpt_<step>``. Returns the thread when
    async."""
    host = {k: _to_host(v) for k, v in _flatten_with_paths(tree).items()}

    def _write():
        d = os.path.join(path, f"ckpt_{step}")
        tmp = d + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{k: a for k, (a, _) in host.items()})
        manifest = {"step": step, "keys": sorted(host),
                    "dtypes": {k: dt for k, (_, dt) in host.items()},
                    "extra": extra or {}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(d):
            shutil.rmtree(d)
        os.replace(tmp, d)
        _gc(path, keep=3)

    if _async:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def _gc(path: str, keep: int):
    steps = sorted(all_steps(path))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(path, f"ckpt_{s}"), ignore_errors=True)


def all_steps(path: str):
    if not os.path.isdir(path):
        return []
    out = []
    for name in os.listdir(path):
        if name.startswith("ckpt_") and not name.endswith(".tmp"):
            try:
                out.append(int(name.split("_")[1]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(path: str) -> Optional[int]:
    steps = all_steps(path)
    return steps[-1] if steps else None


def restore(path: str, like, *, step: Optional[int] = None,
            device=None) -> Tuple[Any, int, dict]:
    """Restore into the structure of ``like`` (a tree of tensors, which may
    be on the ``meta`` device: only their place in the tree counts).  Each
    leaf comes back with the dtype it was saved with, on ``device`` (by
    default the device of its ``like`` leaf; ``meta`` leaves default to
    the CPU).  Returns (tree, step, extra)."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    d = os.path.join(path, f"ckpt_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    dtypes = manifest.get("dtypes", {})
    out = []
    with np.load(os.path.join(d, "arrays.npz")) as arrays:
        for p, leaf in tree_leaves(like):
            key = _keystr(p, like)
            arr = arrays[key]
            dt = getattr(torch, dtypes.get(key, str(arr.dtype)))
            if dt in _BITS:
                t = torch.from_numpy(arr.view(np.int16).copy()).view(dt)
            else:
                t = torch.from_numpy(np.array(arr))
            dev = device if device is not None else leaf.device
            if torch.device(dev).type == "meta":
                dev = "cpu"
            out.append(t.to(dev))
    return tree_unflatten(like, out), int(manifest["step"]), \
        manifest.get("extra", {})
