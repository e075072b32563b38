"""Diversity-based data sampling (paper §III-A-1).

"One idea is to remove the similar items by using diversity-based data sampling
... the frequency of input data will be counted, and those duplicated data is
eliminated."  Implemented as a hash-count pass (exact duplicates) plus an
optional LSH-style coarse-similarity cap (quantized-pixel signature).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Optional, Tuple

import numpy as np


def _signatures(X: np.ndarray, quant: Optional[int]) -> np.ndarray:
    if quant is None:
        data = X
    else:
        data = np.round(X * quant).astype(np.int16)
    return np.asarray([hash(row.tobytes()) for row in data], np.int64)


def dedup(X: np.ndarray, y: Optional[np.ndarray] = None, *, max_dup: int = 1,
          quant: Optional[int] = None) -> Tuple[np.ndarray, ...]:
    """Keep at most ``max_dup`` copies of each (near-)identical sample.

    ``quant=None`` removes exact duplicates; ``quant=k`` first quantizes pixels
    to k levels so near-identical noisy copies also collapse."""
    sigs = _signatures(X, quant)
    counts: dict = defaultdict(int)
    keep = np.zeros(len(X), bool)
    for i, s in enumerate(sigs):
        counts[s] += 1
        if counts[s] <= max_dup:
            keep[i] = True
    if y is None:
        return (X[keep],)
    return X[keep], y[keep]


def duplicate_stats(X: np.ndarray, quant: Optional[int] = None) -> dict:
    sigs = _signatures(X, quant)
    uniq, cnt = np.unique(sigs, return_counts=True)
    return {"n": len(X), "unique": len(uniq),
            "dup_frac": 1.0 - len(uniq) / max(1, len(X)),
            "max_multiplicity": int(cnt.max()) if len(cnt) else 0}
