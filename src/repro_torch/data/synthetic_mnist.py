"""Procedural MNIST-like digits (offline container: no downloads).

Digits are rendered as anti-aliased 7-segment-style strokes on a 28x28 canvas
with random shift/scale/noise, giving a deterministic, labeled, linearly-
non-separable dataset that exercises the same pipeline the paper ran on MNIST.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

# 7-segment encoding per digit: (top, top-left, top-right, middle, bottom-left,
# bottom-right, bottom)
_SEGMENTS = {
    0: (1, 1, 1, 0, 1, 1, 1),
    1: (0, 0, 1, 0, 0, 1, 0),
    2: (1, 0, 1, 1, 1, 0, 1),
    3: (1, 0, 1, 1, 0, 1, 1),
    4: (0, 1, 1, 1, 0, 1, 0),
    5: (1, 1, 0, 1, 0, 1, 1),
    6: (1, 1, 0, 1, 1, 1, 1),
    7: (1, 0, 1, 0, 0, 1, 0),
    8: (1, 1, 1, 1, 1, 1, 1),
    9: (1, 1, 1, 1, 0, 1, 1),
}

# segment endpoints on a 20x12 glyph box (row0, col0, row1, col1)
_SEG_LINES = (
    (0, 0, 0, 11),      # top
    (0, 0, 9, 0),       # top-left
    (0, 11, 9, 11),     # top-right
    (9, 0, 9, 11),      # middle
    (9, 0, 19, 0),      # bottom-left
    (9, 11, 19, 11),    # bottom-right
    (19, 0, 19, 11),    # bottom
)


def _draw_line(img, r0, c0, r1, c1, thickness=1.6):
    n = max(abs(r1 - r0), abs(c1 - c0)) * 3 + 1
    rr = np.linspace(r0, r1, n)
    cc = np.linspace(c0, c1, n)
    H, W = img.shape
    ri, ci = np.mgrid[0:H, 0:W]
    for r, c in zip(rr, cc):
        d2 = (ri - r) ** 2 + (ci - c) ** 2
        img += np.exp(-d2 / (2 * (thickness / 2.35) ** 2))
    return img


_GLYPHS = None


def _glyphs():
    global _GLYPHS
    if _GLYPHS is None:
        out = np.zeros((10, 20, 12), np.float32)
        for d, segs in _SEGMENTS.items():
            img = np.zeros((20, 12), np.float32)
            for on, line in zip(segs, _SEG_LINES):
                if on:
                    _draw_line(img, *line)
            out[d] = np.clip(img, 0, 1)
        _GLYPHS = out
    return _GLYPHS


def dataset(n: int, seed: int = 0, noise: float = 0.12,
            duplicate_frac: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (X [n, 784] float32 in [0,1], y [n] int32).

    ``duplicate_frac`` injects exact duplicates (the paper's redundant-data
    concern) so the dedup stage has something to remove."""
    rng = np.random.RandomState(seed)
    glyphs = _glyphs()
    X = np.zeros((n, 28, 28), np.float32)
    y = rng.randint(0, 10, n).astype(np.int32)
    for i in range(n):
        g = glyphs[y[i]]
        sr = rng.uniform(0.8, 1.1)
        sc = rng.uniform(0.8, 1.1)
        h, w = int(20 * sr), int(12 * sc)
        h, w = max(10, min(26, h)), max(6, min(20, w))
        rs = np.clip((np.arange(h) / h * 20).astype(int), 0, 19)
        cs = np.clip((np.arange(w) / w * 12).astype(int), 0, 11)
        gl = g[np.ix_(rs, cs)]
        r0 = rng.randint(0, 28 - h)
        c0 = rng.randint(0, 28 - w)
        X[i, r0:r0 + h, c0:c0 + w] = gl
        X[i] += rng.randn(28, 28).astype(np.float32) * noise
    X = np.clip(X, 0, 1).reshape(n, 784)
    if duplicate_frac > 0:
        k = int(n * duplicate_frac)
        src = rng.randint(0, n, k)
        dst = rng.randint(0, n, k)
        X[dst] = X[src]
        y[dst] = y[src]
    return X, y


def train_test(n_train: int = 6000, n_test: int = 1000, seed: int = 0,
               **kw) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    Xtr, ytr = dataset(n_train, seed=seed, **kw)
    Xte, yte = dataset(n_test, seed=seed + 10_000, **kw)
    return Xtr, ytr, Xte, yte
