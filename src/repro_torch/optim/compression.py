"""Gradient compression for the cross-pod reduce: the port of
``repro.optim.compression``.

Int8 block quantization with *error feedback*: the quantization residual is
kept locally and added to the next step's gradient, so compression error
does not accumulate (Seide et al. 1-bit SGD / EF-SGD).  Used by the
``compressed`` reduce mode of the MapReduce engine (``core.mapreduce``):
pod-local reduction runs at full precision; only the cross-pod exchange
sees int8, a 4x cut of the bytes on the wire.  ``quantize_int8`` and
``dequantize_int8`` round exactly as the JAX functions do (fp32 block max
over 127, round half to even, clip to [-127, 127]).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..models.params import tree_map

BLOCK = 256


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8 quantization of ``x`` flattened and
    zero-padded to whole ``BLOCK``s.  Returns (q int8 [blocks, BLOCK],
    scale fp32 [blocks, 1])."""
    flat = x.float().reshape(-1)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(blocks / torch.clamp(scale, min=1e-12)),
                    -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype) -> torch.Tensor:
    """The first prod(shape) values of ``f32(q) * scale``, as ``shape`` in
    ``dtype``."""
    flat = (q.float() * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape).to(dtype)


def compress_tree(grads):
    """(q, scale) for every tensor of a nested dict / list of tensors."""
    return tree_map(quantize_int8, grads)


def decompress_tree(qtree, like):
    """Inverse of ``compress_tree``: each (q, scale) pair back to the shape
    and dtype of the matching tensor of ``like``."""
    return tree_map(lambda g, qs: dequantize_int8(qs[0], qs[1], g.shape,
                                                  g.dtype), like, qtree)


def ef_compress(g: torch.Tensor, err: torch.Tensor):
    """Error-feedback compression of one tensor.  Returns (dequantized g in
    g's dtype, new error fp32, wire bytes: int8 values plus fp32 scales)."""
    corrected = g.float() + err
    q, scale = quantize_int8(corrected)
    deq = dequantize_int8(q, scale, g.shape, torch.float32)
    new_err = corrected - deq
    wire = q.numel() + scale.numel() * 4
    return deq.to(g.dtype), new_err, wire
