"""Ragged chunk prefill against the post-write paged pool (kernel K2).

``ragged_prefill`` replaces ``repro.kernels.ragged_prefill.ops
.ragged_prefill_attend`` (Pallas ``kernel.py::ragged_prefill_fwd``) with
bf16 pages or int8 pages plus bf16 scale pages.  For CUDA tensors it launches the hand-written kernel in
``csrc/ragged_prefill.cu`` (design and bound in that file's note); for CPU
tensors it runs ``ragged_prefill_plain``, the plain PyTorch version of the
same function, which is also the reference backend's prefill core and the
kernel's oracle on the card.
"""
from __future__ import annotations

import ctypes

import torch

from .. import (check_launch, check_pool, check_tensor, entry, ptr,
                refuse_modes)
from ...models import attention


def ragged_prefill_plain(q, k_pages, v_pages, tables, start, *,
                         scale: float, q_block: int = 512, k_scale=None,
                         v_scale=None):
    """q: [B, T, H, D] roped chunk queries, row b's first at absolute
    position ``start[b]``; k_pages/v_pages: [P, ps, K, D] *post-write* pool
    (bf16, or int8 with ``k_scale``/``v_scale`` [P, ps, K] bf16); tables:
    [B, n_pages].  Gathers each row's logical view (int8 dequantized to
    fp32) and runs the chunked causal attend (``k_abs <= start + t``): fp32
    scores times ``scale``, one softmax at the row's true max,
    probabilities cast to the value dtype (bf16 pages) or kept fp32 (int8
    pages, whose dequantized values are fp32), fp32 PV sum, one cast at
    the output.  Returns [B, T, H, D] in ``q``'s dtype."""
    kg, vg = attention.gather_kv(k_pages, v_pages, tables, k_scale, v_scale)
    o = attention.chunked_attention(q, kg, vg, scale=scale, q_block=q_block,
                                    q_offset=start)
    return o.to(q.dtype)


# q, k, v, k_scale, v_scale, tables, start, out
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 \
    + [ctypes.c_float, ctypes.c_void_p]


def ragged_prefill(q, k_pages, v_pages, tables, start, *, scale: float,
                   window: int = 0, softcap: float = 0.0, k_scale=None,
                   v_scale=None):
    """Ragged chunk prefill; arguments as ``ragged_prefill_plain`` (the
    kernel tiles its own queries, so it takes no ``q_block``).  On a CUDA
    device ``q`` and the pools are contiguous bf16 (int8 payload plus
    contiguous bf16 scale pages when scales are given), ``tables`` and
    ``start`` contiguous int32, ``H % K == 0``, page size <= 32 and head
    dim 32 or 64; anything else raises.  The TPU kernel's other modes
    (``window``, ``softcap``) raise ``NotImplementedError``."""
    refuse_modes("ragged_prefill", window, softcap)
    if q.device.type == "cpu":
        return ragged_prefill_plain(q, k_pages, v_pages, tables, start,
                                    scale=scale, k_scale=k_scale,
                                    v_scale=v_scale)
    dev = q.device
    check_tensor(q, "q", torch.bfloat16, 4, dev)
    B, T, H, D = q.shape
    P, ps, K, Dk = check_pool("ragged_prefill", dev, k_pages, v_pages,
                              tables, k_scale, v_scale)
    check_tensor(start, "start", torch.int32, 1, dev)
    if Dk != D or H % K \
            or tables.shape[0] != B or start.shape[0] != B \
            or ps > 32 or D not in (32, 64):
        raise ValueError(
            f"ragged_prefill: unsupported shapes q {tuple(q.shape)}, pages "
            f"{tuple(k_pages.shape)}, tables {tuple(tables.shape)}, start "
            f"{tuple(start.shape)}")
    out = torch.empty_like(q)
    rc = entry("ragged_prefill", _ARGTYPES)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), ptr(k_scale),
        ptr(v_scale), tables.data_ptr(), start.data_ptr(), out.data_ptr(),
        B, T, H, K, D, ps, tables.shape[1], float(scale),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, "ragged_prefill")
    ragged_prefill.launches += 1
    return out


ragged_prefill.launches = 0
