"""Ragged chunk prefill against the post-write paged pool (kernel K2).

``ragged_prefill`` replaces ``repro.kernels.ragged_prefill.ops
.ragged_prefill_attend`` (Pallas ``kernel.py::ragged_prefill_fwd``) in its
bf16 mode.  For CUDA tensors it launches the hand-written kernel in
``csrc/ragged_prefill.cu`` (design and bound in that file's note); for CPU
tensors it runs ``ragged_prefill_plain``, the plain PyTorch version of the
same function, which is also the reference backend's prefill core and the
kernel's oracle on the card.
"""
from __future__ import annotations

import ctypes

import torch

from .. import check_launch, check_tensor, entry, refuse_modes
from ...models import attention


def ragged_prefill_plain(q, k_pages, v_pages, tables, start, *,
                         scale: float, q_block: int = 512):
    """q: [B, T, H, D] roped chunk queries, row b's first at absolute
    position ``start[b]``; k_pages/v_pages: [P, ps, K, D] *post-write* pool;
    tables: [B, n_pages].  Gathers each row's logical view and runs the
    chunked causal attend (``k_abs <= start + t``): fp32 scores times
    ``scale``, one softmax
    at the row's true max, probabilities cast to the value dtype, fp32 PV
    sum, one cast at the output.  Returns [B, T, H, D] in ``q``'s dtype."""
    kg = attention.gather_pages(k_pages, tables)
    vg = attention.gather_pages(v_pages, tables)
    o = attention.chunked_attention(q, kg, vg, scale=scale, q_block=q_block,
                                    q_offset=start)
    return o.to(q.dtype)


_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 \
    + [ctypes.c_float, ctypes.c_void_p]


def ragged_prefill(q, k_pages, v_pages, tables, start, *, scale: float,
                   window: int = 0, softcap: float = 0.0, k_scale=None,
                   v_scale=None):
    """Ragged chunk prefill; arguments as ``ragged_prefill_plain`` (the
    kernel tiles its own queries, so it takes no ``q_block``).  On a CUDA
    device ``q`` and the pools are contiguous bf16, ``tables`` and ``start``
    contiguous int32, ``H % K == 0``, page size <= 32 and head dim 32 or
    64; anything else raises.  The TPU kernel's other modes (``window``,
    ``softcap``, int8 ``k_scale``/``v_scale``) raise
    ``NotImplementedError``."""
    refuse_modes("ragged_prefill", window, softcap, (k_scale, v_scale))
    if q.device.type == "cpu":
        return ragged_prefill_plain(q, k_pages, v_pages, tables, start,
                                    scale=scale)
    dev = q.device
    B, T, H, D = q.shape
    check_tensor(q, "q", torch.bfloat16, 4, dev)
    check_tensor(k_pages, "k_pages", torch.bfloat16, 4, dev)
    check_tensor(v_pages, "v_pages", torch.bfloat16, 4, dev)
    check_tensor(tables, "tables", torch.int32, 2, dev)
    check_tensor(start, "start", torch.int32, 1, dev)
    P, ps, K, Dk = k_pages.shape
    if v_pages.shape != k_pages.shape or Dk != D or H % K \
            or tables.shape[0] != B or start.shape[0] != B \
            or ps > 32 or D not in (32, 64):
        raise ValueError(
            f"ragged_prefill: unsupported shapes q {tuple(q.shape)}, pages "
            f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}, tables "
            f"{tuple(tables.shape)}, start {tuple(start.shape)}")
    out = torch.empty_like(q)
    rc = entry("ragged_prefill", _ARGTYPES)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        tables.data_ptr(), start.data_ptr(), out.data_ptr(), B, T, H, K, D,
        ps, tables.shape[1], float(scale),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, "ragged_prefill")
    ragged_prefill.launches += 1
    return out


ragged_prefill.launches = 0
