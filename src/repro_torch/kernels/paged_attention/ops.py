"""One-token GQA decode straight from the paged KV pool (kernel K1).

``paged_decode`` replaces ``repro.kernels.paged_attention.ops
.paged_attention_decode`` (Pallas ``kernel.py::paged_decode_fwd``) in its
vanilla mode: no sliding window, no softcap, bf16 pages.  For CUDA tensors
it launches the hand-written kernel in ``csrc/paged_decode.cu`` (design and
bound in that file's note); for CPU tensors it runs ``paged_decode_plain``,
the plain PyTorch version of the same function, which is also the
reference backend's decode core and the kernel's oracle on the card.
"""
from __future__ import annotations

import ctypes

import torch

from .. import check_launch, check_tensor, entry, refuse_modes
from ...models import attention


def paged_decode_plain(q, k_pages, v_pages, tables, pos, *, scale: float):
    """q: [B, H, D]; k_pages/v_pages: [P, ps, K, D]; tables: [B, n_pages]
    physical page ids; pos: [B] absolute positions (the new token is already
    written).  Gathers the logical view and attends with ``idx <= pos``:
    fp32 scores and softmax, fp32 probability-weighted sum, one cast at the
    output.  Returns [B, H, D] in ``q``'s dtype."""
    kg = attention.gather_pages(k_pages, tables)
    vg = attention.gather_pages(v_pages, tables)
    valid = attention.decode_valid_mask(pos, kg.shape[1])
    o = attention.masked_token_attend(q, kg, vg, valid, scale=scale)
    return o.to(q.dtype)


_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 \
    + [ctypes.c_float, ctypes.c_void_p]


def paged_decode(q, k_pages, v_pages, tables, pos, *, scale: float,
                 window: int = 0, softcap: float = 0.0, k_scale=None,
                 v_scale=None):
    """Paged GQA decode; arguments as ``paged_decode_plain``.  On a CUDA
    device ``q`` and the pools are contiguous bf16, ``tables`` and ``pos``
    contiguous int32, ``H % K == 0`` with ``G = H // K <= 16``, page size
    <= 16 and head dim 32 or 64; anything else raises.  The TPU kernel's
    other modes (``window``, ``softcap``, int8 ``k_scale``/``v_scale``)
    raise ``NotImplementedError``."""
    refuse_modes("paged_decode", window, softcap, (k_scale, v_scale))
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pages, v_pages, tables, pos,
                                  scale=scale)
    dev = q.device
    B, H, D = q.shape
    check_tensor(q, "q", torch.bfloat16, 3, dev)
    check_tensor(k_pages, "k_pages", torch.bfloat16, 4, dev)
    check_tensor(v_pages, "v_pages", torch.bfloat16, 4, dev)
    check_tensor(tables, "tables", torch.int32, 2, dev)
    check_tensor(pos, "pos", torch.int32, 1, dev)
    P, ps, K, Dk = k_pages.shape
    if v_pages.shape != k_pages.shape or Dk != D or H % K \
            or tables.shape[0] != B or pos.shape[0] != B \
            or H // K > 16 or ps > 16 or D not in (32, 64):
        raise ValueError(
            f"paged_decode: unsupported shapes q {tuple(q.shape)}, pages "
            f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}, tables "
            f"{tuple(tables.shape)}, pos {tuple(pos.shape)}")
    out = torch.empty_like(q)
    rc = entry("paged_decode", _ARGTYPES)(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            tables.data_ptr(), pos.data_ptr(), out.data_ptr(), B, K, H // K,
            D, ps, tables.shape[1], float(scale),
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, "paged_decode")
    paged_decode.launches += 1
    return out


paged_decode.launches = 0
