"""Ragged chunk prefill against the paged pool: kernel K2 (full attention,
post-write pool) and kernel K4 (sliding window, pre-write page ring plus
the chunk's fresh K/V).

``ragged_prefill`` replaces ``repro.kernels.ragged_prefill.ops
.ragged_prefill_attend`` with ``window == 0`` (Pallas
``kernel.py::ragged_prefill_fwd``) and ``windowed_prefill`` replaces it
with ``window > 0`` (Pallas ``kernel.py::windowed_ragged_prefill_fwd``),
each with bf16 pages or int8 pages plus bf16 scale pages.  For CUDA
tensors they launch the hand-written kernels in ``csrc/ragged_prefill.cu``
and ``csrc/windowed_ragged_prefill.cu`` (design and bound in each file's
note); for CPU tensors they run ``ragged_prefill_plain`` and
``windowed_prefill_plain``, the plain PyTorch versions of the same
functions, which are also the reference backend's prefill cores and the
kernels' oracles on the card.

``mla_ragged_prefill`` (kernel K6, ``csrc/mla_ragged_prefill.cu``)
replaces ``mla_ragged_prefill_attend`` (Pallas
``kernel.py::mla_ragged_prefill_fwd``): the MLA chunk prefill against the
post-write latent pages (bf16, or int8 plus bf16 per-slot scale pages),
per-head K/V materialized from the latent inside the kernel;
``mla_ragged_prefill_plain`` is its plain version.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import (check_latent_pool, check_launch, check_pool, check_tensor,
                entry, ptr, refuse_softcap)
from ...models import attention, mla


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


def windowed_prefill_plain(q, k_new, v_new, k_pages, v_pages, tables, start,
                           n_live, *, window: int, scale: float,
                           q_block: int = 512, k_scale=None, v_scale=None):
    """q: [B, T, H, D] roped chunk queries at per-row offsets ``start``;
    k_new/v_new: [B, T, K, D] the chunk's fresh roped K/V at model
    precision; k_pages/v_pages: [P, ps, K, D] the *pre-write* pool (bf16,
    or int8 with ``k_scale``/``v_scale`` [P, ps, K] bf16); tables: [B,
    n_ring] the page rings; n_live: [B] real chunk tokens.  Gathers each
    row's ring (int8 dequantized to fp32, and then the fresh K/V promoted
    to fp32 too, so probabilities stay fp32 end to end) and runs
    ``attention.ring_chunk_attention``: ring slots masked by the position
    recovered relative to ``start - 1`` and by the window, fresh keys by
    the causal + window rule and ``t < n_live``, one softmax over both.
    Rows ``t >= n_live`` (chunk padding, which the caller discards) are
    zeros.  Returns [B, T, H, D] in ``q``'s dtype."""
    kr, vr = attention.gather_kv(k_pages, v_pages, tables, k_scale, v_scale)
    if k_scale is not None:
        k_new, v_new = k_new.float(), v_new.float()
    o = attention.ring_chunk_attention(q, k_new, v_new, kr, vr, start,
                                       n_live, window=window, scale=scale,
                                       q_block=q_block).to(q.dtype)
    live = torch.arange(q.shape[1], device=q.device)[None, :] \
        < n_live.reshape(-1, 1)
    return torch.where(live[:, :, None, None], o, torch.zeros_like(o))


HEAD_DIMS = (32, 64, 128)        # csrc/ragged_prefill.cu launch()


def check_prefill_shapes(q_shape, page_shape, tables_shape, start_shape):
    """Raise ``ValueError`` unless K2 takes these shapes: q [B, T, H, D]
    against pages [P, ps, K, D] with ``H % K == 0``, tables [B, n] and
    start [B], page size <= 32 and head dim 32, 64 or 128."""
    B, T, H, D = q_shape
    P, ps, K, Dk = page_shape
    if Dk != D or H % K or tables_shape[0] != B or start_shape[0] != B \
            or ps > 32 or D not in HEAD_DIMS:
        raise ValueError(
            f"ragged_prefill: unsupported shapes q {tuple(q_shape)}, pages "
            f"{tuple(page_shape)}, tables {tuple(tables_shape)}, start "
            f"{tuple(start_shape)}")


# q, k, v, k_scale, v_scale, tables, start, out
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 \
    + [ctypes.c_float, ctypes.c_void_p]


def ragged_prefill(q, k_pages, v_pages, tables, start, *, scale: float,
                   softcap: float = 0.0, k_scale=None, v_scale=None):
    """Ragged chunk prefill; arguments as ``ragged_prefill_plain`` (the
    kernel tiles its own queries, so it takes no ``q_block``).  On a CUDA
    device ``q`` and the pools are contiguous bf16 (int8 payload plus
    contiguous bf16 scale pages when scales are given), ``tables`` and
    ``start`` contiguous int32, ``H % K == 0``, page size <= 32 and head
    dim 32, 64 or 128 (``check_prefill_shapes``); anything else raises.
    The sliding-window mode is K4 (``windowed_prefill``); ``softcap``
    raises ``NotImplementedError``."""
    refuse_softcap("ragged_prefill", softcap)
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
    check_prefill_shapes(q.shape, k_pages.shape, tables.shape, start.shape)
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


# q, k_new, v_new, k, v, k_scale, v_scale, tables, start, n_live, out, then
# B, T, H, K, D, ps, n_ring, window, scale, stream
_WINDOWED_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 \
    + [ctypes.c_float, ctypes.c_void_p]


def windowed_prefill(q, k_new, v_new, k_pages, v_pages, tables, start,
                     n_live, *, window: int, scale: float,
                     softcap: float = 0.0, k_scale=None, v_scale=None):
    """Sliding-window chunk prefill (K4); arguments as
    ``windowed_prefill_plain`` (the kernel tiles its own queries, so it
    takes no ``q_block``).  On a CUDA device ``q``, ``k_new``, ``v_new``
    and the pools are contiguous bf16 (int8 payload plus contiguous bf16
    scale pages when scales are given; the fresh K/V stay bf16),
    ``tables``, ``start`` and ``n_live`` contiguous int32, ``H % K == 0``,
    page size <= 32, head dim 32, 64 or 128 and ``window > 0``; anything
    else raises.  ``softcap`` raises ``NotImplementedError``."""
    refuse_softcap("windowed_prefill", softcap)
    if q.device.type == "cpu":
        return windowed_prefill_plain(q, k_new, v_new, k_pages, v_pages,
                                      tables, start, n_live, window=window,
                                      scale=scale, k_scale=k_scale,
                                      v_scale=v_scale)
    dev = q.device
    check_tensor(q, "q", torch.bfloat16, 4, dev)
    B, T, H, D = q.shape
    P, ps, K, Dk = check_pool("windowed_prefill", dev, k_pages, v_pages,
                              tables, k_scale, v_scale)
    check_tensor(k_new, "k_new", torch.bfloat16, 4, dev)
    check_tensor(v_new, "v_new", torch.bfloat16, 4, dev)
    check_tensor(start, "start", torch.int32, 1, dev)
    check_tensor(n_live, "n_live", torch.int32, 1, dev)
    if Dk != D or H % K or tuple(k_new.shape) != (B, T, K, D) \
            or v_new.shape != k_new.shape or tables.shape[0] != B \
            or start.shape[0] != B or n_live.shape[0] != B or ps > 32 \
            or D not in HEAD_DIMS or window <= 0:
        raise ValueError(
            f"windowed_prefill: unsupported shapes q {tuple(q.shape)}, "
            f"k_new {tuple(k_new.shape)}, pages {tuple(k_pages.shape)}, "
            f"tables {tuple(tables.shape)}, start {tuple(start.shape)}, "
            f"n_live {tuple(n_live.shape)}, window {window}")
    out = torch.empty_like(q)
    rc = entry("windowed_ragged_prefill", _WINDOWED_ARGTYPES)(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), ptr(k_scale), ptr(v_scale), tables.data_ptr(),
        start.data_ptr(), n_live.data_ptr(), out.data_ptr(), B, T, H, K, D,
        ps, tables.shape[1], int(window), float(scale),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, "windowed_prefill")
    windowed_prefill.launches += 1
    return out


windowed_prefill.launches = 0


def mla_ragged_prefill_plain(q, ckv_pages, krope_pages, wkv_b, tables, start,
                             *, nope: int, q_block: int = 512,
                             ckv_scale=None, krope_scale=None):
    """q: [B, T, H, nope + R] roped chunk queries (rope part roped), row b's
    first at absolute position ``start[b]``; ckv_pages: [P, ps, L] and
    krope_pages: [P, ps, R] the *post-write* latent pages (bf16, or int8
    with ``ckv_scale``/``krope_scale`` [P, ps] bf16); wkv_b: [L, H, nope +
    v]; tables: [B, n_pages].  ``mla.mla_materialized_prefill_attend``:
    per-head K/V materialized from the gathered latent (one einsum: for
    bf16 pages fp64 sums rounded to fp32, then to bf16; fp32 from the
    latent dequantized as ``f32(q) * f32(s)`` for int8 pages, with
    ``wkv_b`` promoted to fp32), then the chunked causal attend (fp32
    scores times ``1 / sqrt(nope + R)``, one softmax at the row's true max,
    probabilities cast to the K/V dtype -- bf16, or kept fp32 for int8 --,
    fp32 PV sum, one cast).  Every row is computed, chunk padding too.
    Returns [B, T, H, v] in ``q``'s dtype."""
    return mla.mla_materialized_prefill_attend(
        q, ckv_pages, krope_pages, wkv_b, tables, start, nope=nope,
        q_block=q_block, ckv_scale=ckv_scale,
        krope_scale=krope_scale).to(q.dtype)


# q, ckv, krope, ckv_scale, krope_scale, wkv_b, tables, start, out, then B,
# H, Tp, L, nope, R, vd, ps, n_pages, scale, stream
_MLA_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 \
    + [ctypes.c_float, ctypes.c_void_p]
MLA_DIMS = (512, 128, 64, 128)   # csrc/mla_ragged_prefill.cu: L, nope, R, v
MLA_Q_BLOCK = 128                # the TPU wrapper's q_blk


def mla_ragged_prefill(q, ckv_pages, krope_pages, wkv_b, tables, start, *,
                       nope: int, ckv_scale=None, krope_scale=None):
    """MLA ragged chunk prefill (K6); arguments as
    ``mla_ragged_prefill_plain`` (the kernel tiles its own queries, so it
    takes no ``q_block``).  As the TPU wrapper does, the queries go
    head-major ([B, H, T, E]) with the token axis padded to a multiple of
    the q block ``min(128, T rounded up to 8)``; the padding rows are
    computed and dropped.  On a CUDA device ``q`` and ``wkv_b`` are bf16
    (``wkv_b`` contiguous), the latent pages contiguous bf16 (or int8 with
    both scale pages, contiguous bf16 [P, ps]), ``tables`` and ``start``
    contiguous int32, L = 512, nope = 128, R = 64, v = 128 (deepseek-v2)
    and 16-token pages; anything else raises."""
    if q.device.type == "cpu":
        return mla_ragged_prefill_plain(q, ckv_pages, krope_pages, wkv_b,
                                        tables, start, nope=nope,
                                        ckv_scale=ckv_scale,
                                        krope_scale=krope_scale)
    dev = q.device
    B, T, H, E = q.shape
    P, ps, L, R = check_latent_pool("mla_ragged_prefill", dev, ckv_pages,
                                    krope_pages, tables, ckv_scale,
                                    krope_scale)
    vd = wkv_b.shape[2] - nope
    check_tensor(wkv_b, "wkv_b", torch.bfloat16, 3, dev)
    check_tensor(start, "start", torch.int32, 1, dev)
    if q.dtype != torch.bfloat16 or (L, nope, R, vd) != MLA_DIMS \
            or E != nope + R or ps != 16 \
            or tuple(wkv_b.shape[:2]) != (L, H) or tables.shape[0] != B \
            or start.shape[0] != B:
        raise ValueError(
            f"mla_ragged_prefill: unsupported shapes q {tuple(q.shape)} "
            f"{q.dtype}, ckv {tuple(ckv_pages.shape)}, krope "
            f"{tuple(krope_pages.shape)}, wkv_b {tuple(wkv_b.shape)}, tables "
            f"{tuple(tables.shape)}, start {tuple(start.shape)}")
    blk = min(MLA_Q_BLOCK, -(-T // 8) * 8)
    Tp = -(-T // blk) * blk
    qg = torch.zeros((B, H, Tp, E), dtype=q.dtype, device=dev)
    qg[:, :, :T] = q.transpose(1, 2)
    out = torch.empty((B, H, Tp, vd), dtype=q.dtype, device=dev)
    rc = entry("mla_ragged_prefill", _MLA_ARGTYPES)(
        qg.data_ptr(), ckv_pages.data_ptr(), krope_pages.data_ptr(),
        ptr(ckv_scale), ptr(krope_scale), wkv_b.data_ptr(),
        tables.data_ptr(), start.data_ptr(), out.data_ptr(), B, H, Tp, L,
        nope, R, vd, ps, tables.shape[1], float(1.0 / math.sqrt(nope + R)),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, "mla_ragged_prefill")
    mla_ragged_prefill.launches += 1
    return out[:, :, :T].transpose(1, 2)


mla_ragged_prefill.launches = 0
