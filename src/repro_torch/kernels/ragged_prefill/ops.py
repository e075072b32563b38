"""Ragged chunk prefill against the paged pool: kernel K2 (full attention,
post-write pool) and kernel K4 (sliding window, pre-write page ring plus
the chunk's fresh K/V).

``ragged_prefill`` replaces ``repro.kernels.ragged_prefill.ops
.ragged_prefill_attend`` with ``window == 0`` (Pallas
``kernel.py::ragged_prefill_fwd``) and ``windowed_prefill`` replaces it
with ``window > 0`` (Pallas ``kernel.py::windowed_ragged_prefill_fwd``),
each with bf16 pages or int8 pages plus bf16 scale pages, and each with
the TPU kernels' logit softcap (``softcap > 0``: every scaled score
becomes ``softcap * tanh(s / softcap)`` before the mask).  For CUDA
tensors they launch the hand-written kernels in ``csrc/ragged_prefill.cu``
and ``csrc/windowed_ragged_prefill.cu`` (design and bound in each file's
note); for CPU tensors they run ``ragged_prefill_plain`` and
``windowed_prefill_plain``, the plain PyTorch versions of the same
functions, which are also the reference backend's prefill cores and the
kernels' oracles on the card.

``mla_ragged_prefill`` (kernel K6) replaces ``mla_ragged_prefill_attend``
(Pallas ``kernel.py::mla_ragged_prefill_fwd``): the MLA chunk prefill
against the post-write latent pages (bf16, or int8 plus bf16 per-slot
scale pages).  It runs two kernels: ``mla_build_kv`` (stage A,
``csrc/mla_build_kv.cu``) builds every head's K/V of every key once into a
workspace, then the attend (stage B, ``csrc/mla_ragged_prefill.cu``) reads
it; ``mla_ragged_prefill_plain`` and ``mla_build_kv_plain`` are their plain
versions.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import (check_latent_pool, check_launch, check_pool, check_tensor,
                entry, ptr)
from ...models import attention, mla


def ragged_prefill_plain(q, k_pages, v_pages, tables, start, *,
                         scale: float, q_block: int = 512,
                         softcap: float = 0.0, k_scale=None, v_scale=None):
    """q: [B, T, H, D] roped chunk queries, row b's first at absolute
    position ``start[b]``; k_pages/v_pages: [P, ps, K, D] *post-write* pool
    (bf16, or int8 with ``k_scale``/``v_scale`` [P, ps, K] bf16); tables:
    [B, n_pages].  Gathers each row's logical view (int8 dequantized to
    fp32) and runs the chunked causal attend (``k_abs <= start + t``): fp32
    scores times ``scale``, capped at ``softcap`` (``attention.logit_cap``)
    before the mask, one softmax at the row's true max,
    probabilities cast to the value dtype (bf16 pages) or kept fp32 (int8
    pages, whose dequantized values are fp32), fp32 PV sum, one cast at
    the output.  Returns [B, T, H, D] in ``q``'s dtype."""
    kg, vg = attention.gather_kv(k_pages, v_pages, tables, k_scale, v_scale)
    o = attention.chunked_attention(q, kg, vg, scale=scale, q_block=q_block,
                                    q_offset=start, softcap=softcap)
    return o.to(q.dtype)


def windowed_prefill_plain(q, k_new, v_new, k_pages, v_pages, tables, start,
                           n_live, *, window: int, scale: float,
                           q_block: int = 512, softcap: float = 0.0,
                           k_scale=None, v_scale=None):
    """q: [B, T, H, D] roped chunk queries at per-row offsets ``start``;
    k_new/v_new: [B, T, K, D] the chunk's fresh roped K/V at model
    precision; k_pages/v_pages: [P, ps, K, D] the *pre-write* pool (bf16,
    or int8 with ``k_scale``/``v_scale`` [P, ps, K] bf16); tables: [B,
    n_ring] the page rings; n_live: [B] real chunk tokens.  Gathers each
    row's ring (int8 dequantized to fp32, and then the fresh K/V promoted
    to fp32 too, so probabilities stay fp32 end to end) and runs
    ``attention.ring_chunk_attention``: ring slots masked by the position
    recovered relative to ``start - 1`` and by the window, fresh keys by
    the causal + window rule and ``t < n_live``, scores capped at
    ``softcap`` before the masks, one softmax over both.
    Rows ``t >= n_live`` (chunk padding, which the caller discards) are
    zeros.  Returns [B, T, H, D] in ``q``'s dtype."""
    kr, vr = attention.gather_kv(k_pages, v_pages, tables, k_scale, v_scale)
    if k_scale is not None:
        k_new, v_new = k_new.float(), v_new.float()
    o = attention.ring_chunk_attention(q, k_new, v_new, kr, vr, start,
                                       n_live, window=window, scale=scale,
                                       q_block=q_block,
                                       softcap=softcap).to(q.dtype)
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


# q, k, v, k_scale, v_scale, tables, start, out, then B, T, H, K, D, ps,
# n_pages, scale, softcap, stream
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 \
    + [ctypes.c_float] * 2 + [ctypes.c_void_p]


def ragged_prefill(q, k_pages, v_pages, tables, start, *, scale: float,
                   softcap: float = 0.0, k_scale=None, v_scale=None):
    """Ragged chunk prefill; arguments as ``ragged_prefill_plain`` (the
    kernel tiles its own queries, so it takes no ``q_block``).  On a CUDA
    device ``q`` and the pools are contiguous bf16 (int8 payload plus
    contiguous bf16 scale pages when scales are given), ``tables`` and
    ``start`` contiguous int32, ``H % K == 0``, page size <= 32 and head
    dim 32, 64 or 128 (``check_prefill_shapes``); anything else raises (a
    negative ``softcap`` too, from the kernel's entry point).  The
    sliding-window mode is K4 (``windowed_prefill``)."""
    if q.device.type == "cpu":
        return ragged_prefill_plain(q, k_pages, v_pages, tables, start,
                                    scale=scale, softcap=softcap,
                                    k_scale=k_scale, v_scale=v_scale)
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
        B, T, H, K, D, ps, tables.shape[1], float(scale), float(softcap),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, "ragged_prefill")
    ragged_prefill.launches += 1
    return out


ragged_prefill.launches = 0


# q, k_new, v_new, k, v, k_scale, v_scale, tables, start, n_live, out, then
# B, T, H, K, D, ps, n_ring, window, scale, softcap, stream
_WINDOWED_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 \
    + [ctypes.c_float] * 2 + [ctypes.c_void_p]


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
    else raises (a negative ``softcap`` too, from the kernel's entry
    point)."""
    if q.device.type == "cpu":
        return windowed_prefill_plain(q, k_new, v_new, k_pages, v_pages,
                                      tables, start, n_live, window=window,
                                      scale=scale, softcap=softcap,
                                      k_scale=k_scale, v_scale=v_scale)
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
        ps, tables.shape[1], int(window), float(scale), float(softcap),
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


# csrc/mla_build_kv.cu and mla_ragged_prefill.cu: L, nope, R, v; keys a
# stage-A block and a stage-B tile
MLA_DIMS = (512, 128, 64, 128)
MLA_KEY_TILE = 64


def mla_kv_rows(n_pages: int, ps: int) -> int:
    """Rows a request has in K6's K/V workspace: every key of its table,
    rounded up to a whole 64-key tile."""
    return -(-n_pages * ps // MLA_KEY_TILE) * MLA_KEY_TILE


def mla_built_keys(start, T: int, n_pages: int, ps: int):
    """[B] keys stage A builds for each request: its pages up to the one
    holding the chunk's last row (padding rows too), within the table."""
    return torch.clamp((start.long() + T - 1) // ps + 1, max=n_pages) * ps


def mla_build_kv_plain(ckv_pages, wkv_b, tables, start, T: int, *,
                       ckv_scale=None):
    """K6's stage A in plain PyTorch: every head's K (nope part) and V of
    the keys ``mla_built_keys`` gives, ws [B, H, S, W] bf16 with S =
    ``mla_kv_rows``, the other rows zeros.  bf16 pages: W = nope + v, the
    einsum of ``mla.materialized_attend`` (fp64 sums rounded once to fp32,
    then to bf16).  int8 pages: x = the fp32 einsum of the latent
    dequantized as ``f32(q) * f32(s)``, stored as W = 2 (nope + v) columns,
    hi = bf16(x) then lo = bf16(x - hi)."""
    B, n_pages = tables.shape
    ps = ckv_pages.shape[1]
    cc = attention.gather_pages(ckv_pages, tables)
    if ckv_scale is None:
        kv = torch.einsum("bsl,lhe->bhse", cc.double(),
                          wkv_b.double()).float().bfloat16()
    else:
        x = torch.einsum("bsl,lhe->bhse", attention.dequant_int8(
            cc, attention.gather_pages(ckv_scale, tables)), wkv_b.float())
        hi = x.bfloat16()
        kv = torch.cat([hi, (x - hi.float()).bfloat16()], -1)
    keys = torch.arange(n_pages * ps, device=kv.device)
    built = keys[None, :] < mla_built_keys(start, T, n_pages, ps)[:, None]
    ws = torch.zeros(kv.shape[:2] + (mla_kv_rows(n_pages, ps),
                                     kv.shape[3]),
                     dtype=torch.bfloat16, device=kv.device)
    ws[:, :, :n_pages * ps] = kv.masked_fill(~built[:, None, :, None], 0)
    return ws


# ckv, ckv_scale, wkv_b, tables, start, ws, then B, T, H, L, nope, vd, ps,
# n_pages, S, stream
_KV_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 \
    + [ctypes.c_void_p]


def mla_build_kv(ckv_pages, wkv_b, tables, start, T: int, *, nope: int,
                 ckv_scale=None):
    """K6's stage A (``csrc/mla_build_kv.cu``); arguments as
    ``mla_build_kv_plain`` plus the nope width, and its values, but that
    rows past a request's built keys are zeros only within its last 64-key
    tile and not written past it.  On a CUDA device the latent pages are
    contiguous bf16 (or int8 with contiguous bf16 ``ckv_scale`` [P, ps]),
    ``wkv_b`` contiguous bf16, ``tables`` and ``start`` contiguous int32,
    L = 512, nope = v = 128 and 16-token pages; anything else raises."""
    if ckv_pages.device.type == "cpu":
        return mla_build_kv_plain(ckv_pages, wkv_b, tables, start, T,
                                  ckv_scale=ckv_scale)
    dev = ckv_pages.device
    check_tensor(ckv_pages, "ckv_pages",
                 torch.bfloat16 if ckv_scale is None else torch.int8, 3, dev)
    if ckv_scale is not None:
        check_tensor(ckv_scale, "ckv_scale", torch.bfloat16, 2, dev)
    check_tensor(wkv_b, "wkv_b", torch.bfloat16, 3, dev)
    check_tensor(tables, "tables", torch.int32, 2, dev)
    check_tensor(start, "start", torch.int32, 1, dev)
    B, n_pages = tables.shape
    P, ps, L = ckv_pages.shape
    H, vd = wkv_b.shape[1], wkv_b.shape[2] - nope
    if (L, nope, vd) != MLA_DIMS[:2] + MLA_DIMS[3:] or ps != 16 \
            or wkv_b.shape[0] != L or start.shape[0] != B or T < 1 \
            or (ckv_scale is not None
                and tuple(ckv_scale.shape) != (P, ps)):
        raise ValueError(
            f"mla_build_kv: unsupported shapes ckv {tuple(ckv_pages.shape)}, "
            f"wkv_b {tuple(wkv_b.shape)}, tables {tuple(tables.shape)}, "
            f"start {tuple(start.shape)}, T {T}")
    S = mla_kv_rows(n_pages, ps)
    planes = 1 if ckv_scale is None else 2
    ws = torch.empty((B, H, S, planes * (nope + vd)), dtype=torch.bfloat16,
                     device=dev)
    rc = entry("mla_build_kv", _KV_ARGTYPES)(
        ckv_pages.data_ptr(), ptr(ckv_scale), wkv_b.data_ptr(),
        tables.data_ptr(), start.data_ptr(), ws.data_ptr(), B, T, H, L, nope,
        vd, ps, n_pages, S, torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, "mla_build_kv")
    mla_build_kv.launches += 1
    return ws


mla_build_kv.launches = 0


# q, ws, krope, krope_scale, tables, start, out, then B, T, H, E, R, vd,
# ps, n_pages, S, scale, stream
_MLA_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 \
    + [ctypes.c_float, ctypes.c_void_p]


def mla_ragged_prefill(q, ckv_pages, krope_pages, wkv_b, tables, start, *,
                       nope: int, ckv_scale=None, krope_scale=None):
    """MLA ragged chunk prefill (K6); arguments as
    ``mla_ragged_prefill_plain`` (the kernel tiles its own queries, so it
    takes no ``q_block``).  On a CUDA device it launches stage A
    (``mla_build_kv``: every key's K/V of every head, once, into a
    workspace) and then stage B (the causal attend over the workspace and
    the rope-key pages, ``csrc/mla_ragged_prefill.cu``), which reads q
    [B, T, H, E] and writes [B, T, H, v] in place, rows past T untouched.
    There ``q`` is contiguous bf16, ``wkv_b`` contiguous bf16, the latent
    pages contiguous bf16 (or int8 with both scale pages, contiguous bf16
    [P, ps]), ``tables`` and ``start`` contiguous int32, L = 512, nope =
    128, R = 64, v = 128 (deepseek-v2) and 16-token pages; anything else
    raises."""
    if q.device.type == "cpu":
        return mla_ragged_prefill_plain(q, ckv_pages, krope_pages, wkv_b,
                                        tables, start, nope=nope,
                                        ckv_scale=ckv_scale,
                                        krope_scale=krope_scale)
    dev = q.device
    check_tensor(q, "q", torch.bfloat16, 4, dev)
    B, T, H, E = q.shape
    P, ps, L, R = check_latent_pool("mla_ragged_prefill", dev, ckv_pages,
                                    krope_pages, tables, ckv_scale,
                                    krope_scale)
    vd = wkv_b.shape[2] - nope
    check_tensor(wkv_b, "wkv_b", torch.bfloat16, 3, dev)
    check_tensor(start, "start", torch.int32, 1, dev)
    if (L, nope, R, vd) != MLA_DIMS or E != nope + R or ps != 16 \
            or tuple(wkv_b.shape[:2]) != (L, H) or tables.shape[0] != B \
            or start.shape[0] != B:
        raise ValueError(
            f"mla_ragged_prefill: unsupported shapes q {tuple(q.shape)} "
            f"{q.dtype}, ckv {tuple(ckv_pages.shape)}, krope "
            f"{tuple(krope_pages.shape)}, wkv_b {tuple(wkv_b.shape)}, tables "
            f"{tuple(tables.shape)}, start {tuple(start.shape)}")
    ws = mla_build_kv(ckv_pages, wkv_b, tables, start, T, nope=nope,
                      ckv_scale=ckv_scale)
    out = torch.empty((B, T, H, vd), dtype=q.dtype, device=dev)
    rc = entry("mla_ragged_prefill", _MLA_ARGTYPES)(
        q.data_ptr(), ws.data_ptr(), krope_pages.data_ptr(), ptr(krope_scale),
        tables.data_ptr(), start.data_ptr(), out.data_ptr(), B, T, H, E, R,
        vd, ps, tables.shape[1], ws.shape[2],
        float(1.0 / math.sqrt(nope + R)),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, "mla_ragged_prefill")
    mla_ragged_prefill.launches += 1
    return out


mla_ragged_prefill.launches = 0
