"""Paged GQA decode (kernel K1) and small-q speculative verify (kernel K3)
straight from the paged KV pool.

``paged_decode`` replaces ``repro.kernels.paged_attention.ops
.paged_attention_decode`` (Pallas ``kernel.py::paged_decode_fwd``) and
``paged_verify`` replaces ``paged_attention_verify`` (Pallas
``kernel.py::paged_verify_fwd``), each with bf16 pages or int8 pages plus
bf16 scale pages (``k_scale``/``v_scale``), and each with the TPU kernels'
sliding-window ring mode (``window > 0``: the table is a ring of ``n_pages
* ps`` token slots and each slot's absolute position is recovered from the
ring layout), and each with the TPU kernels' logit softcap (``softcap >
0``: every scaled score becomes ``softcap * tanh(s / softcap)`` before the
mask).  Both kernels are instances of one CUDA body
(``csrc/paged_attention.cuh``, design and bound in its note): a row's keys
split over blocks at 16 absolute pages, each split's partial written to a
workspace the wrapper allocates (``split_workspace``) and merged in split
order by a second kernel of the same call.  K1 is its one-query case, so
K3 with one live query per row reproduces K1 bit for bit, ring mode
included.  For CPU tensors each wrapper runs its plain PyTorch version,
which is also the reference backend's core and the kernel's oracle on
the card.

``mla_paged_decode`` (kernel K5) replaces ``mla_paged_attention_decode``
(Pallas ``kernel.py::mla_paged_decode_fwd``) and ``mla_paged_verify``
(kernel K7) replaces ``mla_paged_attention_verify`` (Pallas
``kernel.py::mla_paged_verify_fwd``): the absorbed-latent MLA decode and
small-q verify against bf16 latent pages, or int8 latent pages plus bf16
per-slot scale pages (``ckv_scale``/``krope_scale``).  Both are instances
of one CUDA body (``csrc/mla_attention.cuh``, design and bound in its
note): a request's (query token, head) rows in 64-row tensor-core tiles,
their keys split over blocks at 8 absolute pages, each split's partial
written to a workspace the wrapper allocates (``mla_split_workspace``)
and merged in split order by a second kernel of the same call.  K5 is its
one-query case, so K7 with one live query reproduces K5 bit for bit.
Their plain versions are ``mla_paged_decode_plain`` and
``mla_paged_verify_plain``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import (check_latent_pool, check_launch, check_pool, check_tensor,
                entry, ptr)
from ...models import attention, mla


def paged_decode_plain(q, k_pages, v_pages, tables, pos, *, scale: float,
                       window: int = 0, softcap: float = 0.0, k_scale=None,
                       v_scale=None):
    """q: [B, H, D]; k_pages/v_pages: [P, ps, K, D] (bf16, or int8 with
    ``k_scale``/``v_scale`` [P, ps, K] bf16); tables: [B, n_pages] physical
    page ids; pos: [B] absolute positions (the new token is already
    written).  Gathers the logical view (int8 dequantized to fp32 as
    ``f32(q) * f32(s)``) and attends with ``idx <= pos`` (``window > 0``:
    the ring rule of ``attention.decode_valid_mask`` over ``n_pages * ps``
    slots): fp32 scores, capped at ``softcap`` (``attention.logit_cap``)
    before the mask, fp32 softmax and probability-weighted sum, one cast at
    the output.  Returns [B, H, D] in ``q``'s dtype."""
    kg, vg = attention.gather_kv(k_pages, v_pages, tables, k_scale, v_scale)
    valid = attention.decode_valid_mask(pos, kg.shape[1], window=window)
    o = attention.masked_token_attend(q, kg, vg, valid, scale=scale,
                                      softcap=softcap)
    return o.to(q.dtype)


def paged_verify_plain(q, k_pages, v_pages, tables, pos, n_q, *,
                       scale: float, window: int = 0, softcap: float = 0.0,
                       k_scale=None, v_scale=None):
    """q: [B, Q, H, D], query j of row b at absolute position
    ``pos[b] + j`` (all Q queries' K/V already written); n_q: [B] live
    query counts.  Pools, tables, ``window`` and ``softcap`` as
    ``paged_decode_plain``.
    Each live query attends ``idx <= pos + j`` (or the ring rule at ``pos
    + j``); dead rows (``j >= n_q``) are exact zeros.  Returns [B, Q, H, D]
    in ``q``'s dtype."""
    kg, vg = attention.gather_kv(k_pages, v_pages, tables, k_scale, v_scale)
    valid = attention.verify_valid_mask(pos, n_q, q.shape[1], kg.shape[1],
                                        window=window)
    o = attention.masked_multi_token_attend(q, kg, vg, valid, scale=scale,
                                            softcap=softcap)
    return o.to(q.dtype)


# decode: q, k, v, k_scale, v_scale, tables, pos, out, workspace, its
# bytes, then B, K, G, D, ps, n_pages, window, scale, softcap, stream;
# verify adds n_q after pos and Q after B
_DECODE_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_longlong] \
    + [ctypes.c_int] * 7 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
_VERIFY_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_longlong] \
    + [ctypes.c_int] * 8 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
MAX_ROWS = {"paged_decode": 16, "paged_verify": 48}   # csrc kMaxRows
HEAD_DIMS = (32, 64, 128)                              # csrc launch()
SPLIT_PAGES = 16                                       # csrc kSplitPages


def split_workspace(B: int, Q: int, K: int, G: int, D: int, n_pages: int,
                    window: int, device) -> torch.Tensor:
    """The scratch K1 and K3 write their split partials to: for each of
    the ``ceil(n_pages / 16)`` key splits (one more in a ring) and each of
    the ``B * K * Q * G`` rows, fp32 (m, l) and a D-wide fp32 accumulator
    (``csrc/paged_attention.cuh``, ``launch``)."""
    n_splits = -(-n_pages // SPLIT_PAGES) + (1 if window else 0)
    return torch.empty(B * K * n_splits * Q * G * (D + 2) * 4,
                       dtype=torch.uint8, device=device)


def check_verify_shapes(q_shape, page_shape, tables_shape, pos_shape,
                        nq_shape, window: int = 0):
    """Raise ``ValueError`` unless K3 takes these shapes: q [B, Q, H, D]
    against pages [P, ps, K, D] with ``H % K == 0`` and ``G = H // K <=
    48`` (any Q: the kernel splits a KV head's Q * G rows over blocks of at
    most 48 by query token), tables [B, n], pos and n_q [B], page size <=
    16, head dim 32, 64 or 128 and ``window >= 0``."""
    B, Q, H, D = q_shape
    P, ps, K, Dk = page_shape
    if Dk != D or H % K or tables_shape[0] != B or pos_shape[0] != B \
            or nq_shape[0] != B or H // K > MAX_ROWS["paged_verify"] \
            or ps > 16 or D not in HEAD_DIMS or window < 0:
        raise ValueError(
            f"paged_verify: unsupported shapes q {tuple(q_shape)}, pages "
            f"{tuple(page_shape)}, tables {tuple(tables_shape)}, pos "
            f"{tuple(pos_shape)}, n_q {tuple(nq_shape)}")


def paged_decode(q, k_pages, v_pages, tables, pos, *, scale: float,
                 window: int = 0, softcap: float = 0.0, k_scale=None,
                 v_scale=None):
    """Paged GQA decode; arguments as ``paged_decode_plain``.  On a CUDA
    device ``q`` and the pools are contiguous bf16 (int8 payload plus
    contiguous bf16 scale pages when scales are given), ``tables`` and
    ``pos`` contiguous int32, ``H % K == 0`` with ``G = H // K <= 16``,
    page size <= 16 and head dim 32, 64 or 128; anything else raises
    (a negative ``softcap`` too, from the kernel's entry point)."""
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pages, v_pages, tables, pos,
                                  scale=scale, window=window,
                                  softcap=softcap, k_scale=k_scale,
                                  v_scale=v_scale)
    dev = q.device
    check_tensor(q, "q", torch.bfloat16, 3, dev)
    B, H, D = q.shape
    P, ps, K, Dk = check_pool("paged_decode", dev, k_pages, v_pages, tables,
                              k_scale, v_scale)
    check_tensor(pos, "pos", torch.int32, 1, dev)
    if Dk != D or H % K or tables.shape[0] != B or pos.shape[0] != B \
            or H // K > MAX_ROWS["paged_decode"] or ps > 16 \
            or D not in HEAD_DIMS or window < 0:
        raise ValueError(
            f"paged_decode: unsupported shapes q {tuple(q.shape)}, pages "
            f"{tuple(k_pages.shape)}, tables {tuple(tables.shape)}, pos "
            f"{tuple(pos.shape)}")
    out = torch.empty_like(q)
    ws = split_workspace(B, 1, K, H // K, D, tables.shape[1], window, dev)
    rc = entry("paged_decode", _DECODE_ARGTYPES)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), ptr(k_scale),
        ptr(v_scale), tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
        ws.data_ptr(), ws.numel(), B, K, H // K, D, ps, tables.shape[1],
        int(window), float(scale), float(softcap),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, "paged_decode")
    paged_decode.launches += 1
    return out


paged_decode.launches = 0


def paged_verify(q, k_pages, v_pages, tables, pos, n_q, *, scale: float,
                 window: int = 0, softcap: float = 0.0, k_scale=None,
                 v_scale=None):
    """Small-q speculative verify; arguments as ``paged_verify_plain``.  On
    a CUDA device ``q`` [B, Q, H, D] and the pools are contiguous bf16 (or
    int8 payload plus bf16 scale pages), ``tables``, ``pos`` and ``n_q``
    contiguous int32, ``H % K == 0`` with ``G = H // K <= 48``, page size
    <= 16 and head dim 32, 64 or 128 (``check_verify_shapes``); anything
    else raises.  A (request, KV head)'s ``Q * G`` rows go to blocks of at
    most 48 rows, split by query token (60 rows at Q = 5, G = 12,
    command-r-plus-104b, are two blocks)."""
    if q.device.type == "cpu":
        return paged_verify_plain(q, k_pages, v_pages, tables, pos, n_q,
                                  scale=scale, window=window,
                                  softcap=softcap, k_scale=k_scale,
                                  v_scale=v_scale)
    dev = q.device
    check_tensor(q, "q", torch.bfloat16, 4, dev)
    B, Q, H, D = q.shape
    P, ps, K, Dk = check_pool("paged_verify", dev, k_pages, v_pages, tables,
                              k_scale, v_scale)
    check_tensor(pos, "pos", torch.int32, 1, dev)
    check_tensor(n_q, "n_q", torch.int32, 1, dev)
    check_verify_shapes(q.shape, k_pages.shape, tables.shape, pos.shape,
                        n_q.shape, window)
    out = torch.empty_like(q)
    ws = split_workspace(B, Q, K, H // K, D, tables.shape[1], window, dev)
    rc = entry("paged_verify", _VERIFY_ARGTYPES)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), ptr(k_scale),
        ptr(v_scale), tables.data_ptr(), pos.data_ptr(), n_q.data_ptr(),
        out.data_ptr(), ws.data_ptr(), ws.numel(), B, Q, K, H // K, D, ps,
        tables.shape[1], int(window), float(scale), float(softcap),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, "paged_verify")
    paged_verify.launches += 1
    return out


paged_verify.launches = 0


def mla_paged_decode_plain(q_eff, q_rope, ckv_pages, krope_pages, tables,
                           pos, *, scale: float, ckv_scale=None,
                           krope_scale=None):
    """q_eff: [B, H, L] (``w_uk``-absorbed queries); q_rope: [B, H, R]
    (roped); ckv_pages: [P, ps, L]; krope_pages: [P, ps, R] (bf16, or int8
    with ``ckv_scale``/``krope_scale`` [P, ps] bf16); tables: [B,
    n_pages]; pos: [B] (the new token already written).  Gathers the
    logical latent view (int8 dequantized to fp32 as ``f32(q) * f32(s)``)
    and runs ``mla.mla_latent_attend`` with ``idx <= pos``: fp32 scores,
    softmax and latent context, one cast at the output.  Returns the
    latent context [B, H, L] in ``q_eff``'s dtype."""
    cc, cr = attention.gather_kv(ckv_pages, krope_pages, tables, ckv_scale,
                                 krope_scale)
    valid = attention.decode_valid_mask(pos, cc.shape[1])
    return mla.mla_latent_attend(q_eff, q_rope, cc, cr, valid,
                                 scale=scale).to(q_eff.dtype)


def mla_paged_verify_plain(q_eff, q_rope, ckv_pages, krope_pages, tables,
                           pos, n_q, *, scale: float, ckv_scale=None,
                           krope_scale=None):
    """q_eff: [B, Q, H, L] and q_rope: [B, Q, H, R], query j of row b at
    absolute position ``pos[b] + j`` (all Q latents already written); n_q:
    [B] live query counts.  Pages, scales and tables as
    ``mla_paged_decode_plain``.  Each live query attends ``idx <= pos +
    j`` (``attention.verify_valid_mask``) with the decode attend's per-row
    ops; dead rows (``j >= n_q``) are exact zeros.  Returns the latent
    context [B, Q, H, L] in ``q_eff``'s dtype."""
    cc, cr = attention.gather_kv(ckv_pages, krope_pages, tables, ckv_scale,
                                 krope_scale)
    valid = attention.verify_valid_mask(pos, n_q, q_eff.shape[1],
                                        cc.shape[1])
    return mla.mla_latent_verify_attend(q_eff, q_rope, cc, cr, valid,
                                        scale=scale).to(q_eff.dtype)


# q_eff, q_rope, ckv, krope, ckv_scale, krope_scale, tables, pos, out,
# workspace, its bytes, then B, H, L, R, ps, n_pages, scale, stream; verify
# adds n_q after pos and Q after B
_MLA_DECODE_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_longlong] \
    + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
_MLA_VERIFY_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_longlong] \
    + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
MLA_DIMS = (512, 64)                        # csrc/mla_attention.cuh: L, R
MLA_SPLIT_PAGES = 8                         # csrc/mla_attention.cuh


def mla_split_workspace(B: int, Q: int, H: int, n_pages: int,
                        device) -> torch.Tensor:
    """The scratch K5 and K7 write their split partials to: for each of
    the ``ceil(n_pages / 8)`` key splits and each of the ``B * Q * H``
    rows, fp32 (m, l) and an L-wide fp32 latent accumulator
    (``csrc/mla_attention.cuh``, ``launch``)."""
    n_splits = -(-n_pages // MLA_SPLIT_PAGES)
    return torch.empty(B * n_splits * Q * H * (MLA_DIMS[0] + 2) * 4,
                       dtype=torch.uint8, device=device)


def _check_mla_alignment(name, q_eff, q_rope, ckv_pages, krope_pages,
                         ckv_scale, krope_scale):
    """Raise ``ValueError`` unless K5's and K7's 16-byte copies of queries
    and latent rows and their 4-byte copies of scale words are aligned."""
    for t, n, a in ((q_eff, "q_eff", 16), (q_rope, "q_rope", 16),
                    (ckv_pages, "ckv_pages", 16),
                    (krope_pages, "krope_pages", 16),
                    (ckv_scale, "ckv_scale", 4),
                    (krope_scale, "krope_scale", 4)):
        if t is not None and t.data_ptr() % a:
            raise ValueError(f"{name}: {n} is not {a}-byte aligned")


def _check_mla_shapes(name, q_eff, q_rope, pool_shape, tables, pos,
                      n_q=None):
    """Raise ``ValueError`` unless K5 (q_eff [B, H, L]) or K7 (q_eff [B,
    Q, H, L], ``n_q`` given) takes these shapes: L = 512, R = 64, q_rope
    matching q_eff, H a multiple of 8, page size <= 16, tables [B, n] and
    pos (n_q) [B]."""
    P, ps, L, R = pool_shape
    B, H = q_eff.shape[0], q_eff.shape[-2]
    if (L, R) != MLA_DIMS or q_eff.shape[-1] != L \
            or tuple(q_rope.shape) != tuple(q_eff.shape[:-1]) + (R,) \
            or H % 8 or ps > 16 or tables.shape[0] != B \
            or pos.shape[0] != B or (n_q is not None and n_q.shape[0] != B):
        raise ValueError(
            f"{name}: unsupported shapes q_eff {tuple(q_eff.shape)}, q_rope "
            f"{tuple(q_rope.shape)}, latent pages {(P, ps, L)}/{(P, ps, R)}"
            f", tables {tuple(tables.shape)}, pos {tuple(pos.shape)}")


def mla_paged_decode(q_eff, q_rope, ckv_pages, krope_pages, tables, pos, *,
                     scale: float, ckv_scale=None, krope_scale=None):
    """Absorbed-latent MLA decode (K5); arguments as
    ``mla_paged_decode_plain``.  On a CUDA device ``q_eff`` and ``q_rope``
    are contiguous bf16, the latent pages contiguous bf16 (or int8 with
    both scale pages, contiguous bf16 [P, ps]), ``tables`` and ``pos``
    contiguous int32, L = 512, R = 64 (deepseek-v2), H a multiple of 8 and
    page size <= 16; anything else raises.  The request's H rows go to
    ceil(H / 64) row tiles, each split over its keys at 8 absolute pages
    (grid splits x row tiles x B), then a merge kernel."""
    if q_eff.device.type == "cpu":
        return mla_paged_decode_plain(q_eff, q_rope, ckv_pages, krope_pages,
                                      tables, pos, scale=scale,
                                      ckv_scale=ckv_scale,
                                      krope_scale=krope_scale)
    dev = q_eff.device
    check_tensor(q_eff, "q_eff", torch.bfloat16, 3, dev)
    check_tensor(q_rope, "q_rope", torch.bfloat16, 3, dev)
    check_tensor(pos, "pos", torch.int32, 1, dev)
    shape = check_latent_pool("mla_paged_decode", dev, ckv_pages,
                              krope_pages, tables, ckv_scale, krope_scale)
    _check_mla_shapes("mla_paged_decode", q_eff, q_rope, shape, tables, pos)
    _check_mla_alignment("mla_paged_decode", q_eff, q_rope, ckv_pages,
                         krope_pages, ckv_scale, krope_scale)
    B, H, L = q_eff.shape
    out = torch.empty_like(q_eff)
    ws = mla_split_workspace(B, 1, H, tables.shape[1], dev)
    rc = entry("mla_paged_decode", _MLA_DECODE_ARGTYPES)(
        q_eff.data_ptr(), q_rope.data_ptr(), ckv_pages.data_ptr(),
        krope_pages.data_ptr(), ptr(ckv_scale), ptr(krope_scale),
        tables.data_ptr(), pos.data_ptr(), out.data_ptr(), ws.data_ptr(),
        ws.numel(), B, H, L, shape[3], shape[1], tables.shape[1],
        float(scale),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, "mla_paged_decode")
    mla_paged_decode.launches += 1
    return out


mla_paged_decode.launches = 0


def mla_paged_verify(q_eff, q_rope, ckv_pages, krope_pages, tables, pos, n_q,
                     *, scale: float, ckv_scale=None, krope_scale=None):
    """Small-q absorbed-latent MLA verify (K7); arguments as
    ``mla_paged_verify_plain``.  On a CUDA device ``q_eff`` [B, Q, H, L]
    and ``q_rope`` [B, Q, H, R] are contiguous bf16, the pages, scales,
    ``tables`` and ``pos`` as ``mla_paged_decode``'s and ``n_q``
    contiguous int32 [B]; anything else raises.  A request's Q * H rows,
    token-major, go to ceil(Q * H / 64) row tiles (64 heads of one token
    at H = 128; several tokens' heads at H = 8 or 16), each split over its
    keys at 8 absolute pages, then a merge kernel; tiles of dead tokens
    read nothing."""
    if q_eff.device.type == "cpu":
        return mla_paged_verify_plain(q_eff, q_rope, ckv_pages, krope_pages,
                                      tables, pos, n_q, scale=scale,
                                      ckv_scale=ckv_scale,
                                      krope_scale=krope_scale)
    dev = q_eff.device
    check_tensor(q_eff, "q_eff", torch.bfloat16, 4, dev)
    check_tensor(q_rope, "q_rope", torch.bfloat16, 4, dev)
    check_tensor(pos, "pos", torch.int32, 1, dev)
    check_tensor(n_q, "n_q", torch.int32, 1, dev)
    shape = check_latent_pool("mla_paged_verify", dev, ckv_pages,
                              krope_pages, tables, ckv_scale, krope_scale)
    _check_mla_shapes("mla_paged_verify", q_eff, q_rope, shape, tables, pos,
                      n_q)
    _check_mla_alignment("mla_paged_verify", q_eff, q_rope, ckv_pages,
                         krope_pages, ckv_scale, krope_scale)
    B, Q, H, L = q_eff.shape
    out = torch.empty_like(q_eff)
    ws = mla_split_workspace(B, Q, H, tables.shape[1], dev)
    rc = entry("mla_paged_verify", _MLA_VERIFY_ARGTYPES)(
        q_eff.data_ptr(), q_rope.data_ptr(), ckv_pages.data_ptr(),
        krope_pages.data_ptr(), ptr(ckv_scale), ptr(krope_scale),
        tables.data_ptr(), pos.data_ptr(), n_q.data_ptr(), out.data_ptr(),
        ws.data_ptr(), ws.numel(), B, Q, H, L, shape[3], shape[1],
        tables.shape[1], float(scale),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, "mla_paged_verify")
    mla_paged_verify.launches += 1
    return out


mla_paged_verify.launches = 0
