"""Attention for dense GQA / MQA / MHA decoders: QKV projection with RoPE,
chunked causal attention for full sequences, a contiguous per-request KV
cache for the static path, and the paged blocks the serving engine runs.

The port's counterpart of ``repro.models.attention``, dense subset, with
the int8 paged pool, the small-q speculative verify block and the
sliding-window family (page rings for the paged blocks, a ring buffer of
``min(window, max_len)`` entries for the static cache, and for the hybrid
family's local attention, whose window the callers pass explicitly), and
the attention logit softcap (``cfg.attn_logit_softcap``: every score
becomes ``c * tanh(s / c)`` after the scale and before the mask, in the
self-attention blocks where the JAX package applies it; the
cross-attention and MLA take none, as in JAX).  Every softmax is spelled
out as ``exp(s - max) / sum`` — what ``jax.nn.softmax`` computes — and
every score and probability-weighted sum is taken in fp32 from the bf16
operands, with one cast back at the block output: the rounding points the
JAX reference and the Hopper kernels share (``repro.kernels.README``).

Paged blocks write the pool *in place* (``index_put_``), where the JAX
package returned updated buffers from a donating jit.
"""
from __future__ import annotations

import math

import torch

from ..configs.base import ArchConfig
from .layers import apply_rope
from .params import ParamDef

NEG_INF = -1e30


# ------------------------------------------------------------------ param defs

def attn_defs(cfg: ArchConfig, d=None):
    d = d or cfg.d_model
    hd = cfg.head_dim_
    h, k = cfg.n_heads_padded, cfg.n_kv_heads
    defs = {
        "wq": ParamDef((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": ParamDef((d, k, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamDef((d, k, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamDef((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((h, hd), ("heads", "head_dim"), init="zeros")
        defs["bk"] = ParamDef((k, hd), ("kv_heads", "head_dim"), init="zeros")
        defs["bv"] = ParamDef((k, hd), ("kv_heads", "head_dim"), init="zeros")
    return defs


def qkv(cfg: ArchConfig, p, x):
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"])
    k = torch.einsum("bsd,dhe->bshe", x, p["wk"])
    v = torch.einsum("bsd,dhe->bshe", x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def out_proj(o, wo):
    """[..., H, D] x [H, D, d] -> [..., d]."""
    return torch.einsum("...he,hed->...d", o, wo)


def softmax(s: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis, op for op."""
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def logit_cap(s: torch.Tensor, softcap: float) -> torch.Tensor:
    """The logit softcap of the JAX attention and its TPU kernels, op for
    op: ``softcap * tanh(s / softcap)`` on the scaled fp32 scores, taken
    before the mask; ``s`` itself when ``softcap`` is 0."""
    return softcap * torch.tanh(s / softcap) if softcap else s


# --------------------------------------------------------- chunked core attention

def chunked_attention(q, k, v, *, scale: float, q_block: int = 512,
                      q_offset=0, window: int = 0, causal: bool = True,
                      softcap: float = 0.0):
    """Causal attention, scores times ``scale`` (then ``logit_cap`` at
    ``softcap``, before the mask); ``window > 0`` also masks
    keys at or before ``q_pos - window`` (sliding window); ``causal=False``
    without a window masks nothing (the encoder's self-attention and
    cross-attention, where ``Sk`` need not equal ``Sq``).  q: [B, Sq, H,
    D]; k, v: [B, Sk, K, D].  Query blocks of ``q_block`` rows bound the
    live fp32 score tensor at [B, K, G, q_block, Sk].  ``q_offset`` is the
    absolute position of q[:, 0] relative to k[:, 0]: an int, or a [B]
    tensor of per-row offsets.  Returns [B, Sq, H, D]."""
    B, Sq, H, D = q.shape
    K = k.shape[2]
    G = H // K
    q_block = min(q_block, Sq)
    kf, vf = k.float(), v.float()
    kpos = torch.arange(k.shape[1], device=q.device)
    qoff = torch.as_tensor(q_offset, device=q.device).reshape(-1, 1)
    outs = []
    for i0 in range(0, Sq, q_block):
        qi = q[:, i0:i0 + q_block]
        n = qi.shape[1]
        qi = qi.reshape(B, n, K, G, D).float()
        qpos = qoff + i0 + torch.arange(n, device=q.device)[None, :]
        s = logit_cap(torch.einsum("bqkgd,bskd->bkgqs", qi, kf) * scale,
                      softcap)
        mask = kpos[None, None, :] <= qpos[:, :, None] if causal \
            else None                                    # [B|1, n, Sk]
        if window:
            w = kpos[None, None, :] > qpos[:, :, None] - window
            mask = w if mask is None else mask & w
        if mask is not None:
            s = torch.where(mask[:, None, None], s, NEG_INF)
        a = softmax(s).to(v.dtype)
        o = torch.einsum("bkgqs,bskd->bqkgd", a.float(), vf).to(v.dtype)
        outs.append(o.reshape(B, n, H, v.shape[-1]))
    return torch.cat(outs, dim=1)


def ring_chunk_mask(start, n_live, n: int, T: int,
                    window: int) -> torch.Tensor:
    """[B, T, n + T] keys each query of a sliding-window chunk sees: the
    ``n`` slots of the page ring as it was *before* the chunk's writes,
    then the chunk's ``T`` fresh keys.  Ring slot ``s`` holds the latest
    position ``< start`` congruent to ``s`` mod ``n``, so its absolute
    position is recovered relative to ``start - 1`` (at ``start == 0``
    every slot is negative, i.e. unseen) and masked to the window; fresh
    key ``f`` is seen causally, within the window and when ``f <
    n_live``.  start, n_live: [B]."""
    dev = start.device
    st = start.reshape(-1, 1, 1).long()
    last = st - 1
    idx = torch.arange(n, device=dev)[None, None, :]
    k_abs = last - ((last % n - idx) % n)          # torch's % is Python's
    q_abs = st + torch.arange(T, device=dev)[None, :, None]
    ring = (k_abs >= 0) & (k_abs > q_abs - window)
    f = torch.arange(T, device=dev)[None, None, :]
    fresh = (f <= q_abs - st) & (st + f > q_abs - window) \
        & (f < n_live.reshape(-1, 1, 1).long())
    return torch.cat([ring.expand(-1, T, -1), fresh], dim=2)


def ring_chunk_attention(q, k, v, k_ring, v_ring, start, n_live, *,
                         window: int, scale: float, q_block: int = 512,
                         softcap: float = 0.0):
    """Sliding-window attend for a *chunk* of prefill at offset ``start``.

    q: [B, T, H, D] roped chunk queries; k, v: [B, T, K, D] the chunk's
    fresh roped K/V; k_ring, v_ring: [B, n, K, D] the gathered page ring as
    it was *before* the chunk's writes (positions < start); start, n_live:
    [B].  Keys are masked by ``ring_chunk_mask``.  One softmax over ring
    and fresh keys together (fp32 scores, capped at ``softcap`` before the
    mask, masked entries ``NEG_INF``),
    probabilities cast to the value dtype, fp32 PV sum, one cast to the
    value dtype: ``repro.models.attention.ring_chunk_attention`` op for op.
    Returns [B, T, H, D]."""
    B, T, H, D = q.shape
    K = k.shape[2]
    G = H // K
    q_block = min(q_block, T)
    kc = torch.cat([k_ring, k], dim=1)                # [B, n + T, K, D]
    vc = torch.cat([v_ring, v], dim=1)
    kf, vf = kc.float(), vc.float()
    mask = ring_chunk_mask(start, n_live, k_ring.shape[1], T, window)
    outs = []
    for i0 in range(0, T, q_block):
        qi = q[:, i0:i0 + q_block]
        nb = qi.shape[1]
        qi = qi.reshape(B, nb, K, G, D).float()
        s = logit_cap(torch.einsum("bqkgd,bskd->bkgqs", qi, kf) * scale,
                      softcap)
        s = torch.where(mask[:, None, None, i0:i0 + nb], s, NEG_INF)
        a = softmax(s).to(vc.dtype)
        o = torch.einsum("bkgqs,bskd->bqkgd", a.float(), vf).to(vc.dtype)
        outs.append(o.reshape(B, nb, H, vc.shape[-1]))
    return torch.cat(outs, dim=1)


def full_attention_block(cfg: ArchConfig, p, x, freqs, *, window: int = 0,
                         q_block=512, attend=None, causal: bool = True):
    """Self-attention over a full sequence (training and the static
    prefill), causal unless ``causal=False`` (the enc-dec encoder, which
    still ropes q and k), masked to the last ``window`` keys when ``window
    > 0`` (``cfg.sliding_window`` for windowed families, ``cfg.attn_window``
    for the hybrid's local attention), scores capped at
    ``cfg.attn_logit_softcap``.  ``attend`` is the attend core:
    ``chunked_attention`` by default; the backend's ``train_attend(q, k, v,
    *, scale, q_block, window, softcap)`` in the training forward, or its
    ``full_attend(q, k, v, *, scale, q_block, softcap)`` for the
    encoder."""
    q, k, v = qkv(cfg, p, x)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    q = apply_rope(q, positions, freqs)
    k = apply_rope(k, positions, freqs)
    kw = dict(scale=1.0 / math.sqrt(cfg.head_dim_), q_block=q_block,
              softcap=cfg.attn_logit_softcap)
    if attend is None:
        o = chunked_attention(q, k, v, window=window, causal=causal, **kw)
    elif causal:
        o = attend(q, k, v, window=window, **kw)
    else:
        o = attend(q, k, v, **kw)
    return out_proj(o, p["wo"])


def cross_kv(p, enc_out):
    """The cross-attention K/V of encoder output enc_out [B, S, d]: no
    rope, plus ``bk`` / ``bv`` when the layer has biases.  Returns (k, v)
    [B, S, K, D]."""
    k = torch.einsum("bsd,dhe->bshe", enc_out, p["wk"])
    v = torch.einsum("bsd,dhe->bshe", enc_out, p["wv"])
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    return k, v


def cross_attention_block(cfg: ArchConfig, p, x, kv, *, q_block=512):
    """Decoder cross-attention: queries of x [B, T, d] (no rope, plus
    ``bq``) against the encoder output's K/V ``kv`` (``cross_kv``: fresh,
    or as pinned in a state slot), no mask.  The attend is the plain non-causal chunked
    core on every backend: the TPU kernel behind the encoder's
    self-attention computes one sequence length ``S`` for queries and keys
    alike, and the JAX package computes this ``Sq != Sk`` attend in XLA,
    outside any Pallas kernel.  Returns [B, T, d]."""
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    k, v = kv
    o = chunked_attention(q, k, v, scale=1.0 / math.sqrt(cfg.head_dim_),
                          q_block=q_block, causal=False)
    return out_proj(o, p["wo"])


# ------------------------------------------------------------------- KV cache

def cache_defs(cfg: ArchConfig, batch: int, max_len: int, window: int = 0):
    """Defs for one layer's contiguous KV cache (static path; the hybrid's
    state slot): a ring buffer of ``min(window, max_len)`` entries when
    ``window > 0``."""
    hd = cfg.head_dim_
    L = min(window, max_len) if window else max_len
    return {
        "k": ParamDef((batch, L, cfg.n_kv_heads, hd),
                      ("batch", "seq", "kv_heads", "head_dim"), init="zeros"),
        "v": ParamDef((batch, L, cfg.n_kv_heads, hd),
                      ("batch", "seq", "kv_heads", "head_dim"), init="zeros"),
    }


def paged_cache_defs(cfg: ArchConfig, num_pages: int, page_size: int,
                     kv_dtype: str = "bf16"):
    """One layer's share of the paged KV pool: [P, page_size, K, D] per
    tensor.  No batch dim — requests own disjoint page sets and a
    per-request page table maps logical pages to physical ones.

    ``kv_dtype == "int8"`` stores absmax-quantized int8 payloads plus
    per-token-slot-per-kv-head bf16 scale leaves (``k_scale``/``v_scale``,
    [P, page_size, K]) on the payload's page axis: one physical page id
    addresses payload and scales together, so refcounts, radix sharing and
    COW forks need no separate scale accounting."""
    hd = cfg.head_dim_
    shape = (num_pages, page_size, cfg.n_kv_heads, hd)
    logical = (None, "seq", "kv_heads", "head_dim")
    payload = torch.int8 if kv_dtype == "int8" else torch.bfloat16
    defs = {"k": ParamDef(shape, logical, dtype=payload, init="zeros"),
            "v": ParamDef(shape, logical, dtype=payload, init="zeros")}
    if kv_dtype == "int8":
        for name in ("k_scale", "v_scale"):
            defs[name] = ParamDef(shape[:3], logical[:3], init="zeros")
    return defs


# ------------------------------------------------- int8 KV quantization
#
# The one quantize/dequant rounding contract every path shares: absmax in
# fp32 over the feature axis per (token slot, kv head); the stored scale is
# ``bf16(absmax / 127)``; the payload quantizes against the *stored* scale,
# ``int8(clip(round(x / f32(s)), -127, 127))`` (round half to even, as
# ``jnp.round``); a zero-scale slice stores (q=0, s=0).  Dequant is
# ``f32(q) * f32(s)`` everywhere: the plain gather, the Hopper kernels.
# fp32 subnormals flush to zero as XLA's CPU and TPU backends flush them
# (PyTorch keeps them): a subnormal input counts as 0, and a scale
# ``absmax / 127`` below the least normal fp32 stores 0.

def quantize_int8(x: torch.Tensor):
    """Absmax-quantize ``x`` over its last axis.  Returns
    (q int8 [..., D], s bfloat16 [...])."""
    tiny = torch.finfo(torch.float32).tiny
    xf = x.float()
    xf = torch.where(xf.abs() < tiny, torch.zeros_like(xf), xf)
    a = xf.abs().amax(-1) / 127.0
    s = torch.where(a < tiny, torch.zeros_like(a), a).to(torch.bfloat16)
    sf = s.float()
    # zero-scale slices (all-zero input, or absmax underflowing bf16) store
    # q = 0; the safe denominator keeps the division finite either way
    safe = torch.where(sf > 0.0, sf, torch.ones_like(sf))[..., None]
    q = torch.clamp(torch.round(xf / safe), -127.0, 127.0)
    q = torch.where(sf[..., None] > 0.0, q, torch.zeros_like(q))
    return q.to(torch.int8), s


def dequant_int8(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Invert ``quantize_int8``: fp32 payload times fp32 scale, broadcast
    over the feature axis.  q: [..., D] int8; s: [...] bf16.  Returns
    fp32."""
    return q.float() * s.float()[..., None]


# --------------------------------------------- shared paged-cache helpers

def gather_pages(pages: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Materialize the logical per-request view of a paged pool.

    pages: [P, ps, ...]; tables: [B, n] int physical page ids.  Returns
    [B, n * ps, ...] — request b's pages concatenated in table order."""
    B, n = tables.shape
    return pages[tables.long()].reshape((B, n * pages.shape[1])
                                        + pages.shape[2:])


def gather_kv(k_pages, v_pages, tables, k_scale=None, v_scale=None):
    """The logical (K, V) views of a pool: bf16 pages as they are; int8
    payload and scale pages gathered through the same table, then
    dequantized to fp32 as ``f32(q) * f32(s)``."""
    if k_scale is None:
        return gather_pages(k_pages, tables), gather_pages(v_pages, tables)
    return tuple(dequant_int8(gather_pages(x, tables),
                              gather_pages(s, tables))
                 for x, s in ((k_pages, k_scale), (v_pages, v_scale)))


def ring_valid(qpos: torch.Tensor, n: int, window: int) -> torch.Tensor:
    """[..., n] validity of the ``n`` slots of a ring at query positions
    ``qpos`` [...]: each slot's absolute position is recovered from the
    ring layout (slot ``qpos % n`` holds ``qpos``) and masked to ``(qpos -
    window, qpos]``."""
    idx = torch.arange(n, device=qpos.device)
    q = qpos.long()[..., None]
    k_abs = q - ((q % n - idx) % n)
    return (k_abs >= 0) & (k_abs <= q) & (k_abs > q - window)


def decode_valid_mask(pos: torch.Tensor, n: int, *,
                      window: int = 0) -> torch.Tensor:
    """[B, n] validity of a gathered view at one-token decode.
    ``window == 0``: absolute causal ``idx <= pos``.  ``window > 0``: ``n``
    is the ring length and the ring rule of ``ring_valid`` applies."""
    if window:
        return ring_valid(pos, n, window)
    idx = torch.arange(n, device=pos.device)
    return idx[None, :] <= pos[:, None]


def verify_valid_mask(pos: torch.Tensor, n_q: torch.Tensor, Q: int,
                      n: int, *, window: int = 0) -> torch.Tensor:
    """[B, Q, n] validity of a gathered view at a small-q verify step:
    query j of row b sits at absolute position ``pos[b] + j``; its row is
    ``decode_valid_mask`` at that position (``idx <= pos[b] + j``, or the
    ring rule with ring length ``n`` for ``window > 0``).  Dead query rows
    (``j >= n_q[b]``) are all-False."""
    j = torch.arange(Q, device=pos.device)
    qpos = pos[:, None] + j[None, :]                              # [B, Q]
    live = j[None, :] < n_q[:, None]
    if window:
        return ring_valid(qpos, n, window) & live[:, :, None]
    idx = torch.arange(n, device=pos.device)
    return (idx[None, None, :] <= qpos[:, :, None]) & live[:, :, None]


def decode_qkv(cfg: ArchConfig, p, x, pos, freqs):
    """Project + rope one decode token.  x: [B, d]; pos: [B].  Returns
    (q [B, H, D], k [B, K, D], v [B, K, D])."""
    q, k, v = qkv(cfg, p, x[:, None, :])
    q = apply_rope(q, pos[:, None], freqs)
    k = apply_rope(k, pos[:, None], freqs)
    return q[:, 0], k[:, 0], v[:, 0]


def masked_token_attend(q, kg, vg, valid, *, scale: float,
                        softcap: float = 0.0):
    """The one-token GQA attend every plain decode path shares.

    q: [B, H, D]; kg, vg: [B, S, K, D] (contiguous logical view); valid:
    [B, S] bool.  fp32 scores (capped at ``softcap`` before the mask),
    masked softmax and an fp32
    probability-weighted sum; the one rounding point is the cast back to
    the cache dtype at the output — where the paged-decode kernel rounds
    its fp32 accumulator.  Returns [B, H, D]."""
    B, H, D = q.shape
    K = kg.shape[2]
    qg = q.reshape(B, K, H // K, D).float()
    s = logit_cap(torch.einsum("bkgd,bskd->bkgs", qg, kg.float()) * scale,
                  softcap)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    a = softmax(s)
    o = torch.einsum("bkgs,bskd->bkgd", a, vg.float())
    return o.to(vg.dtype).reshape(B, H, D)


def masked_multi_token_attend(q, kg, vg, valid, *, scale: float,
                              softcap: float = 0.0):
    """``masked_token_attend`` with a small query axis (speculative verify).

    q: [B, Q, H, D]; kg, vg: [B, S, K, D]; valid: [B, Q, S] per-query
    masks.  Each query row runs the per-row ops of the one-token attend
    (fp32 scores, masked softmax, fp32 PV sum, one output cast), so
    ``Q == 1`` reproduces it.  Rows whose mask is all-False (dead / padded
    queries) return exact zeros — the verify kernel's zero accumulator — so
    backends agree on every row, live or dead.  Returns [B, Q, H, D]."""
    B, Q, H, D = q.shape
    K = kg.shape[2]
    qg = q.reshape(B, Q, K, H // K, D).float()
    s = logit_cap(torch.einsum("bqkgd,bskd->bqkgs", qg, kg.float())
                  * scale, softcap)
    s = torch.where(valid[:, :, None, None, :], s, NEG_INF)
    a = softmax(s)
    any_valid = valid.any(-1)                                     # [B, Q]
    a = torch.where(any_valid[:, :, None, None, None], a,
                    torch.zeros_like(a))
    o = torch.einsum("bqkgs,bskd->bqkgd", a, vg.float())
    return o.to(vg.dtype).reshape(B, Q, H, D)


# --------------------------------------------------- paged attention blocks
#
# Family framing shared by every backend: QKV + RoPE, page-table scatter,
# output projection.  The attend itself is delegated to ``backend`` (see
# models.attn_backend) — plain gather+attend or the Hopper kernels.

def write_pages(cache, wp, wo, k, v):
    """Scatter K/V rows into one layer's pool at their physical (page,
    offset) targets, in place.  An int8 pool (``"k_scale" in cache``)
    stores the quantized payload and its scales at the same targets.
    Returns the scale pools to hand the attend core (empty for bf16)."""
    if "k_scale" not in cache:
        cache["k"][wp, wo] = k.to(cache["k"].dtype)
        cache["v"][wp, wo] = v.to(cache["v"].dtype)
        return {}
    # one quantize over K and V together: half the eager launches
    q8, s = quantize_int8(torch.stack((k, v)))
    cache["k"][wp, wo], cache["v"][wp, wo] = q8[0], q8[1]
    cache["k_scale"][wp, wo], cache["v_scale"][wp, wo] = s[0], s[1]
    return {"k_scale": cache["k_scale"], "v_scale": cache["v_scale"]}


def paged_prefill_attention_block(cfg: ArchConfig, p, x, cache, meta, freqs,
                                  backend, *, q_block=512):
    """Multi-token (chunk) prefill step against the paged KV pool.

    x: [B, T, d] chunk activations; cache: {"k","v": [P, ps, K, D]} one
    layer's pages (written in place; int8 pools also carry ``k_scale`` /
    ``v_scale``); meta: the flat per-step prefill metadata from
    ``attn_backend.prefill_meta``.

    Full-attention layers scatter the chunk's K/V first (quantized on write
    for int8), then the queries attend the post-write pages with absolute
    causal masking, so a prefix written by an earlier request (radix-cache
    hit) or an earlier chunk is read exactly as if this call had prefilled
    it.  Sliding-window layers attend first: the page ring as it stands
    *before* the chunk's writes plus the chunk's fresh K/V (never
    quantized), then scatter — writing first would recycle ring slots that
    still hold in-window keys of the chunk's earliest queries (the JAX
    package read the pre-write pool from its immutable input instead).
    Returns (out [B, T, d], cache)."""
    B, T, _ = x.shape
    tables, start = meta["tables"], meta["start"]
    q, k, v = qkv(cfg, p, x)
    positions = start[:, None] + torch.arange(T, device=x.device)[None, :]
    q = apply_rope(q, positions, freqs)
    k = apply_rope(k, positions, freqs)
    window = cfg.sliding_window
    if window:
        scales = ({"k_scale": cache["k_scale"], "v_scale": cache["v_scale"]}
                  if "k_scale" in cache else {})
    else:
        scales = write_pages(cache, meta["write_page"], meta["write_off"],
                             k, v)
    o = backend.prefill_attend(q, k, v, cache["k"], cache["v"], tables,
                               start, meta["n_live"],
                               scale=1.0 / math.sqrt(cfg.head_dim_),
                               window=window,
                               softcap=cfg.attn_logit_softcap,
                               q_block=q_block, **scales)
    if window:
        write_pages(cache, meta["write_page"], meta["write_off"], k, v)
    return out_proj(o, p["wo"]), cache


def paged_decode_attention_block(cfg: ArchConfig, p, x, cache, meta, freqs,
                                 backend):
    """One-token decode step against the paged KV pool.

    x: [B, d] slot activations; cache: one layer's pages (written in
    place); meta: the flat per-step metadata from
    ``attn_backend.decode_meta``.  The new token's K/V land at their
    precomputed write target (for sliding-window layers the ring slot
    ``pos`` mod the ring length, whose previous key has just left the
    window), then the attend reads the pages through ``backend`` with
    positions > pos masked (window layers: masked by the absolute position
    recovered from the ring layout).  Returns (out [B, d], cache)."""
    pos = meta["pos"]
    q, k, v = decode_qkv(cfg, p, x, pos, freqs)
    scales = write_pages(cache, meta["write_page"], meta["write_off"], k, v)
    o = backend.decode_attend(q, cache["k"], cache["v"], meta["tables"], pos,
                              scale=1.0 / math.sqrt(cfg.head_dim_),
                              window=cfg.sliding_window,
                              softcap=cfg.attn_logit_softcap, **scales)
    return out_proj(o, p["wo"]), cache


def paged_verify_attention_block(cfg: ArchConfig, p, xs, cache, meta, freqs,
                                 backend):
    """Small-q speculative verify step against the paged KV pool.

    xs: Q tensors [B, d] — query token j's activations of every slot (the
    last emitted token, then the draft, padded to the fixed width Q); meta:
    the flat metadata from ``attn_backend.verify_meta``.
    Write-all-then-attend: every query token's K/V scatters into its page
    first (dead rows to the null page), then each query attends the
    post-write pool under the per-query mask ``token_pos <= pos + j`` (the
    ring rule for sliding-window layers) and ``j < n_q`` — so a rejected
    draft's K/V is invisible to every query that survives the accept
    decision and is overwritten in place by the next step's writes at the
    same positions.  In a ring, the pool's slack page keeps a rejected
    draft's slot out of every surviving query's window.
    Token j's projections and rope are the decode block's ops at position
    ``pos + j`` on a [B, d] input, the decode step's GEMM shape, and so is
    its output projection; only the attend runs once over all Q tokens.
    Returns (Q outputs [B, d], cache)."""
    pos = meta["pos"]
    q, k, v = (torch.stack(t, 1) for t in zip(*(
        decode_qkv(cfg, p, x, pos + j, freqs) for j, x in enumerate(xs))))
    scales = write_pages(cache, meta["write_page"], meta["write_off"], k, v)
    o = backend.verify_attend(q, cache["k"], cache["v"], meta["tables"], pos,
                              meta["n_q"],
                              scale=1.0 / math.sqrt(cfg.head_dim_),
                              window=cfg.sliding_window,
                              softcap=cfg.attn_logit_softcap, **scales)
    return [out_proj(o[:, j].contiguous(), p["wo"])
            for j in range(len(xs))], cache


def decode_attention_block(cfg: ArchConfig, p, x, cache, pos, freqs, *,
                           window: int = 0):
    """One-token decode step against a contiguous per-request cache.
    x: [B, d]; pos: [B] absolute positions.  With ``window > 0`` the cache
    is a ring of L = ``min(window, max_len)`` entries, written at ``pos %
    L`` and masked by the ring rule with ring length and window L (entries
    older than L are overwritten).  Returns (out [B, d], cache), the cache
    written in place."""
    B = x.shape[0]
    q, k, v = decode_qkv(cfg, p, x, pos, freqs)
    L = cache["k"].shape[1]
    ring = L if window else 0
    slot = pos % L if ring else pos
    b = torch.arange(B, device=x.device)
    cache["k"][b, slot] = k.to(cache["k"].dtype)
    cache["v"][b, slot] = v.to(cache["v"].dtype)
    valid = decode_valid_mask(pos, L, window=ring)
    o = masked_token_attend(q, cache["k"], cache["v"], valid,
                            scale=1.0 / math.sqrt(cfg.head_dim_),
                            softcap=cfg.attn_logit_softcap)
    return out_proj(o, p["wo"]), cache
