"""Attention for dense GQA / MQA / MHA decoders: QKV projection with RoPE,
chunked causal attention for full sequences, a contiguous per-request KV
cache for the static path, and the paged blocks the serving engine runs.

The port's counterpart of ``repro.models.attention``, dense subset, with
the int8 paged pool and the small-q speculative verify block; the
sliding-window ring (ROADMAP queue 1 item 11) and the logit softcap (no
registered arch sets it) arrive with their slices.  Every softmax is spelled
out as ``exp(s - max) / sum`` — what ``jax.nn.softmax`` computes — and every
score and probability-weighted sum is taken in fp32 from the bf16 operands,
with one cast back at the block output: the rounding points the JAX
reference and the Hopper kernels share (``repro.kernels.README``).

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


# --------------------------------------------------------- chunked core attention

def chunked_attention(q, k, v, *, scale: float, q_block: int = 512,
                      q_offset=0):
    """Causal attention, scores times ``scale``.  q: [B, Sq, H, D]; k, v:
    [B, Sk, K, D].  Query blocks of ``q_block`` rows bound the live fp32
    score tensor at
    [B, K, G, q_block, Sk].  ``q_offset`` is the absolute position of
    q[:, 0] relative to k[:, 0]: an int, or a [B] tensor of per-row offsets.
    Returns [B, Sq, H, D]."""
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
        s = torch.einsum("bqkgd,bskd->bkgqs", qi, kf) * scale
        mask = kpos[None, None, :] <= qpos[:, :, None]           # [B|1, n, Sk]
        s = torch.where(mask[:, None, None], s, NEG_INF)
        a = softmax(s).to(v.dtype)
        o = torch.einsum("bkgqs,bskd->bqkgd", a.float(), vf).to(v.dtype)
        outs.append(o.reshape(B, n, H, v.shape[-1]))
    return torch.cat(outs, dim=1)


def full_attention_block(cfg: ArchConfig, p, x, freqs, *, q_block=512):
    """Causal self-attention over a full sequence (prefill)."""
    q, k, v = qkv(cfg, p, x)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    q = apply_rope(q, positions, freqs)
    k = apply_rope(k, positions, freqs)
    o = chunked_attention(q, k, v, scale=1.0 / math.sqrt(cfg.head_dim_),
                          q_block=q_block)
    return out_proj(o, p["wo"])


# ------------------------------------------------------------------- KV cache

def cache_defs(cfg: ArchConfig, batch: int, max_len: int):
    """Defs for one layer's contiguous KV cache (static path)."""
    hd = cfg.head_dim_
    return {
        "k": ParamDef((batch, max_len, cfg.n_kv_heads, hd),
                      ("batch", "seq", "kv_heads", "head_dim"), init="zeros"),
        "v": ParamDef((batch, max_len, cfg.n_kv_heads, hd),
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


def decode_valid_mask(pos: torch.Tensor, n: int) -> torch.Tensor:
    """[B, n] validity of a gathered view at one-token decode: absolute
    causal ``idx <= pos``."""
    idx = torch.arange(n, device=pos.device)
    return idx[None, :] <= pos[:, None]


def verify_valid_mask(pos: torch.Tensor, n_q: torch.Tensor, Q: int,
                      n: int) -> torch.Tensor:
    """[B, Q, n] validity of a gathered view at a small-q verify step:
    query j of row b sits at absolute position ``pos[b] + j`` and sees
    ``idx <= pos[b] + j``; dead query rows (``j >= n_q[b]``) are
    all-False."""
    j = torch.arange(Q, device=pos.device)
    qpos = pos[:, None] + j[None, :]                              # [B, Q]
    live = j[None, :] < n_q[:, None]
    idx = torch.arange(n, device=pos.device)
    return (idx[None, None, :] <= qpos[:, :, None]) & live[:, :, None]


def decode_qkv(cfg: ArchConfig, p, x, pos, freqs):
    """Project + rope one decode token.  x: [B, d]; pos: [B].  Returns
    (q [B, H, D], k [B, K, D], v [B, K, D])."""
    q, k, v = qkv(cfg, p, x[:, None, :])
    q = apply_rope(q, pos[:, None], freqs)
    k = apply_rope(k, pos[:, None], freqs)
    return q[:, 0], k[:, 0], v[:, 0]


def masked_token_attend(q, kg, vg, valid, *, scale: float):
    """The one-token GQA attend every plain decode path shares.

    q: [B, H, D]; kg, vg: [B, S, K, D] (contiguous logical view); valid:
    [B, S] bool.  fp32 scores, masked softmax and an fp32
    probability-weighted sum; the one rounding point is the cast back to
    the cache dtype at the output — where the paged-decode kernel rounds
    its fp32 accumulator.  Returns [B, H, D]."""
    B, H, D = q.shape
    K = kg.shape[2]
    qg = q.reshape(B, K, H // K, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, kg.float()) * scale
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    a = softmax(s)
    o = torch.einsum("bkgs,bskd->bkgd", a, vg.float())
    return o.to(vg.dtype).reshape(B, H, D)


def masked_multi_token_attend(q, kg, vg, valid, *, scale: float):
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
    s = torch.einsum("bqkgd,bskd->bqkgs", qg, kg.float()) * scale
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
    ``attn_backend.prefill_meta``.  The chunk's K/V are scattered first
    (quantized on write for int8), then the queries attend the post-write
    pages with absolute causal masking, so a prefix written by an earlier
    request (radix-cache hit) or an earlier chunk is read exactly as if
    this call had prefilled it.  Returns (out [B, T, d], cache)."""
    B, T, _ = x.shape
    tables, start = meta["tables"], meta["start"]
    q, k, v = qkv(cfg, p, x)
    positions = start[:, None] + torch.arange(T, device=x.device)[None, :]
    q = apply_rope(q, positions, freqs)
    k = apply_rope(k, positions, freqs)
    scales = write_pages(cache, meta["write_page"], meta["write_off"], k, v)
    o = backend.prefill_attend(q, cache["k"], cache["v"], tables, start,
                               scale=1.0 / math.sqrt(cfg.head_dim_),
                               q_block=q_block, **scales)
    return out_proj(o, p["wo"]), cache


def paged_decode_attention_block(cfg: ArchConfig, p, x, cache, meta, freqs,
                                 backend):
    """One-token decode step against the paged KV pool.

    x: [B, d] slot activations; cache: one layer's pages (written in
    place); meta: the flat per-step metadata from
    ``attn_backend.decode_meta``.  The new token's K/V land at their
    precomputed write target, then the attend reads the pages through
    ``backend`` with positions > pos masked.  Returns (out [B, d], cache)."""
    pos = meta["pos"]
    q, k, v = decode_qkv(cfg, p, x, pos, freqs)
    scales = write_pages(cache, meta["write_page"], meta["write_off"], k, v)
    o = backend.decode_attend(q, cache["k"], cache["v"], meta["tables"], pos,
                              scale=1.0 / math.sqrt(cfg.head_dim_), **scales)
    return out_proj(o, p["wo"]), cache


def paged_verify_attention_block(cfg: ArchConfig, p, x, cache, meta, freqs,
                                 backend):
    """Small-q speculative verify step against the paged KV pool.

    x: [B, Q, d] — per slot the last emitted token plus its draft, padded
    to the fixed width Q; meta: the flat metadata from
    ``attn_backend.verify_meta``.  Write-all-then-attend: every query
    token's K/V scatters into its page first (dead rows to the null page),
    then each query attends the post-write pool under the per-query mask
    ``token_pos <= pos + j`` and ``j < n_q`` — so a rejected draft's K/V is
    invisible to every query that survives the accept decision and is
    overwritten in place by the next step's writes at the same positions.
    Per token the projections, rope, scatter and attend are the per-row
    ops of the decode block.  Returns (out [B, Q, d], cache)."""
    pos, Q = meta["pos"], x.shape[1]
    q, k, v = qkv(cfg, p, x)
    positions = pos[:, None] + torch.arange(Q, device=x.device)[None, :]
    q = apply_rope(q, positions, freqs)
    k = apply_rope(k, positions, freqs)
    scales = write_pages(cache, meta["write_page"], meta["write_off"], k, v)
    o = backend.verify_attend(q, cache["k"], cache["v"], meta["tables"], pos,
                              meta["n_q"],
                              scale=1.0 / math.sqrt(cfg.head_dim_), **scales)
    return out_proj(o, p["wo"]), cache


def decode_attention_block(cfg: ArchConfig, p, x, cache, pos, freqs):
    """One-token decode step against a contiguous per-request cache.
    x: [B, d]; pos: [B] absolute positions.  Returns (out [B, d], cache),
    the cache written in place."""
    B = x.shape[0]
    q, k, v = decode_qkv(cfg, p, x, pos, freqs)
    b = torch.arange(B, device=x.device)
    cache["k"][b, pos] = k.to(cache["k"].dtype)
    cache["v"][b, pos] = v.to(cache["v"].dtype)
    valid = decode_valid_mask(pos, cache["k"].shape[1])
    o = masked_token_attend(q, cache["k"], cache["v"], valid,
                            scale=1.0 / math.sqrt(cfg.head_dim_))
    return out_proj(o, p["wo"]), cache
