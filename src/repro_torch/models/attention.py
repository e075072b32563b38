"""Attention for dense GQA / MQA / MHA decoders: QKV projection with RoPE,
chunked causal attention for full sequences, a contiguous per-request KV
cache for the static path, and the paged blocks the serving engine runs.

The port's counterpart of ``repro.models.attention``, dense subset: the
sliding-window ring (ROADMAP queue 1 item 11), speculative verify (item 7),
int8 pages (item 8) and the logit softcap (no registered arch sets it)
arrive with their slices.  Every softmax is spelled
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
    tensor, bf16.  No batch dim — requests own disjoint page sets and a
    per-request page table maps logical pages to physical ones."""
    if kv_dtype != "bf16":
        raise NotImplementedError(
            f"kv_dtype={kv_dtype!r}: int8 paged KV arrives with ROADMAP "
            "queue 1 item 8")
    hd = cfg.head_dim_
    shape = (num_pages, page_size, cfg.n_kv_heads, hd)
    logical = (None, "seq", "kv_heads", "head_dim")
    return {"k": ParamDef(shape, logical, init="zeros"),
            "v": ParamDef(shape, logical, init="zeros")}


# --------------------------------------------- shared paged-cache helpers

def gather_pages(pages: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Materialize the logical per-request view of a paged pool.

    pages: [P, ps, ...]; tables: [B, n] int physical page ids.  Returns
    [B, n * ps, ...] — request b's pages concatenated in table order."""
    B, n = tables.shape
    return pages[tables.long()].reshape((B, n * pages.shape[1])
                                        + pages.shape[2:])


def decode_valid_mask(pos: torch.Tensor, n: int) -> torch.Tensor:
    """[B, n] validity of a gathered view at one-token decode: absolute
    causal ``idx <= pos``."""
    idx = torch.arange(n, device=pos.device)
    return idx[None, :] <= pos[:, None]


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


# --------------------------------------------------- paged attention blocks
#
# Family framing shared by every backend: QKV + RoPE, page-table scatter,
# output projection.  The attend itself is delegated to ``backend`` (see
# models.attn_backend) — plain gather+attend or the Hopper kernels.

def paged_prefill_attention_block(cfg: ArchConfig, p, x, cache, meta, freqs,
                                  backend, *, q_block=512):
    """Multi-token (chunk) prefill step against the paged KV pool.

    x: [B, T, d] chunk activations; cache: {"k","v": [P, ps, K, D]} one
    layer's pages (written in place); meta: the flat per-step prefill
    metadata from ``attn_backend.prefill_meta``.  The chunk's K/V are
    scattered first, then the queries attend the post-write pages with
    absolute causal masking, so a prefix written by an earlier request
    (radix-cache hit) or an earlier chunk is read exactly as if this call
    had prefilled it.  Returns (out [B, T, d], cache)."""
    B, T, _ = x.shape
    tables, start, n_live = meta["tables"], meta["start"], meta["n_live"]
    q, k, v = qkv(cfg, p, x)
    positions = start[:, None] + torch.arange(T, device=x.device)[None, :]
    q = apply_rope(q, positions, freqs)
    k = apply_rope(k, positions, freqs)
    wp, wo = meta["write_page"], meta["write_off"]
    cache["k"][wp, wo] = k.to(cache["k"].dtype)
    cache["v"][wp, wo] = v.to(cache["v"].dtype)
    o = backend.prefill_attend(q, cache["k"], cache["v"], tables, start,
                               scale=1.0 / math.sqrt(cfg.head_dim_),
                               q_block=q_block)
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
    wp, wo = meta["write_page"], meta["write_off"]
    cache["k"][wp, wo] = k.to(cache["k"].dtype)
    cache["v"][wp, wo] = v.to(cache["v"].dtype)
    o = backend.decode_attend(q, cache["k"], cache["v"], meta["tables"], pos,
                              scale=1.0 / math.sqrt(cfg.head_dim_))
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
