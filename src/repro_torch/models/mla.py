"""Multi-head Latent Attention (DeepSeek-V2): the port of
``repro.models.mla``.

Prefill materializes per-head K/V from the rank-``kv_lora`` joint
compression; decode uses the *absorbed* formulation, so the per-token cache
is only ``kv_lora + rope_head_dim`` values (512 + 64 for the 236B config):
the latent pages, bf16, or int8 with one bf16 scale per token slot and
payload.  Paged blocks write the latent pool in place (quantizing on the
write for int8 pools), as ``models.attention`` does for the K/V pool, and
hand the attend to the backend (``mla_prefill_attend`` /
``mla_decode_attend`` / ``mla_verify_attend``).
"""
from __future__ import annotations

import math

import torch

from ..configs.base import ArchConfig
from .attention import (NEG_INF, chunked_attention, gather_kv, quantize_int8,
                        softmax)
from .layers import apply_rope, rmsnorm
from .params import ParamDef


def mla_defs(cfg: ArchConfig):
    d, h = cfg.d_model, cfg.n_heads
    qk = cfg.nope_head_dim + cfg.rope_head_dim
    defs = {
        "wkv_a": ParamDef((d, cfg.kv_lora_rank + cfg.rope_head_dim),
                          ("embed", "lora")),
        "kv_norm": ParamDef((cfg.kv_lora_rank,), ("lora",), init="ones"),
        "wkv_b": ParamDef((cfg.kv_lora_rank, h,
                           cfg.nope_head_dim + cfg.v_head_dim),
                          ("lora", "heads", "head_dim")),
        "wo": ParamDef((h, cfg.v_head_dim, d), ("heads", "head_dim", "embed")),
    }
    if cfg.q_lora_rank:
        defs["wq_a"] = ParamDef((d, cfg.q_lora_rank), ("embed", "lora"))
        defs["q_norm"] = ParamDef((cfg.q_lora_rank,), ("lora",), init="ones")
        defs["wq_b"] = ParamDef((cfg.q_lora_rank, h, qk),
                                ("lora", "heads", "head_dim"))
    else:
        defs["wq"] = ParamDef((d, h, qk), ("embed", "heads", "head_dim"))
    return defs


def _queries(cfg: ArchConfig, p, x):
    """x: [B, S, d] -> q [B, S, H, nope + rope] (rope part not roped)."""
    if cfg.q_lora_rank:
        cq = rmsnorm(x @ p["wq_a"], p["q_norm"])
        return torch.einsum("bsl,lhe->bshe", cq, p["wq_b"])
    return torch.einsum("bsd,dhe->bshe", x, p["wq"])


def _latent(cfg: ArchConfig, p, x, positions, freqs):
    """The per-token cache payload of x [B, S, d] at ``positions`` [B|1,
    S]: (ckv [B, S, L] normed latent, krope [B, S, R] roped rope key)."""
    L = cfg.kv_lora_rank
    ckv_full = x @ p["wkv_a"]
    ckv = rmsnorm(ckv_full[..., :L], p["kv_norm"])
    krope = apply_rope(ckv_full[..., L:][:, :, None, :], positions,
                       freqs)[:, :, 0, :]
    return ckv, krope


def _scale(cfg: ArchConfig) -> float:
    return 1.0 / math.sqrt(cfg.nope_head_dim + cfg.rope_head_dim)


def mla_full_block(cfg: ArchConfig, p, x, freqs, *, q_block=512):
    """Full-sequence MLA self-attention (materialized K/V), causal."""
    S = x.shape[1]
    nope = cfg.nope_head_dim
    positions = torch.arange(S, device=x.device)[None, :]
    q = _queries(cfg, p, x)
    q = torch.cat([q[..., :nope], apply_rope(q[..., nope:], positions, freqs)],
                  -1)
    ckv, krope = _latent(cfg, p, x, positions, freqs)
    o = materialized_attend(q, ckv, krope, p["wkv_b"], 0, nope=nope,
                            q_block=q_block)
    return torch.einsum("bshe,hed->bsd", o, p["wo"])


def materialized_attend(q, ckv, krope, wkv_b, q_offset, *, nope: int,
                        q_block: int = 512):
    """Per-head K/V materialized from the latent ``ckv`` [B, S, L] with
    ``wkv_b`` [L, H, nope + v] (one einsum in the latent's dtype, as the
    reference's dtype promotion does: fp32 for a dequantized int8 latent;
    rounded to bf16 for a bf16 latent, from fp64 sums of the exact
    products rounded once to fp32 -- the values of the MLA prefill kernel,
    whatever order the einsum sums in), the roped ``krope`` [B, S, R]
    broadcast over heads, then the chunked causal attend of q [B, T, H,
    nope + R] at ``q_offset`` (an int or [B] per-row offsets), scaled by
    ``1 / sqrt(nope + R)``.  Returns [B, T, H, v] in the latent's dtype."""
    if ckv.dtype == torch.float32:
        kv = torch.einsum("bsl,lhe->bshe", ckv, wkv_b.float())
    else:
        kv = torch.einsum("bsl,lhe->bshe", ckv.double(),
                          wkv_b.double()).float().to(ckv.dtype)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    k = torch.cat([k_nope, krope[:, :, None, :].expand(
        *k_nope.shape[:-1], krope.shape[-1])], -1)
    return chunked_attention(q, k, v, scale=1.0 / math.sqrt(q.shape[-1]),
                             q_block=q_block, q_offset=q_offset)


# ------------------------------------------------------- static latent cache

def mla_cache_defs(cfg: ArchConfig, batch: int, max_len: int):
    return {
        "ckv": ParamDef((batch, max_len, cfg.kv_lora_rank),
                        ("batch", "seq", "lora"), init="zeros"),
        "krope": ParamDef((batch, max_len, cfg.rope_head_dim),
                          ("batch", "seq", None), init="zeros"),
    }


def mla_prefill_cache(cfg: ArchConfig, p, x, freqs):
    """The static cache entries of a full-sequence prefill: {"ckv" [B, S,
    L], "krope" [B, S, R]} for every position of x [B, S, d]."""
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    ckv, krope = _latent(cfg, p, x, positions, freqs)
    return {"ckv": ckv, "krope": krope}


def mla_latent_attend(q_eff, q_rope, cc, cr, valid, *, scale: float):
    """The absorbed-latent attend every plain MLA decode path shares.

    q_eff: [B, H, L] (``w_uk``-absorbed); q_rope: [B, H, R]; cc: [B, S, L];
    cr: [B, S, R] (contiguous logical views); valid: [B, S] bool.  fp32
    scores (latent part plus rope part, then the scale), masked softmax and
    an fp32 probability-weighted context in latent space, rounded to the
    cache dtype only at the output (fp32 for a dequantized int8 latent).
    Returns the latent context [B, H, L]."""
    s = torch.einsum("bhl,bsl->bhs", q_eff.float(), cc.float())
    s = s + torch.einsum("bhr,bsr->bhs", q_rope.float(), cr.float())
    s = torch.where(valid[:, None, :], s * scale, NEG_INF)
    ctx = torch.einsum("bhs,bsl->bhl", softmax(s), cc.float())
    return ctx.to(cc.dtype)


def mla_latent_verify_attend(q_eff, q_rope, cc, cr, valid, *, scale: float):
    """``mla_latent_attend`` with a small query axis (speculative verify).

    q_eff: [B, Q, H, L]; q_rope: [B, Q, H, R]; valid: [B, Q, S] per-query
    masks (``attention.verify_valid_mask``).  Query j runs the one-token
    attend's ops on its [B, H, *] slice under its own mask, so each row is
    the decode attend's at that row's position, bit for bit; rows whose
    mask is all-False (dead / padded queries) return exact zeros, the
    verify kernel's zero accumulator.  Returns the latent context [B, Q,
    H, L]."""
    ctx = torch.stack([mla_latent_attend(q_eff[:, j], q_rope[:, j], cc, cr,
                                         valid[:, j], scale=scale)
                       for j in range(q_eff.shape[1])], 1)
    live = valid.any(-1)[:, :, None, None]                        # [B,Q,1,1]
    return torch.where(live, ctx, torch.zeros_like(ctx))


def _absorbed_query(cfg: ArchConfig, p, x, pos, freqs):
    """The absorbed formulation's inputs for one token a row.  x: [B, d] at
    positions pos [B].  Returns (q_eff [B, H, L] (``w_uk``-absorbed query),
    q_rope [B, H, R] (roped), ckv [B, L], krope [B, R]: the token's latent
    cache payload)."""
    nope = cfg.nope_head_dim
    q = _queries(cfg, p, x[:, None, :])[:, 0]                      # [B,H,·]
    q_nope = q[..., :nope]
    q_rope = apply_rope(q[..., nope:][:, None], pos[:, None], freqs)[:, 0]
    ckv, krope = _latent(cfg, p, x[:, None, :], pos[:, None], freqs)
    w_uk = p["wkv_b"][..., :nope]                                  # [L,H,n]
    q_eff = torch.einsum("bhn,lhn->bhl", q_nope, w_uk)
    return q_eff, q_rope, ckv[:, 0], krope[:, 0]


def _absorbed_out(cfg: ArchConfig, p, ctx):
    """Up-project a latent context [B, H, L] with ``w_uv``, then ``wo``.
    Returns [B, d]."""
    o = torch.einsum("bhl,lhv->bhv", ctx, p["wkv_b"][..., cfg.nope_head_dim:])
    return torch.einsum("bhv,hvd->bd", o, p["wo"])


def mla_decode_block(cfg: ArchConfig, p, x, cache, pos, freqs):
    """Absorbed one-token decode against the contiguous latent cache
    (written in place).  x: [B, d]; pos: [B].  Returns (out [B, d],
    cache)."""
    q_eff, q_rope, ckv, krope = _absorbed_query(cfg, p, x, pos, freqs)
    b = torch.arange(x.shape[0], device=x.device)
    cache["ckv"][b, pos] = ckv.to(cache["ckv"].dtype)
    cache["krope"][b, pos] = krope.to(cache["krope"].dtype)
    valid = torch.arange(cache["ckv"].shape[1],
                         device=x.device)[None, :] <= pos[:, None]
    ctx = mla_latent_attend(q_eff, q_rope, cache["ckv"], cache["krope"],
                            valid, scale=_scale(cfg))
    return _absorbed_out(cfg, p, ctx), cache


# ---------------------------------------------------------- paged latent pool

def mla_paged_cache_defs(cfg: ArchConfig, num_pages: int, page_size: int,
                         kv_dtype: str = "bf16"):
    """One layer's share of the paged latent pool: the absorbed cache
    payload (rank-``kv_lora`` latent + roped rope key) per token slot,
    [P, page_size, L] and [P, page_size, R].  ``kv_dtype == "int8"``
    quantizes both payloads per token slot: int8 payloads plus
    ``ckv_scale``/``krope_scale`` [P, page_size] bf16 (the latent is one
    shared "KV head"), sharing the page axis as the GQA pool's scales
    do."""
    payload = torch.int8 if kv_dtype == "int8" else torch.bfloat16
    defs = {
        "ckv": ParamDef((num_pages, page_size, cfg.kv_lora_rank),
                        (None, "seq", "lora"), dtype=payload, init="zeros"),
        "krope": ParamDef((num_pages, page_size, cfg.rope_head_dim),
                          (None, "seq", None), dtype=payload, init="zeros"),
    }
    if kv_dtype == "int8":
        for name in ("ckv_scale", "krope_scale"):
            defs[name] = ParamDef((num_pages, page_size), (None, "seq"),
                                  dtype=torch.bfloat16, init="zeros")
    return defs


def _write_latent(cache, wp, wo, ckv, krope):
    """Scatter latent rows into one layer's pool at their physical (page,
    offset) targets, in place; an int8 pool (``"ckv_scale" in cache``)
    stores the quantized payloads and their scales at the same targets.
    Returns the scale pools to hand the attend core (empty for bf16)."""
    if "ckv_scale" not in cache:
        cache["ckv"][wp, wo] = ckv.to(cache["ckv"].dtype)
        cache["krope"][wp, wo] = krope.to(cache["krope"].dtype)
        return {}
    (cache["ckv"][wp, wo], cache["ckv_scale"][wp, wo]) = quantize_int8(ckv)
    (cache["krope"][wp, wo],
     cache["krope_scale"][wp, wo]) = quantize_int8(krope)
    return {"ckv_scale": cache["ckv_scale"],
            "krope_scale": cache["krope_scale"]}


def mla_paged_prefill_block(cfg: ArchConfig, p, x, cache, meta, freqs,
                            backend, *, q_block=512):
    """Multi-token MLA chunk prefill, straight into the latent pages.

    The chunk's latent is written token by token through the page table
    (``meta`` carries the precomputed write targets; padding rows go to the
    null page), then the attend against the whole logical sequence --
    cached prefix pages, earlier chunks and the chunk itself -- goes to
    ``backend.mla_prefill_attend``, whose contract is the materialized-K
    formulation of ``mla_full_block`` (per-head K/V rebuilt from the
    post-write latent pages with ``wkv_b``).  Returns (out [B, T, d],
    cache)."""
    T = x.shape[1]
    nope = cfg.nope_head_dim
    positions = meta["start"][:, None] \
        + torch.arange(T, device=x.device)[None, :]
    q = _queries(cfg, p, x)
    q = torch.cat([q[..., :nope], apply_rope(q[..., nope:], positions, freqs)],
                  -1)
    ckv, krope = _latent(cfg, p, x, positions, freqs)
    scales = _write_latent(cache, meta["write_page"], meta["write_off"], ckv,
                           krope)
    o = backend.mla_prefill_attend(q, cache["ckv"], cache["krope"],
                                   p["wkv_b"], meta["tables"], meta["start"],
                                   meta["n_live"], nope=nope,
                                   q_block=q_block, **scales)
    return torch.einsum("bshe,hed->bsd", o, p["wo"]), cache


def mla_materialized_prefill_attend(q, ckv_pages, krope_pages, wkv_b, tables,
                                    start, *, nope: int, q_block: int = 512,
                                    ckv_scale=None, krope_scale=None):
    """The plain MLA prefill attend: gather the (post-write) latent pages
    (int8 pages with their scale pages, dequantized to fp32 as ``f32(q) *
    f32(s)``), materialize per-head K/V from them with ``wkv_b`` exactly as
    ``mla_full_block`` does -- so a cached prefix or an earlier chunk is
    read as if this call had prefilled it itself -- and run the chunked
    causal attend at per-row offsets ``start``.  q: [B, T, H, nope + R]
    (rope part roped).  Returns [B, T, H, v_head_dim] in the latent's
    dtype (fp32 for int8 pages)."""
    cc, cr = gather_kv(ckv_pages, krope_pages, tables, ckv_scale,
                       krope_scale)
    return materialized_attend(q, cc, cr, wkv_b, start, nope=nope,
                               q_block=q_block)


def mla_paged_decode_block(cfg: ArchConfig, p, x, cache, meta, freqs,
                           backend):
    """Absorbed one-token decode against the latent pages (the paged twin of
    ``mla_decode_block``).  ``meta`` is the flat per-step metadata from
    ``attn_backend.decode_meta``; the latent-space attend goes to
    ``backend.mla_decode_attend``.  Returns (out [B, d], cache)."""
    pos = meta["pos"]
    q_eff, q_rope, ckv, krope = _absorbed_query(cfg, p, x, pos, freqs)
    scales = _write_latent(cache, meta["write_page"], meta["write_off"], ckv,
                           krope)
    ctx = backend.mla_decode_attend(q_eff, q_rope, cache["ckv"],
                                    cache["krope"], meta["tables"], pos,
                                    scale=_scale(cfg), **scales)
    return _absorbed_out(cfg, p, ctx), cache


def mla_paged_verify_block(cfg: ArchConfig, p, xs, cache, meta, freqs,
                           backend):
    """Small-q speculative verify against the latent pages (the verify twin
    of ``mla_paged_decode_block``).  xs: Q tensors [B, d] -- query token
    j's activations of every slot (the last emitted token, then the draft,
    padded to Q); meta: the flat metadata from ``attn_backend.verify_meta``.
    Token j's queries, latent and ``q_eff`` are the decode block's ops at
    position ``pos + j`` on a [B, d] input, the decode step's shapes, and
    so is its up-projection; only the attend runs once over all Q tokens.
    Write-all-then-attend: every token's latent scatters first (dead rows
    to the null page), then ``backend.mla_verify_attend`` masks per query
    -- see ``attention.paged_verify_attention_block`` for the rollback
    contract.  Returns (Q outputs [B, d], cache)."""
    pos = meta["pos"]
    q_eff, q_rope, ckv, krope = (torch.stack(t, 1) for t in zip(*(
        _absorbed_query(cfg, p, x, pos + j, freqs)
        for j, x in enumerate(xs))))
    scales = _write_latent(cache, meta["write_page"], meta["write_off"], ckv,
                           krope)
    ctx = backend.mla_verify_attend(q_eff, q_rope, cache["ckv"],
                                    cache["krope"], meta["tables"], pos,
                                    meta["n_q"], scale=_scale(cfg), **scales)
    return [_absorbed_out(cfg, p, ctx[:, j].contiguous())
            for j in range(len(xs))], cache
