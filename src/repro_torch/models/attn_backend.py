"""Attention-backend registry: one dispatch point for every paged path.

The serving hot loop is paged attention — prefill writes K/V through
per-request page tables, decode reads every live token back per step.  How
that read happens is a *backend* choice:

* ``reference`` — plain PyTorch gather+attend (``pool[tables]``
  materializes the logical view, then dense masked attention): the plain
  versions of the kernels, and the parity oracle on every device.
* ``hopper`` — the kernels written by hand for Hopper:
  ``kernels.paged_attention`` K1 for decode and K3 for speculative verify
  (each also in its sliding-window ring mode), ``kernels.ragged_prefill``
  K2 for chunk prefill and K4 for sliding-window chunk prefill; for MLA
  latent pages ``kernels.paged_attention`` K5 for decode and K7 for
  speculative verify and ``kernels.ragged_prefill`` K6 for chunk
  prefill.  All walk the page
  table inside the kernel, so the gather never materializes.

A backend implements the three *attend cores* of the dense decoder
(``decode_attend``, ``prefill_attend``, ``verify_attend``), each taking
optional int8 scale pools (``k_scale``/``v_scale`` [P, ps, K] bf16:
``None`` means bf16 payload pages, non-None int8 pages dequantized
``f32(q) * f32(s)`` before use).  The family framing (QKV projection,
RoPE, page-table scatter with write-side quantization, output projection)
is shared code in ``models.attention``.  MLA layers have their own cores
(``mla_decode_attend``, ``mla_prefill_attend``, ``mla_verify_attend``,
each taking optional ``ckv_scale``/``krope_scale`` [P, ps] bf16 for int8
latent pages) behind the framing of ``models.mla``.  Model code routes through ``backend.paged_prefill`` /
``paged_decode`` / ``paged_verify``.

Every dense core also takes ``softcap`` (``cfg.attn_logit_softcap``, the
TPU kernels' logit softcap: ``c * tanh(s / c)`` after the scale, before
the mask), which K1–K4 apply in their kernels.

The training forward has one more core, ``train_attend``: full-causal
self-attention over a whole sequence, differentiable.  ``reference`` runs
``models.attention.chunked_attention`` (the port of the JAX training
attention); ``hopper`` runs kernel K9 (``kernels.flash_attention``, the TPU
target of that attention) wherever the layer is full-causal GQA without a
softcap, and the chunked core for sliding-window layers and for capped
ones, where the TPU has no kernel either (JAX's ``flash_attention_fwd``
has no softcap, so the JAX package trains a capped model through its XLA
chunked attention).  The enc-dec encoder's bidirectional self-attention
has its own core, ``full_attend`` (``Sq == Sk``, no mask): the chunked
core with ``causal=False`` on ``reference``, K9 in full mode on
``hopper`` (the chunked core there too when capped).  The
decoder's cross-attention (``Sq != Sk``) stays the plain non-causal core
on both: the TPU kernel takes one sequence length for queries and keys.
The static ``prefill`` keeps the chunked core on every backend.

Selection follows ``ServeConfig.attn_backend`` (``auto`` | ``reference`` |
``hopper``).  ``auto`` resolves by the device the tensors live on: ``cuda``
gives ``hopper``, ``cpu`` gives ``reference``; ``hopper`` on the CPU raises.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..kernels.flash_attention import flash_attention_train
from ..kernels.paged_attention import (mla_paged_decode,
                                      mla_paged_decode_plain,
                                      mla_paged_verify,
                                      mla_paged_verify_plain, paged_decode,
                                      paged_decode_plain, paged_verify,
                                      paged_verify_plain)
from ..kernels.ragged_prefill import (mla_ragged_prefill,
                                      mla_ragged_prefill_plain,
                                      ragged_prefill, ragged_prefill_plain,
                                      windowed_prefill,
                                      windowed_prefill_plain)
from . import attention, mla
from .attention import chunked_attention

# ---------------------------------------------------------------- registry

_REGISTRY: Dict[str, "AttentionBackend"] = {}


def register_backend(cls):
    """Class decorator: instantiate and register under ``cls.name``."""
    _REGISTRY[cls.name] = cls()
    return cls


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def resolve_backend(name: str, device) -> str:
    """Resolve a ``ServeConfig.attn_backend`` knob against the device the
    model runs on: ``auto`` is ``hopper`` for ``cuda`` and ``reference``
    for ``cpu``; an explicit ``hopper`` off the card raises."""
    dev = torch.device(device)
    if name == "auto":
        return "hopper" if dev.type == "cuda" else "reference"
    if name not in _REGISTRY:
        raise ValueError(f"unknown attention backend {name!r}; "
                         f"available: {available_backends()}")
    if name == "hopper" and dev.type != "cuda":
        raise ValueError("attn_backend='hopper' launches CUDA kernels; the "
                         f"model runs on {str(dev)!r}")
    return name


def get_backend(name: str) -> "AttentionBackend":
    """A registered backend by concrete name (resolve ``auto`` first)."""
    if name not in _REGISTRY:
        raise ValueError(f"unknown attention backend {name!r}; "
                         f"available: {available_backends()}")
    return _REGISTRY[name]


# ----------------------------------------------------- flat decode metadata

def decode_meta(cfg: ArchConfig, page_size: int, tables: np.ndarray,
                pos: np.ndarray):
    """Flat per-step decode metadata, computed once on the host instead of
    re-derived by every layer: the page-table rows, per-row absolute
    positions, and the physical (page, offset) write target of the step's
    new token — ring-aware for sliding-window families.  numpy in, numpy
    out (int32)."""
    B = tables.shape[0]
    col = pos // page_size
    if cfg.sliding_window:
        # ring modulus contract: the ring IS the table width the engine
        # passes (>= window_pages; the pool may add a slack page for
        # speculative verify rollback) — write targets and every attend
        # core's recovered-position mask use the same modulus
        col = col % tables.shape[1]
    # live rows always have col < table width; the clamp covers idle rows
    col = np.minimum(col, tables.shape[1] - 1)
    return {"tables": tables, "pos": pos,
            "write_page": tables[np.arange(B), col],
            "write_off": pos % page_size}


# ---------------------------------------------------- flat prefill metadata

def prefill_meta(cfg: ArchConfig, page_size: int, tables: np.ndarray,
                 slots: np.ndarray, start: np.ndarray, n_tail: np.ndarray,
                 T: int):
    """Flat per-step prefill metadata, the prefill twin of ``decode_meta``:
    page-table rows, decode-row indices of the rows, each row's chunk offset
    (``start``, absolute position of the chunk's first token) and live token
    count, and the physical (page, offset) write target of every chunk
    position — padding positions, and for sliding-window families the
    positions that age out of the ring before the chunk ends, routed to the
    reserved null page.  ``T`` is the chunk's *text* width (the prefill
    bucket); positions and write targets cover the hidden width
    ``cfg.n_image_tokens + T`` (a vlm prepends its image prefix).  numpy
    in, numpy out."""
    B = tables.shape[0]
    Th = cfg.n_image_tokens + T
    positions = start[:, None] + np.arange(Th)[None, :]           # [B, Th]
    n_live = n_tail + cfg.n_image_tokens
    live = np.arange(Th)[None, :] < n_live[:, None]
    col = positions // page_size
    if cfg.sliding_window:
        # ring modulus = table width (see decode_meta); a chunk longer than
        # the ring writes only its last ring-span of positions
        R = tables.shape[1]
        live = live & (positions >= (start + n_live)[:, None]
                       - R * page_size)
        col = col % R
    col = np.minimum(col, tables.shape[1] - 1)
    page = tables[np.arange(B)[:, None], col]
    return {"tables": tables, "slots": slots, "start": start,
            "n_tail": n_tail, "n_live": n_live,
            "write_page": np.where(live, page, 0).astype(np.int32),
            "write_off": (positions % page_size).astype(np.int32)}


# ---------------------------------------------------- flat verify metadata

def verify_meta(cfg: ArchConfig, page_size: int, tables: np.ndarray,
                pos: np.ndarray, n_q: np.ndarray, Q: int):
    """Flat metadata for a small-q speculative *verify* step.

    Row ``b`` carries ``n_q[b]`` live queries (the last emitted token plus
    its draft) at absolute positions ``pos[b] .. pos[b] + n_q[b] - 1``; the
    step is padded to the fixed width ``Q = speculate_tokens + 1``.  Write
    targets follow the decode ring contract (modulus = table width); dead
    query rows (``j >= n_q[b]``) write to the reserved null page so their
    K/V never lands in an owned page.  numpy in, numpy out."""
    B = tables.shape[0]
    positions = pos[:, None] + np.arange(Q)[None, :]             # [B, Q]
    live = np.arange(Q)[None, :] < n_q[:, None]
    col = positions // page_size
    if cfg.sliding_window:
        col = col % tables.shape[1]
    col = np.minimum(col, tables.shape[1] - 1)
    page = tables[np.arange(B)[:, None], col]
    return {"tables": tables, "pos": pos, "n_q": n_q,
            "write_page": np.where(live, page, 0),
            "write_off": positions % page_size}


def meta_to_device(meta, device, *,
                   non_blocking: bool = False) -> Dict[str, torch.Tensor]:
    """Move a host-built meta dict to the model's device as int32 tensors.

    ``non_blocking`` (CUDA only) copies from page-locked host buffers
    without waiting: a copy from pageable memory returns only once every
    kernel queued before it has run, which would stall a host that plans
    step N+1 while step N runs.  The caching host allocator keeps each
    page-locked buffer until its copy has run on the stream, so a buffer is
    never rewritten under a pending copy."""
    out = {}
    for k, v in meta.items():
        t = torch.from_numpy(np.ascontiguousarray(v, np.int32))
        if non_blocking and torch.device(device).type == "cuda":
            out[k] = t.pin_memory().to(device, non_blocking=True)
        else:
            out[k] = t.to(device)
    return out


# ----------------------------------------------------------- backend classes

class AttentionBackend:
    """Family routing (shared) + attend cores (the extension point)."""

    name = "abstract"

    # -------- public entry points: the only paged-attention call sites

    def paged_prefill(self, cfg: ArchConfig, p, x, cache, meta, freqs, *,
                      q_block: int = 512):
        """Multi-token chunk prefill at an offset into the paged pool.
        ``meta`` is the flat per-step metadata from ``prefill_meta``;
        returns (out [B, T, d], cache)."""
        block = mla.mla_paged_prefill_block if cfg.use_mla \
            else attention.paged_prefill_attention_block
        return block(cfg, p, x, cache, meta, freqs, backend=self,
                     q_block=q_block)

    def paged_decode(self, cfg: ArchConfig, p, x, cache, meta, freqs):
        """One-token decode against the paged pool.  ``meta`` is the flat
        per-step metadata from ``decode_meta``; returns (out [B, d],
        cache)."""
        block = mla.mla_paged_decode_block if cfg.use_mla \
            else attention.paged_decode_attention_block
        return block(cfg, p, x, cache, meta, freqs, backend=self)

    def paged_verify(self, cfg: ArchConfig, p, xs, cache, meta, freqs):
        """Small-q speculative verify against the paged pool: ``xs`` is Q
        tensors [B, d] (query token j of every slot: last emitted token +
        draft, padded to Q), ``meta`` the flat metadata from
        ``verify_meta``.  All Q tokens' K/V scatter into their pages first,
        then every query attends the post-write pool under its own causal
        mask.  Returns (Q outputs [B, d], cache)."""
        block = mla.mla_paged_verify_block if cfg.use_mla \
            else attention.paged_verify_attention_block
        return block(cfg, p, xs, cache, meta, freqs, backend=self)

    # -------- attend cores (override to fuse)

    def decode_attend(self, q, k_pages, v_pages, tables, pos, *,
                      scale: float, window: int = 0, softcap: float = 0.0,
                      k_scale=None, v_scale=None):
        """q: [B, H, D]; pools [P, ps, K, D]; tables [B, n]; pos [B].
        ``window > 0``: ``tables`` is a page ring of ``n * ps`` slots and
        keys are masked by the ring rule; ``softcap > 0``: scores capped
        before the mask.  Returns [B, H, D]."""
        raise NotImplementedError

    def prefill_attend(self, q, k, v, k_pages, v_pages, tables, start,
                       n_live, *, scale: float, window: int = 0,
                       softcap: float = 0.0, q_block: int = 512,
                       k_scale=None, v_scale=None):
        """Ragged multi-token prefill attend: q [B, T, H, D] roped chunk
        queries at per-row offsets ``start``, ``n_live`` [B] real chunk
        tokens, scores times ``scale`` (capped at ``softcap``).  ``window == 0``: the chunk's K/V
        are already resident — the pools are the *post-write* pool and
        ``k``/``v`` are unused.  ``window > 0``: the pools are the
        *pre-write* page ring (``tables`` [B, n_ring]) and ``k``/``v`` [B,
        T, K, D] carry the chunk's fresh roped K/V at model precision (only
        resident pages are int8); rows ``t >= n_live`` come out as zeros.
        ``q_block`` bounds the plain versions' fp32 score memory; a kernel
        tiles its own queries and ignores it.  Returns [B, T, H, D]."""
        raise NotImplementedError

    def verify_attend(self, q, k_pages, v_pages, tables, pos, n_q, *,
                      scale: float, window: int = 0, softcap: float = 0.0,
                      k_scale=None, v_scale=None):
        """Small-q verify attend: q [B, Q, H, D] (query j of row b at
        absolute position ``pos[b] + j``) against the *post-write* pool,
        masked ``token_pos <= pos + j`` (the ring rule for ``window > 0``)
        and ``j < n_q[b]``, scores capped at ``softcap`` before the mask;
        dead query rows return exact zeros on every backend.  Returns [B,
        Q, H, D]."""
        raise NotImplementedError

    def train_attend(self, q, k, v, *, scale: float, window: int = 0,
                     softcap: float = 0.0, q_block: int = 512):
        """Differentiable causal self-attention of the training forward:
        q [B, S, H, D], k, v [B, S, K, D] at positions 0..S-1, scores times
        ``scale`` and capped at ``softcap``; ``window > 0`` also masks keys
        at or before ``q_pos - window``.  ``q_block`` bounds the score
        memory of the chunked core and of K9's backward.  Returns [B, S, H,
        D]."""
        return chunked_attention(q, k, v, scale=scale, q_block=q_block,
                                 window=window, softcap=softcap)

    def full_attend(self, q, k, v, *, scale: float, softcap: float = 0.0,
                    q_block: int = 512):
        """Bidirectional self-attention of the enc-dec encoder: q [B, S, H,
        D], k, v [B, S, K, D], no mask, scores times ``scale`` and capped
        at ``softcap``.  Returns [B, S, H, D]."""
        return chunked_attention(q, k, v, scale=scale, q_block=q_block,
                                 causal=False, softcap=softcap)

    def mla_decode_attend(self, q_eff, q_rope, ckv_pages, krope_pages,
                          tables, pos, *, scale: float, ckv_scale=None,
                          krope_scale=None):
        """Absorbed-latent MLA decode: q_eff [B, H, L] (``w_uk``-absorbed),
        q_rope [B, H, R] (roped) against the latent pages ckv [P, ps, L] /
        krope [P, ps, R], masked ``idx <= pos``.  Returns the latent context
        [B, H, L]."""
        raise NotImplementedError

    def mla_prefill_attend(self, q, ckv_pages, krope_pages, wkv_b, tables,
                           start, n_live, *, nope: int, q_block: int = 512,
                           ckv_scale=None, krope_scale=None):
        """MLA chunk prefill: q [B, T, H, nope + R] (rope part roped) at
        per-row offsets ``start`` against the *post-write* latent pages,
        per-head K/V rebuilt from the latent with ``wkv_b`` [L, H, nope +
        v]; every row is computed (``n_live`` is the contract's and unused,
        as in the TPU kernel).  Returns [B, T, H, v]."""
        raise NotImplementedError

    def mla_verify_attend(self, q_eff, q_rope, ckv_pages, krope_pages,
                          tables, pos, n_q, *, scale: float, ckv_scale=None,
                          krope_scale=None):
        """Small-q absorbed-latent verify: q_eff [B, Q, H, L], q_rope [B, Q,
        H, R], query j of row b at ``pos[b] + j``, against the
        *post-write* latent pages, masked ``idx <= pos + j`` and ``j <
        n_q[b]``; dead query rows return exact zeros on every backend.
        Returns the latent context [B, Q, H, L]."""
        raise NotImplementedError


@register_backend
class ReferenceBackend(AttentionBackend):
    """Plain PyTorch gather+attend — the parity oracle, and the plain
    versions of the Hopper kernels."""

    name = "reference"

    def decode_attend(self, q, k_pages, v_pages, tables, pos, *,
                      scale: float, window: int = 0, softcap: float = 0.0,
                      k_scale=None, v_scale=None):
        return paged_decode_plain(q, k_pages, v_pages, tables, pos,
                                  scale=scale, window=window,
                                  softcap=softcap, k_scale=k_scale,
                                  v_scale=v_scale)

    def prefill_attend(self, q, k, v, k_pages, v_pages, tables, start,
                       n_live, *, scale: float, window: int = 0,
                       softcap: float = 0.0, q_block: int = 512,
                       k_scale=None, v_scale=None):
        if window:
            return windowed_prefill_plain(
                q, k, v, k_pages, v_pages, tables, start, n_live,
                window=window, scale=scale, q_block=q_block,
                softcap=softcap, k_scale=k_scale, v_scale=v_scale)
        return ragged_prefill_plain(q, k_pages, v_pages, tables, start,
                                    scale=scale, q_block=q_block,
                                    softcap=softcap, k_scale=k_scale,
                                    v_scale=v_scale)

    def verify_attend(self, q, k_pages, v_pages, tables, pos, n_q, *,
                      scale: float, window: int = 0, softcap: float = 0.0,
                      k_scale=None, v_scale=None):
        return paged_verify_plain(q, k_pages, v_pages, tables, pos, n_q,
                                  scale=scale, window=window,
                                  softcap=softcap, k_scale=k_scale,
                                  v_scale=v_scale)

    def mla_decode_attend(self, q_eff, q_rope, ckv_pages, krope_pages,
                          tables, pos, *, scale: float, ckv_scale=None,
                          krope_scale=None):
        return mla_paged_decode_plain(q_eff, q_rope, ckv_pages, krope_pages,
                                      tables, pos, scale=scale,
                                      ckv_scale=ckv_scale,
                                      krope_scale=krope_scale)

    def mla_verify_attend(self, q_eff, q_rope, ckv_pages, krope_pages,
                          tables, pos, n_q, *, scale: float, ckv_scale=None,
                          krope_scale=None):
        return mla_paged_verify_plain(q_eff, q_rope, ckv_pages, krope_pages,
                                      tables, pos, n_q, scale=scale,
                                      ckv_scale=ckv_scale,
                                      krope_scale=krope_scale)

    def mla_prefill_attend(self, q, ckv_pages, krope_pages, wkv_b, tables,
                           start, n_live, *, nope: int, q_block: int = 512,
                           ckv_scale=None, krope_scale=None):
        return mla_ragged_prefill_plain(q, ckv_pages, krope_pages, wkv_b,
                                        tables, start, nope=nope,
                                        q_block=q_block, ckv_scale=ckv_scale,
                                        krope_scale=krope_scale)


def _on_card(q: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError("the hopper backend launches CUDA kernels; got "
                         f"tensors on {str(q.device)!r}")


@register_backend
class HopperBackend(AttentionBackend):
    """The hand-written Hopper kernels: K9 (``flash_attention``) for the
    full-causal self-attention of the training forward and, in its full
    mode, for the enc-dec encoder's self-attention, both without a softcap
    (the TPU kernel has none: a capped layer takes the chunked core, as
    JAX trains it); K1
    (``paged_decode``) for decode, K2 (``ragged_prefill``) for chunk
    prefill, K3 (``paged_verify``) for speculative verify and K4
    (``windowed_prefill``) for sliding-window chunk prefill, each in its
    bf16 or int8 mode, K1 and K3 also in their ring mode; for MLA latent
    pages K5 (``mla_paged_decode``) for decode, K7 (``mla_paged_verify``)
    for speculative verify and K6 (``mla_ragged_prefill``) for chunk
    prefill, bf16 or int8.  K1–K4 take the softcap in their kernels."""

    name = "hopper"

    def train_attend(self, q, k, v, *, scale: float, window: int = 0,
                     softcap: float = 0.0, q_block: int = 512):
        _on_card(q)
        # K9, like the TPU kernel it replaces, has no window and no softcap
        if window or softcap or v.shape[-1] != q.shape[-1]:
            return chunked_attention(q, k, v, scale=scale, q_block=q_block,
                                     window=window, softcap=softcap)
        return flash_attention_train(q.contiguous(), k.contiguous(),
                                     v.contiguous(), causal=True,
                                     scale=scale, q_block=q_block)

    def full_attend(self, q, k, v, *, scale: float, softcap: float = 0.0,
                    q_block: int = 512):
        _on_card(q)
        if softcap:                      # K9 has no softcap (see above)
            return chunked_attention(q, k, v, scale=scale, q_block=q_block,
                                     causal=False, softcap=softcap)
        # the differentiable form: the same K9 launch, and a backward for
        # the encoder's training forward
        return flash_attention_train(q.contiguous(), k.contiguous(),
                                     v.contiguous(), causal=False,
                                     scale=scale, q_block=q_block)

    def decode_attend(self, q, k_pages, v_pages, tables, pos, *,
                      scale: float, window: int = 0, softcap: float = 0.0,
                      k_scale=None, v_scale=None):
        _on_card(q)
        return paged_decode(q.contiguous(), k_pages, v_pages, tables, pos,
                            scale=scale, window=window, softcap=softcap,
                            k_scale=k_scale, v_scale=v_scale)

    def prefill_attend(self, q, k, v, k_pages, v_pages, tables, start,
                       n_live, *, scale: float, window: int = 0,
                       softcap: float = 0.0, q_block: int = 512,
                       k_scale=None, v_scale=None):
        _on_card(q)
        if window:
            return windowed_prefill(
                q.contiguous(), k.contiguous(), v.contiguous(), k_pages,
                v_pages, tables, start, n_live, window=window, scale=scale,
                softcap=softcap, k_scale=k_scale, v_scale=v_scale)
        return ragged_prefill(q.contiguous(), k_pages, v_pages, tables, start,
                              scale=scale, softcap=softcap, k_scale=k_scale,
                              v_scale=v_scale)

    def verify_attend(self, q, k_pages, v_pages, tables, pos, n_q, *,
                      scale: float, window: int = 0, softcap: float = 0.0,
                      k_scale=None, v_scale=None):
        _on_card(q)
        return paged_verify(q.contiguous(), k_pages, v_pages, tables, pos,
                            n_q, scale=scale, window=window, softcap=softcap,
                            k_scale=k_scale, v_scale=v_scale)

    def mla_decode_attend(self, q_eff, q_rope, ckv_pages, krope_pages,
                          tables, pos, *, scale: float, ckv_scale=None,
                          krope_scale=None):
        _on_card(q_eff)
        return mla_paged_decode(q_eff.contiguous(), q_rope.contiguous(),
                                ckv_pages, krope_pages, tables, pos,
                                scale=scale, ckv_scale=ckv_scale,
                                krope_scale=krope_scale)

    def mla_verify_attend(self, q_eff, q_rope, ckv_pages, krope_pages,
                          tables, pos, n_q, *, scale: float, ckv_scale=None,
                          krope_scale=None):
        _on_card(q_eff)
        return mla_paged_verify(q_eff.contiguous(), q_rope.contiguous(),
                                ckv_pages, krope_pages, tables, pos, n_q,
                                scale=scale, ckv_scale=ckv_scale,
                                krope_scale=krope_scale)

    def mla_prefill_attend(self, q, ckv_pages, krope_pages, wkv_b, tables,
                           start, n_live, *, nope: int, q_block: int = 512,
                           ckv_scale=None, krope_scale=None):
        _on_card(q)
        return mla_ragged_prefill(q, ckv_pages, krope_pages, wkv_b, tables,
                                  start, nope=nope, ckv_scale=ckv_scale,
                                  krope_scale=krope_scale)
