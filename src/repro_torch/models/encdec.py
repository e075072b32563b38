"""Encoder-decoder transformer (the SeamlessM4T backbone): the port of
``repro.models.encdec.EncDecLM`` for serving.

The audio frontend is a stub: each request brings precomputed frame
embeddings at ``frontend_dim`` (``serving.engine._synthetic_frontend``).
The backbone is ``n_enc_layers`` bidirectional encoder layers (roped q and
k, no mask: the backend's ``full_attend``, kernel K9 in its full mode on
``hopper``) and ``n_dec_layers`` causal decoder layers, each with
self-attention, cross-attention against the encoder output and an MLP, in
that residual order.

Serving keeps the decoder's self-attention K/V in the paged pool (K2 for a
prompt chunk, K1 for a decode step on ``hopper``) and pins each request's
cross-attention K/V, computed once from its encoder output, in a state
slot of ``enc_len`` encoder positions a decoder layer
(``state_slot_defs``).  Chunks after the first of a long prompt read the
pinned rows back instead of running the encoder again.  Cross-attention is
the plain non-causal core on every backend (``Sq != Sk``: the TPU kernel
takes one sequence length); the one-token cross-attention of a decode step
is ``_cross_decode``, op for op the JAX package's.

The training forward and ``loss`` (JAX ``encdec.py:92-142``) are ROADMAP
queue 1 item 14b: ``loss`` raises.  Parameters keep the JAX package's layer-stacked leaves;
the ``jax.lax.scan`` over layers becomes a Python loop over layer views.
Paged caches and state slots are written in place.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from ..configs.base import ArchConfig
from .attention import (attn_defs, cache_defs, cross_attention_block,
                        cross_kv, decode_attention_block,
                        full_attention_block, paged_cache_defs, qkv,
                        softmax)
from .attn_backend import get_backend
from .cache_spec import CacheFamilySpec, CacheSpec
from .layers import (apply_mlp, apply_norm, apply_rope, embed_defs,
                     embed_tokens, lm_logits, mlp_defs, norm_defs, rope_freqs)
from .params import layer, stack_tree

ENC_LEN_DECODE = 4096   # encoder length assumed for standalone decode cells


class EncDecLM:
    """Functional model: all state lives in explicit param / cache dicts.
    ``attn_backend`` selects how the encoder's self-attention and the
    decoder's paged self-attention attend (``models.attn_backend``)."""

    def __init__(self, cfg: ArchConfig, attn_backend: str = "reference"):
        self.cfg = cfg
        self.attn_backend = get_backend(attn_backend)

    def cache_spec(self) -> CacheFamilySpec:
        """Paged decoder self-attention KV + a pinned per-request cross
        cache (computed once from the encoder output, read-only during
        decode).  Prompts are frame-conditioned, so token prefixes are not
        shareable, and a preempted request replays (and re-encodes)."""
        return CacheFamilySpec(
            kinds=(CacheSpec("paged_kv"), CacheSpec("cross_kv")),
            paged=True, state_slots=True)

    # ------------------------------------------------------------ param defs

    def _enc_block(self):
        cfg = self.cfg
        return {"ln1": norm_defs(cfg, cfg.d_model), "attn": attn_defs(cfg),
                "ln2": norm_defs(cfg, cfg.d_model),
                "mlp": mlp_defs(cfg, cfg.d_model, cfg.d_ff)}

    def _dec_block(self):
        cfg = self.cfg
        return {"ln1": norm_defs(cfg, cfg.d_model),
                "self_attn": attn_defs(cfg),
                "ln_x": norm_defs(cfg, cfg.d_model),
                "cross_attn": attn_defs(cfg),
                "ln2": norm_defs(cfg, cfg.d_model),
                "mlp": mlp_defs(cfg, cfg.d_model, cfg.d_ff)}

    def param_defs(self) -> Dict[str, Any]:
        cfg = self.cfg
        return {
            "embed": embed_defs(cfg),
            "enc_blocks": stack_tree(self._enc_block(), cfg.n_enc_layers),
            "dec_blocks": stack_tree(self._dec_block(), cfg.n_dec_layers),
            "enc_norm": norm_defs(cfg, cfg.d_model),
            "final_norm": norm_defs(cfg, cfg.d_model),
        }

    def _freqs(self, device):
        return rope_freqs(self.cfg, self.cfg.head_dim_, device=device)

    def _dec_layers(self, params):
        return [layer(params["dec_blocks"], i)
                for i in range(self.cfg.n_dec_layers)]

    # --------------------------------------------------------------- encoder

    def encode(self, params, frames):
        """frames [B, S, frontend_dim] -> encoder output [B, S, d] (bf16):
        pre-norm bidirectional layers through the backend's ``full_attend``,
        then ``enc_norm``."""
        cfg = self.cfg
        x = frames.to(torch.bfloat16)
        freqs = self._freqs(x.device)
        for i in range(cfg.n_enc_layers):
            p = layer(params["enc_blocks"], i)
            h = apply_norm(cfg, p["ln1"], x)
            x = x + full_attention_block(cfg, p["attn"], h, freqs,
                                         causal=False,
                                         q_block=cfg.attn_q_block,
                                         attend=self.attn_backend.full_attend)
            x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x))
        return apply_norm(cfg, params["enc_norm"], x)

    def loss(self, params, batch, chunk: int = 0):
        raise NotImplementedError(
            f"{self.cfg.name}: the enc-dec training forward and loss are not "
            "ported yet: ROADMAP queue 1 item 14b")

    def _logits_at(self, params, x, idx):
        """Final norm, then the logits of row b's position ``idx[b]``."""
        x = apply_norm(self.cfg, params["final_norm"], x)
        last = x[torch.arange(x.shape[0], device=x.device), idx.long()]
        return lm_logits(self.cfg, params["embed"], last)

    # ----------------------------------------------------------------- cache

    def cache_defs(self, batch: int, max_len: int,
                   enc_len: int = ENC_LEN_DECODE):
        """Defs of the contiguous static-path cache, without ``pos``: the
        decoder's self-attention K/V of ``max_len`` positions and the cross
        K/V of ``enc_len`` encoder positions, a decoder layer each."""
        cfg = self.cfg
        return {"self": stack_tree(cache_defs(cfg, batch, max_len),
                                   cfg.n_dec_layers),
                "cross": stack_tree(cache_defs(cfg, batch, enc_len),
                                    cfg.n_dec_layers)}

    def prefill(self, params, batch, logits_idx=None):
        """Encode ``batch["frames"]`` and run the decoder prompt
        ``batch["tokens"]`` [B, S]; returns (logits at ``logits_idx`` (or
        the last position) [B, V], contiguous cache with ``pos``)."""
        cfg = self.cfg
        enc_out = self.encode(params, batch["frames"])
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = embed_tokens(params["embed"], tokens)
        freqs = self._freqs(x.device)
        positions = torch.arange(S, device=x.device)[None, :]
        sk, sv, ck, cv = [], [], [], []
        for p in self._dec_layers(params):
            h = apply_norm(cfg, p["ln1"], x)
            _, k, v = qkv(cfg, p["self_attn"], h)
            sk.append(apply_rope(k, positions, freqs))
            sv.append(v)
            x = x + full_attention_block(cfg, p["self_attn"], h, freqs,
                                         q_block=cfg.attn_q_block)
            kv = cross_kv(p["cross_attn"], enc_out)
            ck.append(kv[0])
            cv.append(kv[1])
            x = x + cross_attention_block(cfg, p["cross_attn"],
                                          apply_norm(cfg, p["ln_x"], x), kv,
                                          q_block=cfg.attn_q_block)
            x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x))
        idx = torch.full((B,), S - 1, device=x.device) \
            if logits_idx is None else logits_idx
        cache = {"self": {"k": torch.stack(sk), "v": torch.stack(sv)},
                 "cross": {"k": torch.stack(ck), "v": torch.stack(cv)},
                 "pos": torch.full((B,), S, dtype=torch.int32,
                                   device=x.device)}
        return self._logits_at(params, x, idx), cache

    def decode(self, params, cache, tokens):
        """One-token step against the contiguous cache (the self K/V
        written in place, the cross K/V read).  Returns (logits [B, V],
        cache) with pos advanced."""
        cfg = self.cfg
        pos = cache["pos"]
        x = embed_tokens(params["embed"], tokens)
        freqs = self._freqs(x.device)
        for i, p in enumerate(self._dec_layers(params)):
            h = apply_norm(cfg, p["ln1"], x)
            x = x + decode_attention_block(cfg, p["self_attn"], h,
                                           layer(cache["self"], i), pos,
                                           freqs)[0]
            c = layer(cache["cross"], i)
            x = x + self._cross_decode(p, apply_norm(cfg, p["ln_x"], x),
                                       c["k"], c["v"])
            x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x))
        cache["pos"] = pos + 1
        x = apply_norm(cfg, params["final_norm"], x)
        return lm_logits(cfg, params["embed"], x), cache

    # ------------------------------------------------------- paged serving

    def paged_cache_defs(self, num_pages: int, page_size: int,
                         kv_dtype: str = "bf16"):
        """Decoder *self*-attention KV pages, stacked over decoder
        layers."""
        return stack_tree(paged_cache_defs(self.cfg, num_pages, page_size,
                                           kv_dtype=kv_dtype),
                          self.cfg.n_dec_layers)

    def state_slot_defs(self, n_slots: int, max_len: int,
                        enc_len: int = ENC_LEN_DECODE):
        """Per-request pinned cross-attention cache: one K/V block of
        ``enc_len`` encoder positions a decoder layer, slot axis 1."""
        cfg = self.cfg
        return {"cross": stack_tree(cache_defs(cfg, n_slots, enc_len),
                                    cfg.n_dec_layers)}

    def _cross_decode(self, p, hx, ck, cv):
        """One-token cross-attention against pinned cross rows: hx [B, d];
        ck, cv [B, enc_len, K, D].  fp32 scores divided by sqrt(D), the
        softmax's probabilities cast to the value dtype, an fp32 PV sum
        with one cast.  Returns [B, d]."""
        cfg = self.cfg
        pc = p["cross_attn"]
        q = torch.einsum("bd,dhe->bhe", hx, pc["wq"])
        if "bq" in pc:
            q = q + pc["bq"]
        K = cfg.n_kv_heads
        qg = q.reshape(q.shape[0], K, cfg.n_heads // K, cfg.head_dim_)
        s = torch.einsum("bkgd,bskd->bkgs", qg.float(), ck.float())
        att = softmax(s / math.sqrt(cfg.head_dim_)).to(cv.dtype)
        o = torch.einsum("bkgs,bskd->bkgd", att.float(), cv.float())
        o = o.to(cv.dtype).reshape(o.shape[0], cfg.n_heads, cfg.head_dim_)
        return torch.einsum("bhe,hed->bd", o, pc["wo"])

    def decode_paged(self, params, kv, state, meta, tokens):
        """One-token continuous-batching decode: paged self-attention
        through the backend (``meta`` from ``attn_backend.decode_meta``),
        then cross-attention against the slot-pinned rows (slot i is batch
        row i), read only.  Returns (logits [B, V], kv, state)."""
        cfg = self.cfg
        x = embed_tokens(params["embed"], tokens)
        freqs = self._freqs(x.device)
        for i, p in enumerate(self._dec_layers(params)):
            h = apply_norm(cfg, p["ln1"], x)
            x = x + self.attn_backend.paged_decode(
                cfg, p["self_attn"], h, layer(kv, i), meta, freqs)[0]
            c = layer(state["cross"], i)
            x = x + self._cross_decode(p, apply_norm(cfg, p["ln_x"], x),
                                       c["k"], c["v"])
            x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x))
        x = apply_norm(cfg, params["final_norm"], x)
        return lm_logits(cfg, params["embed"], x), kv, state

    def prefill_paged(self, params, kv, state, meta, tokens, extras=None,
                      continuation: bool = False):
        """Chunk prefill: encode each row's frames (``extras["frames"]``
        [B, enc_len, frontend_dim]), write the decoder prompt chunk's self
        K/V through the page tables (``meta`` from
        ``attn_backend.prefill_meta``; ``start > 0`` resumes a chunked
        prompt against its resident pages), and pin the cross K/V into the
        state slots at rows ``meta["slots"]`` (out-of-range rows, batch
        padding, scatter nothing).  ``continuation=True`` (chunks after
        the first) runs no encoder: each layer cross-attends the rows the
        first chunk pinned, the same bf16 values the projection gave.
        Returns (last-live-token logits [B, V], kv, state)."""
        cfg = self.cfg
        slots = meta["slots"].long()
        if continuation:
            rows = slots.clamp(0, state["cross"]["k"].shape[1] - 1)
        else:
            enc_out = self.encode(params, extras["frames"])
            keep = slots < state["cross"]["k"].shape[1]
            dst = slots[keep]
        x = embed_tokens(params["embed"], tokens)
        freqs = self._freqs(x.device)
        for i, p in enumerate(self._dec_layers(params)):
            h = apply_norm(cfg, p["ln1"], x)
            x = x + self.attn_backend.paged_prefill(
                cfg, p["self_attn"], h, layer(kv, i), meta, freqs,
                q_block=cfg.attn_q_block)[0]
            if continuation:
                ckv = tuple(state["cross"][n][i, rows] for n in ("k", "v"))
            else:
                ckv = cross_kv(p["cross_attn"], enc_out)
                for n, t in zip(("k", "v"), ckv):
                    pool = state["cross"][n]
                    pool[i, dst] = t[keep].to(pool.dtype)
            x = x + cross_attention_block(cfg, p["cross_attn"],
                                          apply_norm(cfg, p["ln_x"], x), ckv,
                                          q_block=cfg.attn_q_block)
            x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x))
        return self._logits_at(params, x, meta["n_tail"] - 1), kv, state
