"""Decoder-only LM, dense family: the port of ``repro.models.transformer
.DecoderLM`` for ``family="dense"`` with full causal attention.

Parameters keep the JAX package's layer-stacked ``[n_layers, ...]`` leaves;
the ``jax.lax.scan`` over layers becomes a Python loop over layer views of
the stacked leaves.  Paged caches are written in place, so the step
functions return the same pool objects they were given.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..configs.base import ArchConfig
from .attention import (attn_defs, cache_defs, decode_attention_block,
                        full_attention_block, paged_cache_defs, qkv)
from .attn_backend import get_backend
from .cache_spec import CacheFamilySpec, CacheSpec
from .layers import (apply_mlp, apply_norm, apply_rope, embed_defs,
                     embed_tokens, lm_logits, mlp_defs, norm_defs, rope_freqs)
from .params import layer, stack_tree


class DecoderLM:
    """Functional model: all state lives in explicit param / cache dicts.

    ``attn_backend`` selects how the paged serving paths attend (see
    ``models.attn_backend``): the plain ``reference`` gather+attend or the
    ``hopper`` kernels.  The static paths are unaffected."""

    def __init__(self, cfg: ArchConfig, attn_backend: str = "reference"):
        self.cfg = cfg
        self.attn_backend = get_backend(attn_backend)

    # ------------------------------------------------------------ param defs

    def _dense_block_defs(self):
        cfg = self.cfg
        return {
            "ln1": norm_defs(cfg, cfg.d_model),
            "attn": attn_defs(cfg),
            "ln2": norm_defs(cfg, cfg.d_model),
            "mlp": mlp_defs(cfg, cfg.d_model, cfg.d_ff),
        }

    def param_defs(self) -> Dict[str, Any]:
        cfg = self.cfg
        return {"embed": embed_defs(cfg),
                "final_norm": norm_defs(cfg, cfg.d_model),
                "blocks": stack_tree(self._dense_block_defs(), cfg.n_layers)}

    def _freqs(self, device):
        return rope_freqs(self.cfg, self.cfg.head_dim_, device=device)

    def _block(self, p, x, attend):
        """One pre-norm residual block; ``attend(p_attn, h)`` returns the
        attention output for the normed input."""
        cfg = self.cfg
        x = x + attend(p["attn"], apply_norm(cfg, p["ln1"], x))
        return x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x))

    def _logits(self, params, x):
        x = apply_norm(self.cfg, params["final_norm"], x)
        return lm_logits(self.cfg, params["embed"], x)

    # ------------------------------------------------------- full-seq forward

    def forward_hidden(self, params, x):
        """x: [B, S, d] embedded inputs -> final-normed hidden [B, S, d]."""
        cfg = self.cfg
        freqs = self._freqs(x.device)
        for i in range(cfg.n_layers):
            x = self._block(
                layer(params["blocks"], i), x,
                lambda p, h: full_attention_block(cfg, p, h, freqs,
                                                  q_block=cfg.attn_q_block))
        return apply_norm(cfg, params["final_norm"], x)

    # -------------------------------------------------------- static caches

    def cache_defs(self, batch: int, max_len: int):
        return {"blocks": stack_tree(cache_defs(self.cfg, batch, max_len),
                                     self.cfg.n_layers)}

    def prefill(self, params, batch, logits_idx=None):
        """Forward the full prompt; returns (logits at ``logits_idx`` (or the
        last position) [B, V], contiguous cache {"blocks", "pos"}).  The
        cache holds the roped K and the V of every position."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = embed_tokens(params["embed"], tokens)
        freqs = self._freqs(x.device)
        positions = torch.arange(S, device=x.device)[None, :]
        ks, vs = [], []

        def attend(p, h):
            _, k, v = qkv(cfg, p, h)
            ks.append(apply_rope(k, positions, freqs))
            vs.append(v)
            return full_attention_block(cfg, p, h, freqs,
                                        q_block=cfg.attn_q_block)

        for i in range(cfg.n_layers):
            x = self._block(layer(params["blocks"], i), x, attend)
        x = apply_norm(cfg, params["final_norm"], x)
        last = x[:, -1] if logits_idx is None \
            else x[torch.arange(B, device=x.device), logits_idx]
        cache = {"blocks": {"k": torch.stack(ks), "v": torch.stack(vs)},
                 "pos": torch.full((B,), S, dtype=torch.int32,
                                   device=x.device)}
        return lm_logits(cfg, params["embed"], last), cache

    def decode(self, params, cache, tokens):
        """One-token step against a contiguous cache (written in place).
        tokens: [B] int.  Returns (logits [B, V], cache) with pos advanced."""
        cfg = self.cfg
        pos = cache["pos"]
        x = embed_tokens(params["embed"], tokens)
        freqs = self._freqs(x.device)
        for i in range(cfg.n_layers):
            c = layer(cache["blocks"], i)
            x = self._block(
                layer(params["blocks"], i), x,
                lambda p, h: decode_attention_block(cfg, p, h, c, pos,
                                                    freqs)[0])
        cache["pos"] = pos + 1
        return self._logits(params, x), cache

    # -------------------------------------------------------- paged serving

    def cache_spec(self) -> CacheFamilySpec:
        """The decode-cache taxonomy the serving stack schedules against."""
        return CacheFamilySpec(kinds=(CacheSpec("paged_kv"),), paged=True,
                               prefix_cacheable=True)

    def paged_cache_defs(self, num_pages: int, page_size: int,
                         kv_dtype: str = "bf16"):
        """Defs for the layer-stacked paged pool [L, P, ps, K, D]."""
        return stack_tree(paged_cache_defs(self.cfg, num_pages, page_size,
                                           kv_dtype=kv_dtype),
                          self.cfg.n_layers)

    def decode_paged(self, params, kv, state, meta, tokens):
        """One-token continuous-batching decode step.

        kv: layer-stacked paged pool (written in place); state: the
        state-slot pool ({} for this family); meta: flat per-step metadata
        from ``attn_backend.decode_meta`` on the model's device; tokens: [B]
        int.  Idle rows ride along with null-page tables.  Returns
        (logits [B, V], kv, state)."""
        cfg = self.cfg
        x = embed_tokens(params["embed"], tokens)
        freqs = self._freqs(x.device)
        for i in range(cfg.n_layers):
            c = layer(kv, i)
            x = self._block(
                layer(params["blocks"], i), x,
                lambda p, h: self.attn_backend.paged_decode(
                    cfg, p, h, c, meta, freqs)[0])
        return self._logits(params, x), kv, state

    def prefill_paged(self, params, kv, state, meta, tokens, extras=None):
        """Chunk prefill at per-row offsets, straight into the paged pool.

        meta: flat per-step metadata from ``attn_backend.prefill_meta`` on
        the model's device; tokens: [B, T] int, right-padded.  With
        ``start == 0`` this is a whole (or first-chunk) prompt; with
        ``start > 0`` the first ``start`` positions are read from pages
        already resident — radix-cache hits and earlier chunks alike.
        Returns (last-live-token logits [B, V], kv, state)."""
        cfg = self.cfg
        x = embed_tokens(params["embed"], tokens)
        freqs = self._freqs(x.device)
        B = x.shape[0]
        for i in range(cfg.n_layers):
            c = layer(kv, i)
            x = self._block(
                layer(params["blocks"], i), x,
                lambda p, h: self.attn_backend.paged_prefill(
                    cfg, p, h, c, meta, freqs, q_block=cfg.attn_q_block)[0])
        x = apply_norm(cfg, params["final_norm"], x)
        last = x[torch.arange(B, device=x.device), meta["n_live"].long() - 1]
        return lm_logits(cfg, params["embed"], last), kv, state
