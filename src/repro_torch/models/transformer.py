"""Decoder-only LM: the port of ``repro.models.transformer.DecoderLM`` for
the dense family (full causal or sliding-window attention), the MoE family
(``dense_blocks`` of ``first_k_dense`` dense layers, then MoE ``blocks``;
GQA attention, or MLA latent attention with ``use_mla``) and the two
state-slot families: ``ssm`` (mamba2: a stack of SSD blocks) and
``hybrid`` (recurrentgemma: groups of (RG-LRU, RG-LRU, local attention)
layers, then ``tail_blocks`` of RG-LRU layers, with a gemma-style
``sqrt(d_model)`` embedding scale), and the ``vlm`` family (llava: the
dense family behind an image prefix of ``n_image_tokens`` precomputed patch
embeddings, projected by ``vision_proj`` and placed before the text at
positions ``[0, n_image_tokens)``).

``loss`` is the LM training objective of every family: next-token CE
over the training forward ``forward_hidden``, the vlm's behind its image
prefix with JAX's label mask over it.  Parameters keep
the JAX package's layer-stacked ``[n_layers, ...]`` leaves; the
``jax.lax.scan`` over layers becomes a Python loop over layer views of the
stacked leaves.  The caches stack every layer, dense lead-in layers first,
so cache layer ``i`` is the i-th layer run.  Paged caches and state slots
are written in place, so the step functions return the same pool objects
they were given.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Tuple

import torch

from ..configs.base import ArchConfig
from .attention import (attn_defs, cache_defs, decode_attention_block,
                        full_attention_block, paged_cache_defs, qkv)
from .attn_backend import get_backend
from .cache_spec import CacheFamilySpec, CacheSpec
from .layers import (apply_mlp, apply_norm, apply_rope, chunked_nll,
                     embed_defs, embed_tokens, lm_logits, mlp_defs, norm_defs,
                     rope_freqs)
from .mla import (mla_cache_defs, mla_decode_block, mla_defs, mla_full_block,
                  mla_paged_cache_defs, mla_prefill_cache)
from .moe import moe_apply, moe_decode_apply, moe_defs
from .params import ParamDef, layer, stack_tree, tree_leaves
from .rglru import (rglru_block, rglru_cache_defs, rglru_decode_block,
                    rglru_defs)
from .ssm import (ssm_block, ssm_cache_defs, ssm_decode_block, ssm_defs,
                  ssm_inputs)

RECURRENT = ("ssm", "hybrid")


class DecoderLM:
    """Functional model: all state lives in explicit param / cache dicts.

    ``attn_backend`` selects how the paged serving paths and the training
    forward attend (see ``models.attn_backend``): the plain ``reference``
    cores or the ``hopper`` kernels.  The static paths are unaffected."""

    def __init__(self, cfg: ArchConfig, attn_backend: str = "reference"):
        self.cfg = cfg
        self.attn_backend = get_backend(attn_backend)

    # ------------------------------------------------------------ param defs

    def _attn_defs(self):
        return mla_defs(self.cfg) if self.cfg.use_mla else attn_defs(self.cfg)

    def _dense_block_defs(self, d_ff: int = 0):
        cfg = self.cfg
        return {
            "ln1": norm_defs(cfg, cfg.d_model),
            "attn": self._attn_defs(),
            "ln2": norm_defs(cfg, cfg.d_model),
            "mlp": mlp_defs(cfg, cfg.d_model, d_ff or cfg.d_ff),
        }

    def _moe_block_defs(self):
        cfg = self.cfg
        return {
            "ln1": norm_defs(cfg, cfg.d_model),
            "attn": self._attn_defs(),
            "ln2": norm_defs(cfg, cfg.d_model),
            "moe": moe_defs(cfg),
        }

    def _rec_block_defs(self):
        cfg = self.cfg
        return {
            "ln1": norm_defs(cfg, cfg.d_model),
            "rec": rglru_defs(cfg),
            "ln2": norm_defs(cfg, cfg.d_model),
            "mlp": mlp_defs(cfg, cfg.d_model, cfg.d_ff),
        }

    def _ssm_block_defs(self):
        return {"ln1": norm_defs(self.cfg, self.cfg.d_model),
                "ssm": ssm_defs(self.cfg)}

    def _hybrid_counts(self) -> Tuple[int, int, int]:
        """(n_groups, n_rec_tail, n_attn).  Pattern = (rec, rec, attn);
        leftover layers are 'rec' by pattern order."""
        per = len(self.cfg.block_pattern)
        n_groups = self.cfg.n_layers // per
        return n_groups, self.cfg.n_layers - n_groups * per, n_groups

    @property
    def recurrent(self) -> bool:
        return self.cfg.family in RECURRENT

    def param_defs(self) -> Dict[str, Any]:
        cfg = self.cfg
        defs = {"embed": embed_defs(cfg),
                "final_norm": norm_defs(cfg, cfg.d_model)}
        if cfg.n_image_tokens:
            defs["vision_proj"] = ParamDef((cfg.frontend_dim, cfg.d_model),
                                           (None, "embed"))
        if cfg.family == "ssm":
            defs["blocks"] = stack_tree(self._ssm_block_defs(), cfg.n_layers)
        elif cfg.family == "hybrid":
            n_groups, tail, n_attn = self._hybrid_counts()
            defs["rec_blocks"] = stack_tree(self._rec_block_defs(),
                                            2 * n_groups)
            defs["attn_blocks"] = stack_tree(self._dense_block_defs(), n_attn)
            if tail:
                defs["tail_blocks"] = stack_tree(self._rec_block_defs(), tail)
        elif cfg.is_moe:
            k = cfg.first_k_dense
            if k:
                defs["dense_blocks"] = stack_tree(
                    self._dense_block_defs(cfg.d_ff_dense or cfg.d_ff), k)
            defs["blocks"] = stack_tree(self._moe_block_defs(),
                                        cfg.n_layers - k)
        else:
            defs["blocks"] = stack_tree(self._dense_block_defs(),
                                        cfg.n_layers)
        return defs

    def _layers(self, params):
        """The parameters of every layer in the order they run: the dense
        lead-in layers, then the main stack.  Layer ``i`` of this sequence
        owns cache layer ``i``."""
        dense = params.get("dense_blocks")
        k = self.cfg.first_k_dense if dense is not None else 0
        return [layer(dense, i) for i in range(k)] \
            + [layer(params["blocks"], i)
               for i in range(self.cfg.n_layers - k)]

    def _freqs(self, device):
        cfg = self.cfg
        if cfg.family == "ssm":
            return None
        hd = cfg.rope_head_dim if cfg.use_mla else cfg.head_dim_
        return rope_freqs(cfg, hd, device=device)

    def _embed(self, params, tokens):
        """Token embeddings; the hybrid scales them by ``sqrt(d_model)``
        rounded to the activation dtype first, as JAX rounds a Python
        scalar (weak type) before a bf16 multiply."""
        x = embed_tokens(params["embed"], tokens)
        if self.cfg.family == "hybrid":
            x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=x.dtype)
        return x

    def _with_image(self, params, x, extras):
        """A vlm's hidden sequence: the image prefix (``image_embeds`` [B,
        n_img, frontend_dim] in the activation dtype, times
        ``vision_proj``) before the text embeddings x [B, T, d]; x itself
        for the other families."""
        if not self.cfg.n_image_tokens:
            return x
        img = extras["image_embeds"].to(x.dtype) @ params["vision_proj"]
        return torch.cat([img, x], dim=1)

    def _block(self, p, x, attend, moe):
        """One pre-norm residual block; ``attend(p_attn, h)`` returns the
        attention output for the normed input.  MoE layers apply ``moe(p_moe,
        h)`` (the JAX package's group routing of the call site) where dense
        layers apply their MLP."""
        cfg = self.cfg
        x = x + attend(p["attn"], apply_norm(cfg, p["ln1"], x))
        h = apply_norm(cfg, p["ln2"], x)
        if "moe" in p:
            return x + moe(p["moe"], h)
        return x + apply_mlp(cfg, p["mlp"], h)

    def _seq_moe(self, p, h):
        """MoE over a [B, S, d] sequence: every row is a group of S tokens
        (padding included) at ``capacity(cfg, S)``."""
        return moe_apply(self.cfg, p, h)[0]

    def _token_moe(self, p, h):
        """MoE over one decode token per row, h [B, d]: the B tokens are
        one group at ``capacity(cfg, B)``."""
        return moe_decode_apply(self.cfg, p, h)

    def _logits(self, params, x):
        x = apply_norm(self.cfg, params["final_norm"], x)
        return lm_logits(self.cfg, params["embed"], x)

    # ------------------------------------------------------- full-seq forward

    def forward_hidden(self, params, x):
        """The training forward.  x: [B, S, d] embedded inputs -> (final-
        normed hidden [B, S, d], the MoE layers' summed load-balance loss,
        fp32; 0 for the other families, as in JAX).  Dense GQA layers, the
        vlm's and the hybrid's local attention attend through the backend's
        ``train_attend`` (K9 on ``hopper`` for full-causal layers; windowed
        ones take the chunked core); MLA layers through the chunked core;
        the state-slot families run ``ssm_block`` / ``rglru_block`` from a
        zero state in ``_rec_layers``' order.  The JAX package may
        recompute activations in the backward (``cfg.remat``); this forward
        keeps them all, which changes memory, not numbers."""
        cfg = self.cfg
        freqs = self._freqs(x.device)
        aux = []

        def moe(p, h):
            out, a = moe_apply(cfg, p, h)
            aux.append(a)
            return out

        if cfg.use_mla:
            def attend(pa, h):
                return mla_full_block(cfg, pa, h, freqs,
                                      q_block=cfg.attn_q_block)
        else:
            window = cfg.attn_window if cfg.family == "hybrid" \
                else cfg.sliding_window

            def attend(pa, h):
                return full_attention_block(
                    cfg, pa, h, freqs, window=window,
                    q_block=cfg.attn_q_block,
                    attend=self.attn_backend.train_attend)
        if self.recurrent:
            for g, _, p in self._rec_layers(params):
                if g == "attn_blocks":
                    x = self._block(p, x, attend, None)
                    continue
                h = apply_norm(cfg, p["ln1"], x)
                if g == "blocks":
                    x = x + ssm_block(cfg, p["ssm"], h)[0]
                    continue
                x = x + rglru_block(cfg, p["rec"], h)[0]
                x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x))
        else:
            for p in self._layers(params):
                x = self._block(p, x, attend, moe)
        total = sum(aux, torch.zeros((), dtype=torch.float32,
                                     device=x.device))
        return apply_norm(cfg, params["final_norm"], x), total

    # ------------------------------------------------------------------ loss

    def loss(self, params, batch, chunk: int = 0):
        """Next-token CE (``layers.chunked_nll``) over the training forward
        of ``batch["tokens"]`` [B, T] (a vlm's hidden sequence is its
        ``batch["image_embeds"]`` prefix, then the text), the final
        position without a label.  The labels and mask are JAX
        ``DecoderLM.loss``'s: the next token, aligned to the hidden
        sequence behind ``n_img`` zero labels, and the text mask rolled
        left by one, so the last image position (label 0) counts too: a
        vlm scores B * T positions.  Returns (loss, {"nll", "aux",
        "tokens"}); MoE models add ``router_aux_coef * aux / n_layers``
        to the loss."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = self._with_image(params, self._embed(params, tokens), batch)
        hidden, aux = self.forward_hidden(params, x)
        B, T = tokens.shape
        n_img = cfg.n_image_tokens
        labels = torch.nn.functional.pad(tokens[:, 1:], (n_img, 1)).long()
        pos = torch.arange(n_img + T, device=tokens.device)
        lmask = ((pos >= n_img - 1) & (pos < n_img + T - 1)).expand(B, -1)
        tot, cnt = chunked_nll(cfg, params["embed"], hidden, labels, lmask,
                               chunk)
        nll = tot / torch.clamp(cnt, min=1.0)
        loss = nll
        if cfg.is_moe:
            loss = loss + cfg.router_aux_coef * aux / max(1, cfg.n_layers)
        return loss, {"nll": nll, "aux": aux, "tokens": cnt}

    # -------------------------------------------------------- static caches

    def cache_defs(self, batch: int, max_len: int):
        """Defs of the contiguous per-request cache (static path), without
        ``pos``: K/V (a ring of ``min(window, max_len)`` entries for
        windowed families) or latents a layer; the state-slot families'
        conv taps and recurrent state a layer, and the hybrid's
        local-attention ring of ``min(attn_window, max_len)`` entries."""
        cfg = self.cfg
        if cfg.family == "ssm":
            return {"blocks": stack_tree(ssm_cache_defs(cfg, batch),
                                         cfg.n_layers)}
        if cfg.family == "hybrid":
            n_groups, tail, n_attn = self._hybrid_counts()
            out = {"rec_blocks": stack_tree(rglru_cache_defs(cfg, batch),
                                            2 * n_groups),
                   "attn_blocks": stack_tree(
                       cache_defs(cfg, batch, max_len,
                                  window=cfg.attn_window), n_attn)}
            if tail:
                out["tail_blocks"] = stack_tree(
                    rglru_cache_defs(cfg, batch), tail)
            return out
        per = mla_cache_defs(cfg, batch, max_len) if cfg.use_mla \
            else cache_defs(cfg, batch, max_len, window=cfg.sliding_window)
        return {"blocks": stack_tree(per, cfg.n_layers)}

    def prefill(self, params, batch, logits_idx=None):
        """Forward the full prompt; returns (logits at ``logits_idx`` (or the
        last position) [B, V], contiguous cache with ``pos``).  The cache
        holds the roped K and the V of every position; for
        sliding-window families only the last ``W = min(window, S)``
        positions, ring-buffered at slots ``t % W`` (the layout the static
        decode reads).  The state-slot families keep each layer's state
        after the last position and its conv taps (the hybrid: its ring of
        the last ``min(attn_window, S)`` keys)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        if self.recurrent:
            n_tail = torch.full((B,), S, dtype=torch.int32,
                                device=tokens.device)
            x, layers = self._recurrent_prefill(
                params, tokens, n_tail, None,
                min(cfg.attn_window, S) if cfg.family == "hybrid" else 0)
            cache = {g: {k: torch.stack(v) for k, v in c.items()}
                     for g, c in layers.items()}
            cache["pos"] = n_tail
            x = apply_norm(cfg, params["final_norm"], x)
            last = x[:, -1] if logits_idx is None \
                else x[torch.arange(B, device=x.device), logits_idx]
            return lm_logits(cfg, params["embed"], last), cache
        x = self._with_image(params, embed_tokens(params["embed"], tokens),
                             batch)
        S = x.shape[1]
        freqs = self._freqs(x.device)
        positions = torch.arange(S, device=x.device)[None, :]
        ks, vs = [], []

        W = min(cfg.sliding_window, S) if cfg.sliding_window else S
        slots = torch.arange(S - W, S, device=x.device) % W

        def attend(p, h):
            if cfg.use_mla:
                c = mla_prefill_cache(cfg, p, h, freqs)
                ks.append(c["ckv"])
                vs.append(c["krope"])
                return mla_full_block(cfg, p, h, freqs,
                                      q_block=cfg.attn_q_block)
            _, k, v = qkv(cfg, p, h)
            k = apply_rope(k, positions, freqs)
            if cfg.sliding_window:
                k = torch.zeros_like(k[:, :W]).index_copy_(1, slots,
                                                           k[:, S - W:])
                v = torch.zeros_like(v[:, :W]).index_copy_(1, slots,
                                                           v[:, S - W:])
            ks.append(k)
            vs.append(v)
            return full_attention_block(cfg, p, h, freqs,
                                        window=cfg.sliding_window,
                                        q_block=cfg.attn_q_block)

        for p in self._layers(params):
            x = self._block(p, x, attend, self._seq_moe)
        x = apply_norm(cfg, params["final_norm"], x)
        last = x[:, -1] if logits_idx is None \
            else x[torch.arange(B, device=x.device), logits_idx]
        names = ("ckv", "krope") if cfg.use_mla else ("k", "v")
        cache = {"blocks": dict(zip(names, (torch.stack(ks),
                                            torch.stack(vs)))),
                 "pos": torch.full((B,), S, dtype=torch.int32,
                                   device=x.device)}
        return lm_logits(cfg, params["embed"], last), cache

    def decode(self, params, cache, tokens):
        """One-token step against a contiguous cache (written in place).
        tokens: [B] int.  Returns (logits [B, V], cache) with pos advanced."""
        cfg = self.cfg
        pos = cache["pos"]
        if self.recurrent:
            x = self._recurrent_decode(params, cache, tokens, pos)
            cache["pos"] = pos + 1
            return self._logits(params, x), cache
        x = embed_tokens(params["embed"], tokens)
        freqs = self._freqs(x.device)
        block = mla_decode_block if cfg.use_mla else functools.partial(
            decode_attention_block, window=cfg.sliding_window)
        for i, p in enumerate(self._layers(params)):
            c = layer(cache["blocks"], i)
            x = self._block(
                p, x, lambda pa, h: block(cfg, pa, h, c, pos, freqs)[0],
                self._token_moe)
        cache["pos"] = pos + 1
        return self._logits(params, x), cache

    # ------------------------------------------- the state-slot families

    def _rec_layers(self, params):
        """(group, index, params) of every recurrent-family layer in the
        order they run: ssm ``blocks``; hybrid groups of (rec 2g, rec 2g +
        1, attn g), then ``tail_blocks``."""
        if self.cfg.family == "ssm":
            return [("blocks", i, layer(params["blocks"], i))
                    for i in range(self.cfg.n_layers)]
        n_groups, tail, _ = self._hybrid_counts()
        out = []
        for g in range(n_groups):
            out += [("rec_blocks", 2 * g, layer(params["rec_blocks"], 2 * g)),
                    ("rec_blocks", 2 * g + 1,
                     layer(params["rec_blocks"], 2 * g + 1)),
                    ("attn_blocks", g, layer(params["attn_blocks"], g))]
        return out + [("tail_blocks", i, layer(params["tail_blocks"], i))
                      for i in range(tail)]

    def _recurrent_decode(self, params, cache, tokens, pos):
        """One token through every state-slot layer against ``cache`` (one
        state row a batch row, written in place).  Returns the last hidden
        [B, d] before the final norm."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        freqs = self._freqs(x.device)
        for g, i, p in self._rec_layers(params):
            c = layer(cache[g], i)
            if g == "blocks":
                x = x + ssm_decode_block(cfg, p["ssm"],
                                         apply_norm(cfg, p["ln1"], x), c)
            elif g == "attn_blocks":
                x = self._block(p, x, lambda pa, h: decode_attention_block(
                    cfg, pa, h, c, pos, freqs, window=cfg.attn_window)[0],
                    None)
            else:
                x = x + rglru_decode_block(cfg, p["rec"],
                                           apply_norm(cfg, p["ln1"], x), c)
                x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x))
        return x

    def _recurrent_prefill(self, params, tokens, n_tail, mask, L_ring,
                           emit=None):
        """The one state-slot prefill forward, shared by the static path
        (unmasked, every row at full length, ring ``min(attn_window, S)``)
        and the state-slot serving path (length-masked right-padded rows,
        the ring the pool allocated).  tokens: [B, S]; n_tail: [B] true
        lengths; mask: [B, S] bool or None.  Each layer's cache leaves at
        its row's true length — conv taps, recurrent state, the hybrid's
        K/V ring — go to ``emit(group, index, leaves)``; without ``emit``
        they are collected.  Returns (hidden [B, S, d] before the final
        norm, {group: {leaf: [per-layer tensors]}})."""
        cfg = self.cfg
        B, S = tokens.shape
        dev = tokens.device
        x = self._embed(params, tokens)
        freqs = self._freqs(dev)
        w1 = cfg.conv_width - 1
        idx = n_tail.long()[:, None] - w1 + torch.arange(w1, device=dev)
        valid = (idx >= 0)[..., None]
        rows = torch.arange(B, device=dev)[:, None]

        def conv_tail(u):
            """The last ``conv_width - 1`` rows of ``u`` before each row's
            true length; zeros where the prompt is shorter than the conv
            receptive field (the zeroed decode conv cache)."""
            return torch.where(valid, u[rows, idx.clamp(min=0)],
                               torch.zeros((), dtype=u.dtype, device=dev))

        collected: Dict[str, Dict[str, list]] = {}
        if emit is None:
            def emit(g, i, leaves):
                for k, v in leaves.items():
                    collected.setdefault(g, {}).setdefault(k, []).append(v)

        if L_ring:
            positions = torch.arange(S, device=dev)[None, :]
            t = n_tail.long()[:, None] - L_ring \
                + torch.arange(L_ring, device=dev)[None, :]       # [B, R]
            ring = t % L_ring
            t_ok = (t >= 0)[..., None, None]
        for g, i, p in self._rec_layers(params):
            h = apply_norm(cfg, p["ln1"], x)
            if g == "blocks":
                inputs = ssm_inputs(cfg, p["ssm"], h)
                s, final = ssm_block(cfg, p["ssm"], h, length_mask=mask,
                                     inputs=inputs)
                x = x + s
                emit(g, i, {"conv_x": conv_tail(inputs[1]),
                            "conv_B": conv_tail(inputs[2]),
                            "conv_C": conv_tail(inputs[3]), "state": final})
            elif g == "attn_blocks":
                # ring-buffer each row's last L_ring *true* keys at slots
                # t % L_ring: positions past a row's prompt never enter it
                _, k, v = qkv(cfg, p["attn"], h)
                k = apply_rope(k, positions, freqs)
                zero = torch.zeros((), dtype=k.dtype, device=dev)
                ck = torch.zeros((B, L_ring) + k.shape[2:], dtype=k.dtype,
                                 device=dev)
                cv = torch.zeros_like(ck)
                ck[rows, ring] = torch.where(t_ok, k[rows, t.clamp(min=0)],
                                             zero)
                cv[rows, ring] = torch.where(t_ok, v[rows, t.clamp(min=0)],
                                             zero)
                x = x + full_attention_block(cfg, p["attn"], h, freqs,
                                             window=cfg.attn_window,
                                             q_block=cfg.attn_q_block)
                x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x))
                emit(g, i, {"k": ck, "v": cv})
            else:
                u_raw = h @ p["rec"]["w_in"]
                r, final = rglru_block(cfg, p["rec"], h, length_mask=mask,
                                       u_raw=u_raw)
                x = x + r
                x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x))
                emit(g, i, {"conv": conv_tail(u_raw), "state": final})
        return x, collected

    def _prefill_state_slots(self, params, kv, state, slots, n_tail,
                             tokens):
        """Full-prompt prefill for the state-slot families: the masked
        full-sequence forward (right padding is a recurrence no-op under
        the length mask), each layer's state and conv taps at the *true*
        prompt length scattered in place into the state pool at rows
        ``slots`` (out-of-range rows — batch padding — are dropped).
        Returns (last-real-token logits [B, V], kv, state)."""
        cfg = self.cfg
        B, S = tokens.shape
        dev = tokens.device
        n_tail = n_tail.long()
        mask = torch.arange(S, device=dev)[None, :] < n_tail[:, None]
        n_slots = next(tree_leaves(state))[1].shape[1]
        keep = slots.long() < n_slots
        dst = slots.long()[keep]

        def emit(g, i, leaves):
            for k, v in leaves.items():
                pool = state[g][k]
                pool[i, dst] = v[keep].to(pool.dtype)

        L_ring = state["attn_blocks"]["k"].shape[2] \
            if cfg.family == "hybrid" else 0
        x, _ = self._recurrent_prefill(params, tokens, n_tail, mask, L_ring,
                                       emit)
        x = apply_norm(cfg, params["final_norm"], x)
        last = x[torch.arange(B, device=dev), n_tail - 1]
        return lm_logits(cfg, params["embed"], last), kv, state

    # -------------------------------------------------------- paged serving

    def cache_spec(self) -> CacheFamilySpec:
        """The decode-cache taxonomy the serving stack schedules against:
        latent pages for MLA, a page ring of O(window) pages for
        sliding-window families (not prefix-cacheable: ring slots are
        recycled in place), plain paged KV otherwise; the state-slot
        families hold their whole cache (the hybrid's local-attention ring
        included) in one checkpointable slot a request."""
        cfg = self.cfg
        if cfg.family == "ssm":
            return CacheFamilySpec(kinds=(CacheSpec("state_slot"),),
                                   paged=False, state_slots=True,
                                   checkpointable=True)
        if cfg.family == "hybrid":
            return CacheFamilySpec(
                kinds=(CacheSpec("state_slot"),
                       CacheSpec("state_slot", window=cfg.attn_window)),
                paged=False, state_slots=True, checkpointable=True)
        if cfg.use_mla:
            return CacheFamilySpec(kinds=(CacheSpec("paged_mla"),),
                                   paged=True, prefix_cacheable=True)
        w = cfg.sliding_window
        if w:
            return CacheFamilySpec(kinds=(CacheSpec("windowed_kv", window=w),),
                                   paged=True, window=w)
        # vlm prompts are image-conditioned: equal token prefixes do not
        # mean equal K/V, so the radix cache must not share them
        return CacheFamilySpec(kinds=(CacheSpec("paged_kv"),), paged=True,
                               prefix_cacheable=not cfg.n_image_tokens,
                               prefix_tokens=cfg.n_image_tokens)

    def paged_cache_defs(self, num_pages: int, page_size: int,
                         kv_dtype: str = "bf16"):
        """Defs for the layer-stacked paged pool: [L, P, ps, K, D] K/V
        pages, or [L, P, ps, kv_lora] + [L, P, ps, rope] latent pages for
        MLA (int8 pools add their [L, P, ps, ...] bf16 scale pages); {} for
        the state-slot families."""
        if not self.cache_spec().paged:
            return {}
        per = mla_paged_cache_defs if self.cfg.use_mla else paged_cache_defs
        return stack_tree(per(self.cfg, num_pages, page_size,
                              kv_dtype=kv_dtype), self.cfg.n_layers)

    def state_slot_defs(self, n_slots: int, max_len: int, enc_len: int = 0):
        """Defs of the per-request state-slot pool ({} for the paged
        families): ``cache_defs(n_slots, max_len)``, so the slot axis is
        axis 1 of every layer-stacked leaf and the contiguous decode path
        runs on the pool as it is.  ``enc_len`` is the enc-dec model's and
        unused here."""
        return self.cache_defs(n_slots, max_len) if self.recurrent else {}

    def decode_paged(self, params, kv, state, meta, tokens):
        """One-token continuous-batching decode step.

        kv: layer-stacked paged pool (written in place); state: the
        state-slot pool ({} for the paged families; slot i is batch row
        i, written in place by the contiguous decode path); meta: flat
        per-step metadata from ``attn_backend.decode_meta`` on the model's
        device; tokens: [B] int.  Idle rows ride along with null-page
        tables; their state rows are overwritten at the next admission.
        Returns (logits [B, V], kv, state)."""
        cfg = self.cfg
        if self.recurrent:
            x = self._recurrent_decode(params, state, tokens, meta["pos"])
            return self._logits(params, x), kv, state
        x = embed_tokens(params["embed"], tokens)
        freqs = self._freqs(x.device)
        for i, p in enumerate(self._layers(params)):
            c = layer(kv, i)
            x = self._block(
                p, x, lambda pa, h: self.attn_backend.paged_decode(
                    cfg, pa, h, c, meta, freqs)[0], self._token_moe)
        return self._logits(params, x), kv, state

    def prefill_paged(self, params, kv, state, meta, tokens, extras=None):
        """Chunk prefill at per-row offsets, straight into the paged pool
        (or, for the state-slot families, a whole prompt into the state
        pool at rows ``meta["slots"]``).

        meta: flat per-step metadata from ``attn_backend.prefill_meta`` on
        the model's device; tokens: [B, T] int, right-padded.  With
        ``start == 0`` this is a whole (or first-chunk) prompt; with
        ``start > 0`` the first ``start`` positions are read from pages
        already resident — radix-cache hits and earlier chunks alike.  A
        vlm's hidden sequence is its image prefix (``extras["image_embeds"]``
        [B, n_img, frontend_dim], always live, at positions ``[0, n_img)``:
        a vlm prompt is never chunked) then the tokens; ``meta["n_live"]``
        counts both.  Returns (last-live-token logits [B, V], kv,
        state)."""
        cfg = self.cfg
        if self.recurrent:
            return self._prefill_state_slots(params, kv, state, meta["slots"],
                                             meta["n_tail"], tokens)
        x = self._with_image(params, embed_tokens(params["embed"], tokens),
                             extras)
        freqs = self._freqs(x.device)
        B = x.shape[0]
        for i, p in enumerate(self._layers(params)):
            c = layer(kv, i)
            x = self._block(
                p, x, lambda pa, h: self.attn_backend.paged_prefill(
                    cfg, pa, h, c, meta, freqs, q_block=cfg.attn_q_block)[0],
                self._seq_moe)
        x = apply_norm(cfg, params["final_norm"], x)
        last = x[torch.arange(B, device=x.device), meta["n_live"].long() - 1]
        return lm_logits(cfg, params["embed"], last), kv, state

    def verify_paged(self, params, kv, state, meta, tokens):
        """Small-q speculative verify step: ``decode_paged`` over
        ``Q = 1 + speculate_tokens`` candidate tokens per slot.

        tokens: [B, Q] int — per slot the last emitted token followed by
        its draft, zero-padded to Q; meta: flat metadata from
        ``attn_backend.verify_meta`` on the model's device (per-row base
        positions and live query counts).  Every per-token op (embed, norms,
        projections, MLP, logits) runs on query token j's [B, d] slice, the
        decode step's computation at its shape (a GEMM may round a row
        otherwise at another M), and the attention is one verify call over
        all Q tokens whose row j equals the decode attend's at ``pos + j``;
        so row ``j`` of the logits equals the decode step's logits at
        position ``pos + j`` bit for bit.  MoE layers keep the JAX
        package's verify rule that no token is ever dropped (``cap = Q``
        there): token j's B rows route as the decode step's group at full
        capacity (``cap = B``), which is the decode step's computation
        whenever the decode step drops nothing (B <= 8 slots), so verify
        row j still equals the decode step at ``pos + j``.  MLA layers run
        ``mla.mla_paged_verify_block`` by the same rule (one latent verify
        attend, kernel K7 on the card).  Returns (logits [B, Q, V], kv,
        state).  Speculation is gated to the paged families
        (``serving.speculate.speculation_k``): the state-slot families have
        no verify step."""
        cfg = self.cfg
        if self.recurrent:
            raise ValueError(f"{cfg.name}: speculative verify requires a "
                             "paged cache family")
        xs = [embed_tokens(params["embed"], tokens[:, j])
              for j in range(tokens.shape[1])]                 # Q x [B, d]
        freqs = self._freqs(xs[0].device)
        for i, p in enumerate(self._layers(params)):
            c = layer(kv, i)
            a = self.attn_backend.paged_verify(
                cfg, p["attn"], [apply_norm(cfg, p["ln1"], x) for x in xs],
                c, meta, freqs)[0]
            xs = [x + y for x, y in zip(xs, a)]
            hs = [apply_norm(cfg, p["ln2"], x) for x in xs]
            if "moe" in p:
                ys = [moe_apply(cfg, p["moe"], h[None], cap=h.shape[0])[0][0]
                      for h in hs]
            else:
                ys = [apply_mlp(cfg, p["mlp"], h) for h in hs]
            xs = [x + y for x, y in zip(xs, ys)]
        return torch.stack([self._logits(params, x) for x in xs], 1), kv, \
            state
