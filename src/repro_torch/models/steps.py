"""Serve step factories: plain functions over (params, caches, inputs).

The JAX package jits these; here they run eagerly and write the paged pool
in place, returning it so call sites read as they do in ``repro``.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from .registry import build_model


def make_serve_step(cfg: ArchConfig, kind: str,
                    attn_backend: str = "reference"):
    """kind='decode': step(params, cache, tokens) -> (next_tokens, cache)
       kind='prefill': step(params, batch) -> (logits, cache)
       kind='prefill_at': step(params, batch, last_idx) -> (logits, cache)
         (logits read at per-row position ``last_idx`` — bucketed prompts)
       kind='decode_paged': step(params, kv, state, meta, tokens)
         -> (next_tokens, ok, kv, state) — slot-indexed continuous-batching
         decode against the paged pool.  ``meta`` is the flat per-step
         metadata from ``attn_backend.decode_meta``.  ``ok`` is a per-row
         bool: True iff every logit in that row is finite — the engine's
         NaN/inf quarantine guard.
       kind='prefill_paged': step(params, kv, state, meta, tokens, extras)
         -> (logits, kv, state) — batched chunk prefill straight into the
         pool; ``meta`` from ``attn_backend.prefill_meta``.

       ``attn_backend`` selects the backend the paged kinds route through
       (``reference`` gather+attend | ``hopper`` kernels)."""
    model = build_model(cfg, attn_backend)
    if kind == "decode":
        def step(params, cache, tokens):
            logits, cache = model.decode(params, cache, tokens)
            return logits.argmax(-1).to(torch.int32), cache
        return step
    if kind == "decode_paged":
        def step(params, kv, state, meta, tokens):
            logits, kv, state = model.decode_paged(params, kv, state, meta,
                                                   tokens)
            nxt = logits.argmax(-1).to(torch.int32)
            ok = torch.isfinite(logits).all(-1)
            return nxt, ok, kv, state
        return step
    if kind == "prefill_paged":
        def step(params, kv, state, meta, tokens, extras):
            return model.prefill_paged(params, kv, state, meta, tokens,
                                       extras)
        return step
    if kind == "prefill_at":
        def step(params, batch, last_idx):
            return model.prefill(params, batch, logits_idx=last_idx)
        return step
    if kind != "prefill":
        raise ValueError(f"unknown serve step kind {kind!r}")

    def step(params, batch):
        return model.prefill(params, batch)
    return step
