"""Teacher-forced replay and the dual gate: how two implementations of the
serving path are held to each other when bf16 rounding may differ.

Two backends (``hopper`` against ``reference``) or two frameworks (the port
against ``repro``) run the same model with the same parameters but round
their bf16 GEMMs and attention sums at different places, so their greedy
tokens can part at a position where the top two logits are nearly tied.
The gate is the dual gate of ``repro.serving.quant_verify``:

1. **bounded logit error** — replay one token sequence through both
   implementations (teacher-forced, so both see the same inputs at every
   position) and bound ``max |logits_a - logits_b|`` over every position;
2. **exact greedy match at high margins** — wherever the reference's
   top-1/top-2 margin exceeds twice the observed error, the tokens under
   test must equal the reference's greedy token: an error that small
   cannot flip such a position, so a mismatch there is a real fault.

``replay_logits`` is the port's replay (the counterpart of
``quant_verify.replay_logits`` with a bf16 pool); ``dual_gate`` is pure
numpy, so it also takes logits replayed by the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..configs.base import ArchConfig, ServeConfig
from ..models.attn_backend import decode_meta, meta_to_device, prefill_meta
from ..models.registry import build_model
from .kv_pool import PagedKVPool


@torch.no_grad()
def replay_logits(cfg: ArchConfig, scfg: ServeConfig, params,
                  prompt: Sequence[int], gen: Sequence[int], *,
                  attn_backend: str = "reference") -> np.ndarray:
    """Teacher-force one request through single-request paged steps on the
    params' device: prefill ``prompt`` into a fresh one-request pool, then
    decode feeding ``gen[:-1]``, collecting the logits that predicted each
    ``gen[i]``.  Returns fp32 [len(gen), vocab_padded]."""
    if not gen:
        return np.zeros((0, cfg.vocab_padded), np.float32)
    device = params["embed"]["tok"].device
    sub = dataclasses.replace(scfg, max_slots=1, num_pages=0)
    model = build_model(cfg, attn_backend)
    pool = PagedKVPool(cfg, sub, device=device)
    pages = pool.alloc(pool.pages_for(len(prompt) + len(gen)))
    assert pages is not None, "single-request replay pool sized too small"
    table = pool.new_table()
    table[:len(pages)] = pages
    tables = table[None, :]
    # pad the prefill to a page multiple like the engine's buckets; padding
    # positions are masked and logits are read at the last live token
    T = len(prompt)
    Tp = -(-T // sub.page_size) * sub.page_size
    meta = meta_to_device(prefill_meta(
        cfg, sub.page_size, tables, np.array([0], np.int32),
        np.array([0], np.int32), np.array([T], np.int32), Tp), device)
    tokens = np.zeros((1, Tp), np.int32)
    tokens[0, :T] = prompt
    logits, kv, _ = model.prefill_paged(
        params, pool.kv, {}, meta, torch.as_tensor(tokens, device=device))
    out = [logits[0].float().cpu().numpy()]
    for i, tok in enumerate(gen[:-1]):
        meta = meta_to_device(decode_meta(
            cfg, sub.page_size, tables, np.array([T + i], np.int32)), device)
        logits, kv, _ = model.decode_paged(
            params, kv, {}, meta, torch.tensor([tok], device=device))
        out.append(logits[0].float().cpu().numpy())
    return np.stack(out)


def dual_gate(ref_logits: Sequence[np.ndarray],
              test_logits: Sequence[np.ndarray],
              tokens: Sequence[Sequence[int]], *, tol: float) -> Dict:
    """Hold ``tokens`` (per request, the sequence under test) and the
    logits replayed along them by the implementation under test to the
    reference's replayed logits.  Returns a report; ``report["ok"]`` is
    gate 1 (``max_logit_err <= tol``) and gate 2 (no high-margin
    mismatch)."""
    errs = [float(np.max(np.abs(r - t))) if len(r) else 0.0
            for r, t in zip(ref_logits, test_logits)]
    max_err = max(errs, default=0.0)
    n_high = n_mismatch = n_tokens = n_exact = 0
    per_request: List[Dict] = []
    for r, toks, err in zip(ref_logits, tokens, errs):
        toks = np.asarray(toks)
        if not len(toks):
            per_request.append({"max_err": err, "high_margin": 0,
                                "mismatches": 0})
            continue
        top2 = np.sort(r, axis=-1)[:, -2:]
        high = (top2[:, 1] - top2[:, 0]) > 2.0 * max_err
        greedy = np.argmax(r, axis=-1)
        mism = int(np.sum(high & (greedy != toks)))
        n_high += int(np.sum(high))
        n_mismatch += mism
        n_tokens += len(toks)
        n_exact += int(np.sum(greedy == toks))
        per_request.append({"max_err": err, "high_margin": int(np.sum(high)),
                            "mismatches": mism})
    return {"tol": tol, "max_logit_err": max_err, "n_tokens": n_tokens,
            "greedy_equal_tokens": n_exact, "high_margin_tokens": n_high,
            "high_margin_mismatches": n_mismatch,
            "per_request": per_request,
            "ok": max_err <= tol and n_mismatch == 0}
