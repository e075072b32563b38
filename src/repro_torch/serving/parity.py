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

The same gate is the int8 pool's contract (``dual_gate_verify``, the
port of ``quant_verify.dual_gate_verify``): quantized pages are not
token-exact against bf16, so an int8 run's tokens are held to a bf16
replay of the same tokens, with ``logit_tol`` as the bound, plus replay
fidelity (the int8 replay's greedy tokens are the engine's own).

``replay_logits`` is the port's replay (the counterpart of
``quant_verify.replay_logits``, bf16 or int8 pool); ``dual_gate`` is pure
numpy, so it also takes logits replayed by the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..configs.base import ArchConfig, ServeConfig
from ..models.attn_backend import decode_meta, meta_to_device, prefill_meta
from ..models.registry import build_model
from .engine import _frontend_batch
from .kv_pool import PagedKVPool, StateSlotPool

# per-arch max-abs-logit-error bounds of the int8 gate (the JAX package's
# ``quant_verify.LOGIT_TOL``); MLA's wider bound arrives with its family
LOGIT_TOL: Dict[str, float] = {
    "deepseek-v2-236b": 0.5,
}
DEFAULT_LOGIT_TOL = 0.25


def logit_tol(cfg: ArchConfig) -> float:
    return LOGIT_TOL.get(cfg.name, DEFAULT_LOGIT_TOL)


@torch.no_grad()
def replay_logits(cfg: ArchConfig, scfg: ServeConfig, params,
                  prompt: Sequence[int], gen: Sequence[int], *,
                  attn_backend: str = "reference",
                  kv_dtype: Optional[str] = None,
                  frontend: Optional[np.ndarray] = None) -> np.ndarray:
    """Teacher-force one request through single-request paged steps on the
    params' device: prefill ``prompt`` into a fresh one-request pool of
    ``kv_dtype`` pages (``scfg.kv_dtype`` by default; for the state-slot
    families, and for enc-dec's pinned cross K/V, a one-slot
    ``StateSlotPool``), then decode feeding ``gen[:-1]``, collecting the
    logits that predicted each ``gen[i]``.  ``frontend`` is the request's
    frontend input for enc-dec and vlm archs (what the engine drew for it,
    ``engine._synthetic_frontend``).  Returns fp32 [len(gen),
    vocab_padded]."""
    if not gen:
        return np.zeros((0, cfg.vocab_padded), np.float32)
    device = params["embed"]["tok"].device
    extras = {}
    if cfg.enc_dec or cfg.n_image_tokens:
        if frontend is None:
            raise ValueError(f"{cfg.name}: a replay needs the request's "
                             "frontend input")
        extras = _frontend_batch(cfg, [frontend], 1, device)
    sub = dataclasses.replace(scfg, max_slots=1, num_pages=0,
                              kv_dtype=kv_dtype or scfg.kv_dtype)
    model = build_model(cfg, attn_backend)
    pool = PagedKVPool(cfg, sub, device=device)
    state = StateSlotPool(cfg, sub, device=device).state \
        if pool.spec.state_slots else {}
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
        params, pool.kv, state, meta, torch.as_tensor(tokens, device=device),
        extras)
    out = [logits[0].float().cpu().numpy()]
    T0 = T + pool.spec.prefix_tokens      # a vlm's text follows its image
    for i, tok in enumerate(gen[:-1]):
        meta = meta_to_device(decode_meta(
            cfg, sub.page_size, tables, np.array([T0 + i], np.int32)), device)
        logits, kv, _ = model.decode_paged(
            params, kv, state, meta, torch.tensor([tok], device=device))
        out.append(logits[0].float().cpu().numpy())
    return np.stack(out)


def row_ulps(ref: np.ndarray, test: np.ndarray) -> float:
    """The largest |test - ref| of each token's logits in bf16 ulps of that
    row's largest |ref| (2^-7 of its power of two, never below 2^-14),
    the rule the kernel checks use; the max over the rows."""
    if not len(ref):
        return 0.0
    top = np.maximum(np.max(np.abs(ref), axis=-1), 2.0 ** -7)
    ulp = np.exp2(np.floor(np.log2(top)) - 7)
    return float(np.max(np.max(np.abs(test - ref), axis=-1) / ulp))


def dual_gate(ref_logits: Sequence[np.ndarray],
              test_logits: Sequence[np.ndarray],
              tokens: Sequence[Sequence[int]], *, tol: float,
              tol_row_ulps: Optional[float] = None) -> Dict:
    """Hold ``tokens`` (per request, the sequence under test) and the
    logits replayed along them by the implementation under test to the
    reference's replayed logits.  Returns a report; ``report["ok"]`` is
    gate 1 (``max_logit_err <= tol``, or with ``tol_row_ulps``
    ``max_logit_err_row_ulps <= tol_row_ulps``: a bound that scales with
    the logits' magnitude) and gate 2 (no high-margin mismatch)."""
    errs = [float(np.max(np.abs(r - t))) if len(r) else 0.0
            for r, t in zip(ref_logits, test_logits)]
    max_err = max(errs, default=0.0)
    max_ulps = max((row_ulps(r, t) for r, t in zip(ref_logits, test_logits)),
                   default=0.0)
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
    bounded = max_err <= tol if tol_row_ulps is None \
        else max_ulps <= tol_row_ulps
    return {"tol": tol, "tol_row_ulps": tol_row_ulps,
            "max_logit_err": max_err, "max_logit_err_row_ulps": max_ulps,
            "n_tokens": n_tokens, "greedy_equal_tokens": n_exact,
            "high_margin_tokens": n_high,
            "high_margin_mismatches": n_mismatch,
            "per_request": per_request,
            "ok": bounded and n_mismatch == 0}


def dual_gate_verify(cfg: ArchConfig, scfg: ServeConfig, params,
                     prompts: Sequence[Sequence[int]],
                     engine_tokens: Sequence[Sequence[int]], *,
                     attn_backend: str = "reference",
                     tol: Optional[float] = None,
                     frontends: Optional[Sequence[np.ndarray]] = None) -> Dict:
    """The int8 gate over every request of an int8 engine run: replay the
    engine's tokens through an int8 and a bf16 pool (same params, same
    backend) and hold them to each other.  ``report["ok"]`` is replay
    fidelity (the int8 replay's greedy tokens are the engine's), bounded
    error (``max |int8 - bf16| <= tol``, ``logit_tol`` by default) and no
    mismatch against the bf16 greedy token where its margin exceeds twice
    that error.  ``frontends`` are the requests' frontend inputs (enc-dec
    and vlm archs)."""
    tol = logit_tol(cfg) if tol is None else tol
    fronts = list(frontends) if frontends is not None \
        else [None] * len(prompts)
    li, lb = ([replay_logits(cfg, scfg, params, p, g,
                             attn_backend=attn_backend, kv_dtype=dt,
                             frontend=f)
               for p, g, f in zip(prompts, engine_tokens, fronts)]
              for dt in ("int8", "bf16"))
    report = dual_gate(lb, li, engine_tokens, tol=tol)
    replay_bad = sum(bool(len(g)) and not np.array_equal(
        np.argmax(x, axis=-1), np.asarray(g))
        for x, g in zip(li, engine_tokens))
    report.update(arch=cfg.name, attn_backend=attn_backend,
                  n_requests=len(li), replay_failures=replay_bad,
                  ok=report["ok"] and replay_bad == 0)
    return report


def format_report(report: Dict) -> str:
    """One human-readable line per gate, for ``serve --verify`` output."""
    err_ok = report["max_logit_err"] <= report["tol"]
    return "\n".join([
        f"[quant-verify] {report['arch']} backend={report['attn_backend']}: "
        f"{report['n_requests']} requests, {report['n_tokens']} tokens",
        f"[quant-verify] gate 1 (bounded error): max |dlogit| = "
        f"{report['max_logit_err']:.4f} vs tol {report['tol']:.4f} -> "
        f"{'OK' if err_ok else 'FAIL'}",
        f"[quant-verify] gate 2 (high-margin greedy): "
        f"{report['high_margin_mismatches']} mismatches over "
        f"{report['high_margin_tokens']} tokens with margin > 2x err -> "
        f"{'OK' if report['high_margin_mismatches'] == 0 else 'FAIL'}",
        f"[quant-verify] replay fidelity: "
        f"{report['replay_failures']} requests diverged from the engine -> "
        f"{'OK' if report['replay_failures'] == 0 else 'FAIL'}",
    ])
