#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing its own lines; any failed check exits non-zero:

1. the card's name and power limit (``nvidia-smi``), and the build of every
   Hopper kernel from ``src/repro_torch/csrc`` with ``nvcc`` for sm_90a;
2. K1 (paged decode) against its plain PyTorch version at full-width
   qwen2-0.5b shapes: B=8, 2 KV heads, 7 query heads each, head dim 64,
   16-token pages, ragged positions up to 2047 over shuffled page tables;
3. K2 (ragged prefill) the same way: 256-token chunks starting at
   0, 256, ..., 1792;
4. the port's main path: full-width qwen2-0.5b (24 layers, random weights
   from ``--seed``) served by the continuous-batching engine on the
   ``hopper`` backend — 8 requests of 128 to 1024 prompt tokens sharing a
   64-token prefix, prefix cache on, 256-token prefill chunks, 32 new
   tokens each — with the kernels' launch counts read around that run
   alone; then the same requests on the ``reference`` backend, and both
   held to the dual gate along the hopper run's tokens.  A rerun of the
   hopper requests under ``torch.profiler`` prints the device's busy share
   and top kernels.

Each kernel is held to its plain version, element by element, within one
bf16 ulp of the largest magnitude in the element's row (one head of one
token, head-dim values), never below 2^-14.  Both take fp32 scores and sums
of the same bf16 operands in another order; where two such sums differ in
their last bit, a probability can round to its other bf16 neighbour, which
moves the whole row by up to an ulp of its larger terms, so an element that
cancels to near 0 cannot be held to its own ulp.  Times are CUDA-event medians with the 50 MB L2
flushed before every launch (in serving, the other 23 layers' weights and
pages pass through L2 between two calls of one layer).  ``bound_ms`` is the
larger of the bytes the function must move over 3.35 TB/s and its
operations over 989 TFLOP/s (H100 SXM bf16 dense), counted for this run's
inputs.  ``library_ms`` times ``scaled_dot_product_attention`` on the
gathered K/V as a yardstick; the port never calls it.

The line before the last is one JSON object with every kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the repository beside it, the script exits non-zero and prints
no result.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12      # H100 SXM bf16 dense, NVIDIA data sheet
L2_FLUSH_BYTES = 64 << 20      # > the H100's 50 MB L2
LOGIT_TOL = 0.25               # dual-gate bound on max |dlogit|
ULP_FLOOR = 2.0 ** -14         # least kernel-vs-plain bound (ulp at ~0.01)

# the main path's workload: 8 requests of 128..1024 prompt tokens sharing a
# 64-token prefix, 16-token pages, 256-token prefill chunks, 32 new tokens
N_REQUESTS, PREFIX, PROMPT_LO, PROMPT_HI = 8, 64, 128, 1024
PAGE, CHUNK, GEN_TOKENS = 16, 256, 32


def fail(msg: str) -> None:
    print(f"[smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


class Timer:
    """Median CUDA-event time of a callable, L2 flushed before each run."""

    def __init__(self, torch, iters: int = 20):
        self.torch = torch
        self.iters = iters
        self.flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                                 device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(self.iters):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        times = sorted(s.elapsed_time(e) for s, e in pairs)
        return times[len(times) // 2]


def bound(nbytes: float, flops: float):
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (max(t_mem, t_ops), "bytes" if t_mem >= t_ops else "operations")


def paged_pool(torch, rng, lengths, K, D, ps, width):
    """Random bf16 pages for requests of ``lengths`` tokens, each request's
    pages drawn from a shuffled pool; table entries past a request's pages
    point at the null page 0.  Returns (k_pages, v_pages, tables [B, width]
    int32)."""
    need = [-(-n // ps) for n in lengths]
    P = sum(need) + 1
    perm = rng.permutation(P - 1) + 1
    tables = torch.zeros((len(lengths), width), dtype=torch.int32)
    at = 0
    for b, n in enumerate(need):
        tables[b, :n] = torch.as_tensor(perm[at:at + n])
        at += n
    gen = torch.Generator(device="cuda").manual_seed(1)
    k = torch.randn((P, ps, K, D), generator=gen, device="cuda").bfloat16()
    v = torch.randn((P, ps, K, D), generator=gen, device="cuda").bfloat16()
    return k, v, tables.cuda()


def check_kernel(torch, name, got, want):
    """Hold ``got`` to ``want`` element by element: |got - want| within one
    bf16 ulp (8 significant bits) of the largest |want| in the element's
    row (the last axis), never below ``ULP_FLOOR``.  Returns (max
    |got - want|, worst ratio of error to bound)."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    row = w.abs().amax(-1, keepdim=True).clamp_min(1e-30)
    tol = torch.exp2(torch.floor(torch.log2(row)) - 7).clamp_min(ULP_FLOOR)
    r = diff / tol
    at = int(r.argmax().item())
    ratio, err = r.flatten()[at].item(), diff.max().item()
    ok = bool(torch.isfinite(g).all().item()) and ratio <= 1.0
    print(f"[smoke] {name}: max|kernel - plain| = {err:.6g}, worst "
          f"|kernel - plain| / (one bf16 ulp of the row's max |plain|, "
          f">= 2^-14) = {ratio:.4g} (kernel {g.flatten()[at].item():.6g}, "
          f"plain {w.flatten()[at].item():.6g}, row max "
          f"{row.expand_as(w).flatten()[at].item():.6g}) "
          f"-> {'OK' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err, ratio


def phase_decode(torch, rng, timer):
    """K1 against its plain version at full-width qwen2 decode shapes."""
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import (paged_decode,
                                                     paged_decode_plain)
    from repro_torch.models.attention import gather_pages
    B, K, G, D, ps, width = 8, 2, 7, 64, 16, 128
    H = K * G
    pos = [2047, 1500, 1023, 1024, 15, 0, 777, 1900]   # page edges, 0, last
    k, v, tables = paged_pool(torch, rng, [p + 1 for p in pos], K, D, ps,
                              width)
    gen = torch.Generator(device="cuda").manual_seed(2)
    q = torch.randn((B, H, D), generator=gen, device="cuda").bfloat16()
    pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
    scale = 1.0 / math.sqrt(D)
    got = paged_decode(q, k, v, tables, pos_t, scale=scale)
    want = paged_decode_plain(q, k, v, tables, pos_t, scale=scale)
    torch.cuda.synchronize()
    err, ratio = check_kernel(torch, "K1 paged_decode", got, want)
    ms = timer(lambda: paged_decode(q, k, v, tables, pos_t, scale=scale))
    plain_ms = timer(lambda: paged_decode_plain(q, k, v, tables, pos_t,
                                                scale=scale))
    # yardstick: one SDPA call over the gathered, head-repeated K/V
    kg = gather_pages(k, tables).transpose(1, 2).repeat_interleave(G, 1)
    vg = gather_pages(v, tables).transpose(1, 2).repeat_interleave(G, 1)
    mask = (torch.arange(width * ps, device="cuda")[None, :]
            <= pos_t[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    library_ms = timer(lambda: F.scaled_dot_product_attention(
        q4, kg, vg, attn_mask=mask, scale=scale))
    live = sum(p + 1 for p in pos)
    nbytes = live * K * D * 2 * 2 + 2 * q.numel() * 2 \
        + tables.numel() * 4 + B * 4
    bms, by = bound(nbytes, live * H * D * 4)
    print(f"[smoke] K1 paged_decode: kernel {ms:.4f} ms, plain {plain_ms:.4f}"
          f" ms, sdpa {library_ms:.4f} ms, bound {bms:.4f} ms ({by}: "
          f"{nbytes / 1e6:.2f} MB of pages, q, out, tables)", flush=True)
    return {"max_abs_err": err, "err_over_ulp": ratio, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": library_ms}


def phase_prefill(torch, rng, timer):
    """K2 against its plain version at full-width qwen2 chunk shapes."""
    import torch.nn.functional as F
    from repro_torch.kernels.ragged_prefill import (ragged_prefill,
                                                    ragged_prefill_plain)
    from repro_torch.models.attention import gather_pages
    B, K, G, D, ps, T, width = 8, 2, 7, 64, 16, 256, 128
    H = K * G
    scale = 1.0 / math.sqrt(D)
    starts = [256 * i for i in range(B)]
    k, v, tables = paged_pool(torch, rng, [s + T for s in starts], K, D, ps,
                              width)
    gen = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn((B, T, H, D), generator=gen, device="cuda").bfloat16()
    st = torch.tensor(starts, dtype=torch.int32, device="cuda")
    got = ragged_prefill(q, k, v, tables, st, scale=scale)
    want = ragged_prefill_plain(q, k, v, tables, st, scale=scale)
    torch.cuda.synchronize()
    err, ratio = check_kernel(torch, "K2 ragged_prefill", got, want)
    ms = timer(lambda: ragged_prefill(q, k, v, tables, st, scale=scale))
    plain_ms = timer(lambda: ragged_prefill_plain(q, k, v, tables, st,
                                                  scale=scale))
    kg = gather_pages(k, tables).transpose(1, 2).repeat_interleave(G, 1)
    vg = gather_pages(v, tables).transpose(1, 2).repeat_interleave(G, 1)
    qpos = st[:, None] + torch.arange(T, device="cuda")[None, :]
    mask = (torch.arange(width * ps, device="cuda")[None, None, :]
            <= qpos[:, :, None])[:, None]
    qh = q.transpose(1, 2)
    library_ms = timer(lambda: F.scaled_dot_product_attention(
        qh, kg, vg, attn_mask=mask, scale=scale))
    keys = sum(s + T for s in starts)
    pairs = sum(T * s + T * (T + 1) // 2 for s in starts)   # causal (q, k)
    nbytes = keys * K * D * 2 * 2 + 2 * q.numel() * 2 \
        + tables.numel() * 4 + B * 4
    bms, by = bound(nbytes, pairs * H * D * 4)
    print(f"[smoke] K2 ragged_prefill: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bms:.4f} ms "
          f"({by}: {pairs * H * D * 4 / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.2f} MB)", flush=True)
    return {"max_abs_err": err, "err_over_ulp": ratio, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": library_ms}


def serving_workload(rng, vocab):
    shared = rng.randint(1, vocab, size=PREFIX).tolist()
    lens = [int(x) for x in np.linspace(PROMPT_LO, PROMPT_HI, N_REQUESTS)]
    return [shared + rng.randint(1, vocab, size=n - PREFIX).tolist()
            for n in lens]


def phase_serve(torch, cfg, seed):
    """Serve ``cfg`` on the hopper backend, then on the reference backend,
    and hold them to each other.  Returns (launch counts of the hopper run,
    dual-gate report)."""
    from repro_torch.configs import ServeConfig
    from repro_torch.kernels.paged_attention import paged_decode
    from repro_torch.kernels.ragged_prefill import ragged_prefill
    from repro_torch.models.params import tree_leaves
    from repro_torch.models.registry import init_params
    from repro_torch.serving import Engine, dual_gate, replay_logits
    rng = np.random.RandomState(seed)
    prompts = serving_workload(rng, cfg.vocab)
    kw = dict(page_size=PAGE, max_slots=N_REQUESTS,
              max_len=-(-(PROMPT_HI + GEN_TOKENS) // PAGE) * PAGE,
              prefix_cache=True, prefill_chunk_tokens=CHUNK)
    scfg = ServeConfig(attn_backend="hopper", **kw)
    ref_scfg = ServeConfig(attn_backend="reference", **kw)
    device = "cuda"
    with torch.no_grad():
        t0 = time.perf_counter()
        params = init_params(cfg, seed, device)
        torch.cuda.synchronize()
        n_params = sum(leaf.numel() for _, leaf in tree_leaves(params))
        print(f"[smoke] {cfg.name}: {n_params / 1e6:.1f} M parameters drawn "
              f"on {device} in {time.perf_counter() - t0:.1f} s", flush=True)
        eng = Engine(cfg, scfg, params, seed=seed, device=device)
        paged_decode.launches = 0
        ragged_prefill.launches = 0
        results, m = eng.run_offline(prompts, GEN_TOKENS)
        torch.cuda.synchronize()
        counts = {"K1": paged_decode.launches, "K2": ragged_prefill.launches}
        tokens = [r.tokens for r in results]
        print(f"[smoke] hopper serve: {m['n_requests']} requests, "
              f"{m['new_tokens']} tokens in {m['wall_s']:.3f} s = "
              f"{m['tokens_per_s']:.1f} tok/s, decode step p50 "
              f"{m['decode_step_ms_p50']:.3f} ms over {m['decode_steps']} "
              f"steps, {m['prefill_steps']} prefill steps "
              f"({m['chunked_prefill_steps']} continuation chunks), prefix "
              f"cache hit rate {m['cache_hit_rate']:.3f}, on {m['device']}",
              flush=True)
        print(f"[smoke] launches in the hopper run: K1 {counts['K1']}, "
              f"K2 {counts['K2']} ({cfg.n_layers} layers)", flush=True)
        if any(r.failed for r in results) \
                or any(len(t) != GEN_TOKENS for t in tokens) \
                or not all(0 <= x < cfg.vocab_padded for t in tokens
                           for x in t):
            fail("hopper serve returned failed, short or out-of-range "
                 "requests")
        if counts["K1"] != m["decode_steps"] * cfg.n_layers:
            fail(f"K1 launches {counts['K1']} != decode steps "
                 f"{m['decode_steps']} x {cfg.n_layers} layers")
        if counts["K2"] != m["prefill_steps"] * cfg.n_layers:
            fail(f"K2 launches {counts['K2']} != prefill steps "
                 f"{m['prefill_steps']} x {cfg.n_layers} layers")
        profile_rerun(torch, eng, prompts)
        ref = Engine(cfg, ref_scfg, params, seed=seed, device=device)
        ref_results, rm = ref.run_offline(prompts, GEN_TOKENS)
        ref_tokens = [r.tokens for r in ref_results]
        print(f"[smoke] reference serve: {rm['tokens_per_s']:.1f} tok/s, "
              f"decode step p50 {rm['decode_step_ms_p50']:.3f} ms",
              flush=True)
        same = sum(a == b for t, u in zip(tokens, ref_tokens)
                   for a, b in zip(t, u))
        total = sum(len(t) for t in tokens)
        identical = sum(t == u for t, u in zip(tokens, ref_tokens))
        ref_logits = [replay_logits(cfg, scfg, params, p, t,
                                    attn_backend="reference")
                      for p, t in zip(prompts, tokens)]
        test_logits = [replay_logits(cfg, scfg, params, p, t,
                                     attn_backend="hopper")
                       for p, t in zip(prompts, tokens)]
        report = dual_gate(ref_logits, test_logits, tokens, tol=LOGIT_TOL)
        report.update(engine_tokens_equal=same, engine_tokens=total,
                      identical_requests=identical,
                      tokens_per_s=m["tokens_per_s"],
                      decode_step_ms_p50=m["decode_step_ms_p50"],
                      ref_tokens_per_s=rm["tokens_per_s"],
                      ref_decode_step_ms_p50=rm["decode_step_ms_p50"])
        print(f"[smoke] hopper vs reference engines: {same}/{total} "
              f"tokens equal, {identical}/{len(tokens)} requests identical",
              flush=True)
        print(f"[smoke] dual gate along the hopper tokens: max |dlogit| "
              f"{report['max_logit_err']:.5f} (tol {LOGIT_TOL}), "
              f"{report['greedy_equal_tokens']}/{report['n_tokens']} tokens "
              f"equal the reference replay's greedy token, "
              f"{report['high_margin_mismatches']} mismatches over "
              f"{report['high_margin_tokens']} high-margin tokens -> "
              f"{'OK' if report['ok'] else 'FAIL'}", flush=True)
        if not report["ok"]:
            fail("hopper serving failed the dual gate against reference")
    return counts, report


def profile_rerun(torch, eng, prompts, n_new=8):
    """Where the time goes: rerun the requests (prefixes now cached) for
    ``n_new`` tokens under ``torch.profiler`` and print the device's busy
    share of the wall time and its top kernels by self device time.  Only
    the profiler's own start may fail (tracing refused): that prints "not
    measured"; a failure of the engine run propagates."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.__enter__()
    except RuntimeError as e:
        print(f"[smoke] profile: not measured ({e})", flush=True)
        return
    try:
        t0 = time.perf_counter()
        _, m = eng.run_offline(prompts, n_new)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        prof.__exit__(None, None, None)
    rows = [(a.key, getattr(a, "self_device_time_total", 0.0), a.count)
            for a in prof.key_averages()]
    busy = sum(t for _, t, _ in rows)
    if not busy:
        print("[smoke] profile: no device time recorded (not measured)",
              flush=True)
        return
    print(f"[smoke] profile of a rerun ({m['decode_steps']} decode steps, "
          f"{m['prefill_steps']} prefill steps, {wall_us / 1e3:.1f} ms wall):"
          f" device busy {busy / 1e3:.1f} ms = {busy / wall_us:.3f} of wall",
          flush=True)
    for key, t, n in sorted(rows, key=lambda r: -r[1])[:10]:
        print(f"[smoke]   {t / 1e3:9.3f} ms {n:6d} calls  {key[:90]}",
              flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and the workload")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs an "
             "NVIDIA card")
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        fail(f"no src/repro_torch beside {os.path.basename(__file__)}: run "
             "it from a checkout of the repository")
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build_all

    # fp32 matmuls in the plain versions stay full fp32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"[smoke] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    secs, libs = build_all()
    print(f"[smoke] built {len(libs)} kernel libraries "
          f"({', '.join(sorted(libs))}) with nvcc for sm_90a in "
          f"{secs:.1f} s", flush=True)

    rng = np.random.RandomState(args.seed)
    timer = Timer(torch)
    k1 = phase_decode(torch, rng, timer)
    k2 = phase_prefill(torch, rng, timer)
    counts, report = phase_serve(torch, get_arch("qwen2-0.5b"), args.seed)
    for kid, c in counts.items():
        if c <= 0:
            fail(f"{kid} was never launched on the main path")

    kernels = [
        {"id": "K1", "name": "paged_decode", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_decode.cu",
         "replaces": "src/repro/kernels/paged_attention/kernel.py:139",
         "launches": counts["K1"], "check": "ok", **k1},
        {"id": "K2", "name": "ragged_prefill", "route": "cuda",
         "source": "src/repro_torch/csrc/ragged_prefill.cu",
         "replaces": "src/repro/kernels/ragged_prefill/kernel.py:141",
         "launches": counts["K2"], "check": "ok", **k2},
    ]
    print(json.dumps({"kernels": kernels, "serve": {
        k: report[k] for k in ("max_logit_err", "n_tokens",
                               "greedy_equal_tokens", "high_margin_tokens",
                               "high_margin_mismatches",
                               "engine_tokens_equal", "engine_tokens",
                               "identical_requests", "tokens_per_s",
                               "decode_step_ms_p50", "ref_tokens_per_s",
                               "ref_decode_step_ms_p50")}}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
