"""Serving CLI of the port — a thin front-end over ``repro_torch.serving``.

  # continuous batching on the card through the Hopper kernels
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --reduced --engine continuous --requests 16 --mixed --gen 16

  # the same on the CPU (plain reference attention), checked against the
  # static single-request baseline with prefix cache and chunked prefill on
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch qwen2-0.5b --reduced --engine continuous --requests 8 --mixed \\
      --prompt-len 64 --prefix-cache --shared-prefix 2 \\
      --prefill-chunk-tokens 32 --verify

  # speculative decoding (n-gram drafts, small-q verify) and int8 pages
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced \
      --speculate-tokens 4 --prefix-cache --prefill-chunk-tokens 32 --verify
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced \
      --kv-dtype int8 --verify

  # sliding-window families over page rings (starcoder2-7b,
  # command-r-plus-104b; the prefix cache is refused for rings)
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced \
      --arch starcoder2-7b --speculate-tokens 4 --verify

  # MLA + MoE (deepseek-v2-236b: latent pages, bf16 or int8, speculation
  # through the latent verify), and MoE on GQA pages (dbrx-132b)
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced \
      --arch deepseek-v2-236b --prefix-cache --prefill-chunk-tokens 32 \
      --verify
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced \
      --arch deepseek-v2-236b --kv-dtype int8 --verify
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced \
      --arch deepseek-v2-236b --speculate-tokens 4 --verify

  # the state-slot families: mamba2 (SSD) and recurrentgemma (RG-LRU +
  # a local-attention ring), one checkpointable state slot a request
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced \
      --arch mamba2-780m --verify
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced \
      --arch recurrentgemma-2b --requests 6 --mixed --prompt-len 48 --verify

  # the frontend-conditioned families: seamless-m4t (enc-dec: frames
  # encoded once a request, cross K/V pinned in a state slot, continuation
  # chunks without the encoder; serves non-speculatively) and llava (an
  # image prefix before the text; never chunked, no prefix cache)
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced \
      --arch seamless-m4t-large-v2 --prefill-chunk-tokens 16 --verify
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced \
      --arch llava-next-34b --speculate-tokens 4 --verify

  # the overlapped pipeline (step N+1's plan staged while step N runs) and
  # chaos mode: a deterministic fault plan (``serving.faults``) checked
  # against the exact-survivor contract
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced \
      --overlap --inject "nan_logits:rid=1,at=2" --verify

The flags are those of ``repro.launch.serve`` for what the port supports,
plus ``--device`` (``cuda`` by default: without a card the run raises
instead of moving to the CPU).  ``--attn-backend`` takes
``auto|reference|hopper``; ``auto`` is ``hopper`` on ``cuda``.  Weights are
random, drawn from ``--seed`` on the chosen device, and so are the
enc-dec frames and vlm image embeddings (``_synthetic_frontend``, by
``--seed`` and request index).  ``--verify`` replays
every request through the static single-request baseline and checks the
greedy tokens agree per request (speculation included: accepted drafts
leave the greedy stream unchanged); with ``--kv-dtype int8`` it runs the
dual gate of ``serving.parity.dual_gate_verify`` instead, since quantized
pages are not token-exact against bf16.

``--overlap`` drives ``Engine.pump()`` instead of ``step()`` (the same
tokens).  ``--inject SPEC`` runs the workload under a fault plan; with
``--verify`` it checks the exact-survivor contract: every planned fault
fired, each targeted request ended with its fault's error and a prefix of
its clean tokens, every other request's tokens equal the clean ones, and
the page pool balances after the drain.  The clean tokens are the static
single-request baseline's on the bf16 ``reference`` path (as in the JAX
CLI), and elsewhere a fault-free engine run with the same settings: the
hopper kernels and int8 pages are exact only against themselves.  A plan
with ``pool_pressure`` preempts and replays requests in other prefill
batches, whose dense products may round differently off the reference
path; there the survivors are held to the reference replay by the dual
gate instead.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from .. import resolve_device
from ..configs import ServeConfig, get_arch, reduced as make_reduced
from ..models.registry import init_params
from ..serving import (Engine, FaultPlan, Tracer, dual_gate,
                       dual_gate_verify, format_report, generate_static,
                       logit_tol, replay_logits)
from ..serving.engine import _synthetic_frontend


def make_prompts(args, vocab: int):
    """Deterministic synthetic prompts; ``--mixed`` varies length + budget,
    ``--shared-prefix F`` draws each prompt as one of F family prefixes plus
    a unique suffix (the workload a prefix cache pays off on)."""
    rng = np.random.RandomState(args.seed)
    fams = [rng.randint(1, vocab, size=max(args.prompt_len // 2, 1)).tolist()
            for _ in range(args.shared_prefix)] if args.shared_prefix else []
    prompts, budgets = [], []
    for i in range(args.requests):
        if args.mixed:
            n = int(rng.randint(args.min_prompt_len, args.prompt_len + 1))
            g = int(rng.randint(max(1, args.gen // 4), args.gen + 1))
        else:
            n, g = args.prompt_len, args.gen
        if fams:
            fam = fams[i % len(fams)]
            tail = max(n - len(fam), 1)
            prompts.append(fam + rng.randint(1, vocab, size=tail).tolist())
        else:
            prompts.append(rng.randint(1, vocab, size=n).tolist())
        budgets.append(g)
    return prompts, budgets


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model runs; cuda without a card raises")
    ap.add_argument("--engine", choices=("auto", "static", "continuous"),
                    default="auto",
                    help="auto: continuous (every family the port builds "
                         "pages its cache or holds it in state slots)")
    ap.add_argument("--requests", type=int, default=8,
                    help="number of requests (static: also the batch size)")
    ap.add_argument("--batch", type=int, default=0,
                    help="static batch size / continuous max_slots "
                         "(0 -> min(requests, 8))")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--min-prompt-len", type=int, default=4)
    ap.add_argument("--mixed", action="store_true",
                    help="mixed prompt lengths and token budgets")
    ap.add_argument("--shared-prefix", type=int, default=0, metavar="F",
                    help="draw prompts from F shared prefix families "
                         "(0: every prompt independent)")
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix-tree prefix cache: share KV pages across "
                         "requests with common prompt prefixes")
    ap.add_argument("--cache-eviction", choices=("lru", "none"),
                    default="lru")
    ap.add_argument("--attn-backend", choices=("auto", "reference", "hopper"),
                    default="auto",
                    help="paged-attention backend for the continuous engine: "
                         "reference = plain torch gather+attend, hopper = "
                         "the hand-written CUDA kernels; auto picks hopper "
                         "on cuda")
    ap.add_argument("--kv-dtype", choices=("bf16", "int8"), default="bf16",
                    help="paged-KV storage dtype: int8 stores absmax-"
                         "quantized pages + per-token scale pages and "
                         "dequantizes inside the attend; --verify then "
                         "checks the bounded-error + high-margin dual gate "
                         "instead of exact token match")
    ap.add_argument("--speculate-tokens", type=int, default=0, metavar="K",
                    help="speculative decoding: draft up to K tokens per "
                         "slot from the request's own history (n-gram "
                         "prompt lookup) and verify them in one small-q "
                         "step; greedy accept keeps tokens identical to "
                         "non-speculative decode (0 = off)")
    ap.add_argument("--prefill-chunk-tokens", type=int, default=0,
                    help="per-step prefill token budget: long prompts split "
                         "into page-aligned chunks that interleave with "
                         "decode steps (0 = one monolithic prefill per "
                         "admission)")
    ap.add_argument("--max-len", type=int, default=0,
                    help="per-request length cap (0 -> fitted to workload)")
    ap.add_argument("--overlap", action="store_true",
                    help="drive the overlapped host/device pipeline "
                         "(Engine.pump(): step N+1's plan staged while step "
                         "N runs on the device) instead of the synchronous "
                         "step loop; tokens are identical either way")
    ap.add_argument("--inject", metavar="SPEC", default="",
                    help="deterministic fault plan, e.g. "
                         "'nan_logits:rid=2,at=3;step_error:rid=0,at=2'; "
                         "kinds: nan_logits, step_error, pool_pressure, "
                         "client_disconnect, detok_stall (continuous engine "
                         "only; with --verify the exact-survivor check)")
    ap.add_argument("--verify", action="store_true",
                    help="check tokens against the static single-request path")
    ap.add_argument("--trace", metavar="PATH", default="",
                    help="write the request-lifecycle trace as Chrome-trace-"
                         "event JSON (open in Perfetto / chrome://tracing)")
    ap.add_argument("--metrics-json", metavar="PATH", default="",
                    help="write the run metrics + full metrics-registry "
                         "snapshot as JSON")
    ap.add_argument("--profiler-annotations", action="store_true",
                    help="wrap model steps in torch.profiler.record_function "
                         "ranges (visible when a torch profiler trace is "
                         "also being captured)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"[serve] {e}")
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    cfg = dataclasses.replace(cfg, remat="none")

    slots = args.batch or min(args.requests, 8)
    ps = args.page_size
    max_len = args.max_len or ((args.prompt_len + args.gen + ps - 1) // ps) * ps
    scfg = ServeConfig(page_size=ps, max_slots=slots, max_len=max_len,
                       prefix_cache=args.prefix_cache,
                       cache_eviction=args.cache_eviction,
                       attn_backend=args.attn_backend,
                       prefill_chunk_tokens=args.prefill_chunk_tokens,
                       kv_dtype=args.kv_dtype,
                       speculate_tokens=args.speculate_tokens)
    prompts, budgets = make_prompts(args, cfg.vocab)
    engine = "continuous" if args.engine == "auto" else args.engine
    if engine == "static" and (args.prefix_cache or args.trace
                               or args.attn_backend != "auto"
                               or args.kv_dtype != "bf16"
                               or args.speculate_tokens):
        print("[serve] WARNING: --prefix-cache/--trace/--attn-backend/"
              "--kv-dtype/--speculate-tokens only apply to the continuous "
              "engine; the static path decodes one token a step over bf16 "
              "contiguous caches")

    plan = None
    if args.inject:
        if engine != "continuous":
            raise SystemExit("[serve] --inject requires the continuous "
                             "engine (faults target its seams)")
        plan = FaultPlan.parse(args.inject, seed=args.seed)
    eng = None
    with torch.no_grad():
        if engine == "continuous":
            eng = Engine(cfg, scfg, seed=args.seed, device=device,
                         tracer=Tracer(
                             profiler_annotations=args.profiler_annotations),
                         faults=plan)
            params = eng.params
            results, metrics = eng.run_offline(prompts, budgets,
                                               overlap=args.overlap)
            tokens = [r.tokens for r in results]
            cache = " + ".join(
                ([f"{args.kv_dtype} pages ({eng.pool.kv_bytes_per_token:.0f}"
                  " B per token)"] if eng.pool.spec.paged else [])
                + ([f"state slots ({eng.states.slot_nbytes} B a slot)"]
                   if eng.states is not None else []))
            print(f"[serve] device {metrics['device']}, attention backend "
                  f"{metrics['attn_backend']}, {cache}, decode step p50 "
                  f"{metrics['decode_step_ms_p50']:.1f} ms")
            if args.speculate_tokens and not eng.spec_k:
                print(f"[serve] WARNING: speculation disabled for "
                      f"{cfg.name}: cache family {eng.spec.describe()} has "
                      f"no paged small-q verify step; serving "
                      f"non-speculatively")
            if args.overlap:
                print(f"[serve] overlap: "
                      f"{eng.metrics.value('engine.overlap_staged')} plans "
                      f"staged, {eng.metrics.value('engine.overlap_used')} "
                      f"used, {eng.metrics.value('engine.overlap_dropped')} "
                      f"dropped")
            if eng.spec_k:
                print(f"[serve] speculation: K={eng.spec_k}, "
                      f"{metrics['spec_proposed']} drafted, "
                      f"{metrics['spec_accepted']} accepted (accept rate "
                      f"{metrics['spec_accept_rate']:.2f})")
            if args.prefill_chunk_tokens:
                print(f"[serve] chunked prefill: budget {scfg.chunk_tokens} "
                      f"tokens, {metrics['chunked_prefill_steps']} "
                      f"continuation chunks, padding waste "
                      f"{metrics['prefill_padding_waste']:.2f}")
            print(f"[serve] {cfg.name} continuous: {metrics['n_requests']} "
                  f"reqs, {metrics['new_tokens']} toks in "
                  f"{metrics['wall_s']*1e3:.1f} ms "
                  f"({metrics['tokens_per_s']:.1f} tok/s); latency p50 "
                  f"{metrics['latency_p50_s']*1e3:.1f} ms")
            if args.prefix_cache:
                print(f"[serve] prefix cache: {metrics['cached_tokens']}/"
                      f"{metrics['prompt_tokens']} prompt tokens served from "
                      f"cache (hit rate {metrics['cache_hit_rate']:.2f})")
        else:
            params = init_params(cfg, args.seed, device)
            tokens, metrics = generate_static(cfg, params, prompts, budgets,
                                              scfg, batch_size=slots,
                                              seed=args.seed)
            print(f"[serve] {cfg.name} static(batch={slots}): "
                  f"{metrics['n_requests']} reqs, {metrics['new_tokens']} "
                  f"toks in {metrics['wall_s']*1e3:.1f} ms "
                  f"({metrics['tokens_per_s']:.1f} tok/s)")
        print("[serve] sample generations:", [t[:8] for t in tokens[:2]])

        if args.trace and eng is not None:
            eng.tracer.save(args.trace)
            print(f"[serve] trace: {len(eng.tracer.events)} events -> "
                  f"{args.trace}")
        if args.metrics_json:
            out = {"arch": cfg.name, "engine": engine, "metrics": metrics}
            if eng is not None:
                out["registry"] = eng.metrics_snapshot()
            with open(args.metrics_json, "w") as f:
                json.dump(out, f, indent=2, sort_keys=True)
            print(f"[serve] metrics -> {args.metrics_json}")

        if plan is not None:
            fired = [f.describe() for f in plan.faults if f.fired]
            print(f"[serve] chaos: {len(fired)}/{len(plan.faults)} planned "
                  f"faults fired; quarantined="
                  f"{eng.metrics.value('engine.quarantined')} cancelled="
                  f"{eng.metrics.value('engine.cancelled')} pages_scrubbed="
                  f"{eng.metrics.value('pool.pages_scrubbed')}")
        if args.verify and plan is not None:
            chaos_verify(cfg, scfg, params, prompts, budgets, results, plan,
                         eng, overlap=args.overlap, seed=args.seed)
        elif args.verify and args.kv_dtype == "int8" \
                and engine == "continuous":
            # quantized pages are not token-exact against the bf16 static
            # baseline; the contract is the bounded-error + high-margin gate
            # the frontend inputs the engine drew for each request id
            report = dual_gate_verify(
                cfg, scfg, params, prompts, tokens,
                attn_backend=eng.attn_backend,
                frontends=[_synthetic_frontend(cfg, scfg, args.seed, i)
                           for i in range(len(prompts))])
            print(format_report(report))
            if not report["ok"]:
                raise SystemExit(
                    "[serve] QUANT VERIFY FAILED: max logit err "
                    f"{report['max_logit_err']:.4f} (tol "
                    f"{report['tol']:.4f}), "
                    f"{report['high_margin_mismatches']} high-margin "
                    f"mismatches, {report['replay_failures']} replay "
                    "failures")
            print(f"[serve] verify OK: dual gate passed for {len(tokens)} "
                  "requests")
        elif args.verify:
            ref, _ = generate_static(cfg, params, prompts, budgets, scfg,
                                     batch_size=1, seed=args.seed)
            bad = [i for i, (a, b) in enumerate(zip(tokens, ref)) if a != b]
            if bad:
                raise SystemExit(f"[serve] VERIFY FAILED for requests {bad}")
            print(f"[serve] verify OK: {len(tokens)} requests match the "
                  f"single-request static baseline exactly")
    return tokens


def chaos_verify(cfg, scfg, params, prompts, budgets, results, plan, eng, *,
                 overlap=False, seed=0):
    """The exact-survivor contract of a ``--inject`` run (see the module
    docstring); raises ``SystemExit`` listing every violation."""
    expected = {}      # rid -> substring expected in the terminal error
    for f in plan.faults:
        if f.kind in ("nan_logits", "step_error") and f.rid >= 0:
            expected[f.rid] = f.kind
        elif f.kind == "client_disconnect" and f.rid >= 0:
            expected[f.rid] = "cancelled"
    exact = eng.attn_backend == "reference" and scfg.kv_dtype == "bf16"
    if exact:
        ref, _ = generate_static(cfg, params, prompts, budgets, scfg,
                                 batch_size=1, seed=seed)
        against = "the fault-free static baseline"
    else:
        clean = Engine(cfg, scfg, params, seed=seed, device=eng.device)
        ref = [r.tokens for r in clean.run_offline(prompts, budgets,
                                                   overlap=overlap)[0]]
        against = "a fault-free engine run"
    rebatched = not exact and any(f.kind == "pool_pressure"
                                  for f in plan.faults)
    bad = [f"planned fault never fired: {why}" for why in plan.unfired()]
    for i, res in enumerate(results):
        if i in expected:
            if not res.failed or expected[i] not in (res.error or ""):
                bad.append(f"request {i}: expected terminal "
                           f"{expected[i]!r}, got error={res.error!r}")
            elif not rebatched and res.tokens != ref[i][:len(res.tokens)]:
                bad.append(f"request {i}: partial tokens are not a prefix "
                           f"of the clean run")
        elif res.failed:
            bad.append(f"request {i}: survivor failed: {res.error!r}")
        elif not rebatched and res.tokens != ref[i]:
            bad.append(f"request {i}: survivor tokens diverge from "
                       f"{against}")
    if rebatched:
        # preemption replays re-batch prefills: hold every survivor to the
        # reference replay along its own tokens instead
        keep = [i for i, r in enumerate(results) if not r.failed]
        toks = [results[i].tokens for i in keep]
        fronts = [_synthetic_frontend(cfg, scfg, seed, i) for i in keep]
        rep = dual_gate(
            [replay_logits(cfg, scfg, params, prompts[i], t, frontend=f)
             for i, t, f in zip(keep, toks, fronts)],
            [replay_logits(cfg, scfg, params, prompts[i], t,
                           attn_backend=eng.attn_backend, frontend=f)
             for i, t, f in zip(keep, toks, fronts)], toks,
            tol=logit_tol(cfg))
        same = sum(a == b for i, t in zip(keep, toks)
                   for a, b in zip(t, ref[i]))
        print(f"[serve] pool pressure: {same}/{sum(map(len, toks))} "
              f"survivor tokens equal {against}; dual gate max |dlogit| "
              f"{rep['max_logit_err']:.4f}, {rep['high_margin_mismatches']} "
              f"high-margin mismatches")
        if not rep["ok"]:
            bad.append("survivors fail the dual gate against the reference "
                       "replay")
    if not eng.pool.conservation_ok():
        bad.append("page-pool conservation violated after drain")
    if bad:
        for why in bad:
            print(f"[serve] CHAOS VERIFY FAILED: {why}")
        raise SystemExit(f"[serve] CHAOS VERIFY FAILED ({len(bad)} "
                         f"violations)")
    print(f"[serve] chaos verify OK: {len(results) - len(expected)} "
          f"survivors {'held to' if rebatched else 'identical to'} "
          f"{against}, {len(expected)} targeted requests quarantined with "
          f"clean terminals, pool conserved")


if __name__ == "__main__":
    main()
