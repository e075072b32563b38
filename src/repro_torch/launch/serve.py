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

The flags are those of ``repro.launch.serve`` for what the port supports,
plus ``--device`` (``cuda`` by default: without a card the run raises
instead of moving to the CPU).  ``--attn-backend`` takes
``auto|reference|hopper``; ``auto`` is ``hopper`` on ``cuda``.  Weights are
random, drawn from ``--seed`` on the chosen device.  ``--verify`` replays
every request through the static single-request baseline and checks the
greedy tokens agree per request.
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
from ..serving import Engine, Tracer, generate_static


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
                         "pages its cache)")
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
    ap.add_argument("--prefill-chunk-tokens", type=int, default=0,
                    help="per-step prefill token budget: long prompts split "
                         "into page-aligned chunks that interleave with "
                         "decode steps (0 = one monolithic prefill per "
                         "admission)")
    ap.add_argument("--max-len", type=int, default=0,
                    help="per-request length cap (0 -> fitted to workload)")
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
                       prefill_chunk_tokens=args.prefill_chunk_tokens)
    prompts, budgets = make_prompts(args, cfg.vocab)
    engine = "continuous" if args.engine == "auto" else args.engine
    if engine == "static" and (args.prefix_cache or args.trace
                               or args.attn_backend != "auto"):
        print("[serve] WARNING: --prefix-cache/--trace/--attn-backend only "
              "apply to the continuous engine")

    eng = None
    with torch.no_grad():
        if engine == "continuous":
            eng = Engine(cfg, scfg, seed=args.seed, device=device,
                         tracer=Tracer(
                             profiler_annotations=args.profiler_annotations))
            params = eng.params
            results, metrics = eng.run_offline(prompts, budgets)
            tokens = [r.tokens for r in results]
            print(f"[serve] device {metrics['device']}, attention backend "
                  f"{metrics['attn_backend']} (decode step p50 "
                  f"{metrics['decode_step_ms_p50']:.1f} ms)")
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
                                              scfg, batch_size=slots)
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

        if args.verify:
            ref, _ = generate_static(cfg, params, prompts, budgets, scfg,
                                     batch_size=1)
            bad = [i for i, (a, b) in enumerate(zip(tokens, ref)) if a != b]
            if bad:
                raise SystemExit(f"[serve] VERIFY FAILED for requests {bad}")
            print(f"[serve] verify OK: {len(tokens)} requests match the "
                  f"single-request static baseline exactly")
    return tokens


if __name__ == "__main__":
    main()
