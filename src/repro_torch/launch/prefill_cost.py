"""Time K2 (the ragged paged prefill), K4 (the sliding-window chunk
prefill), K6 (the MLA chunk prefill) and the serving runs they carry, for
one tree on the card, to compare two trees in one call.

    PYTHONPATH=src python3 src/repro_torch/launch/prefill_cost.py --part kernels
    PYTHONPATH=<other tree>/src python3 src/repro_torch/launch/prefill_cost.py --part serve
    PYTHONPATH=src python3 src/repro_torch/launch/prefill_cost.py --part window-kernels
    PYTHONPATH=src python3 src/repro_torch/launch/prefill_cost.py --part window-serve
    PYTHONPATH=src python3 src/repro_torch/launch/prefill_cost.py --part mla-kernels
    PYTHONPATH=src python3 src/repro_torch/launch/prefill_cost.py --part mla-serve

It imports ``repro_torch`` by absolute name before anything else, so it
measures whichever tree is first on the path (its kernels built from that
tree's sources into that tree's ``build/``); the phase functions, the
workload and the timer come from this checkout's ``chip_smoke.py``.

``--part kernels``: ``chip_smoke.phase_prefill`` for K2 and K2-int8
(qwen2-0.5b's 2 / 7 heads of 64) and K2-D128 and K2-D128-int8
(minitron-4b's 8 / 3 heads of 128), each on 8 chunks of 256 tokens at
starts 0, 256, ..., 1792: kernel, plain and SDPA times, the bound and the
worst error in row ulps; and the registers and spills ``ptxas`` reported
for the tree's ``ragged_prefill`` library.

``--part serve``: qwen2-0.5b (bf16, n-gram speculation with K = 4, int8
pages) and minitron-4b (bf16, int8 pages), each served on the ``hopper``
backend with the smoke's workload (8 requests of 128..1024 prompt tokens
sharing a 64-token prefix, 256-token chunks, 32 new tokens) by a fresh
engine: tok/s, TTFT p50 and p95, prefill steps and K2 launches; then the
same requests by another fresh engine under ``torch.profiler``, tracing
the device alone: the device's busy share of the wall time and K2's share
of the device time.

``--part window-kernels``: ``chip_smoke.phase_windowed_prefill`` for K4
and K4-int8 at starcoder2-7b's shape (B 4 chunks of 256 at starts 0,
3840, 4352 and 5888, 36 / 4 heads of 128, 257-page rings): kernel, plain
and SDPA times, the bound, the worst error in row ulps and the
request-alone equality; the same for one chunk alone (B 1, start 5888,
256 live tokens); and the ``ptxas`` lines of the tree's
``windowed_ragged_prefill`` library.

``--part window-serve``: starcoder2-7b cut to 16 of 32 layers, bf16 and
int8 ring pages, each served on the ``hopper`` backend with
``chip_smoke.phase_window_serve``'s workload (4 requests of 1024..6144
prompt tokens, 256-token chunks, 32 new tokens) by a fresh engine:
tok/s, TTFT p50 and p95, prefill steps and K4 launches; then by another
fresh engine under ``torch.profiler``: the device's busy share and K4's
share of the device time.

``--part mla-kernels``: ``chip_smoke.phase_mla_prefill`` for K6 and
K6-int8 at deepseek-v2's shape (B 8 chunks of 256 at starts 0, 256, ...,
1792, the last with 200 live tokens, 128 heads, L 512): kernel, plain and
einsum + SDPA times, both bounds (the bf16 tensor cores', and the fp64
contract's for bf16 pages), the worst error in row ulps and the
request-alone equality; the same for one chunk alone (B 1, start 1792);
where the tree's K6 has a stage A (``mla_build_kv``), its time, its fp64
(or bf16) TFLOP/s and its check against the plain einsum; and the
``ptxas`` lines of the tree's ``mla_ragged_prefill`` and ``mla_build_kv``
libraries.  Only the wrappers are called, so a tree without stage A is
timed the same way.

``--part mla-serve``: deepseek-v2-236b cut to ``chip_smoke.DS_LAYERS`` (4)
of 60 layers, bf16 and int8 latent pages, each served on the ``hopper``
backend with the smoke's workload (``chip_smoke.phase_mla_serve``'s
prompts at seed 0) by a fresh engine, after an unmeasured two-request
warm-up: tok/s, TTFT p50 and p95, prefill steps and K6 launches; then by
another fresh engine under ``torch.profiler``: the device's busy share
and K6's share of the device time (both stages' kernels,
``mla_prefill_kernel`` and ``mla_build_kv_kernel``).

The last line is one JSON object with the numbers.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[3]      # the checkout holding chip_smoke.py
K2_KERNEL = "ragged_prefill_kernel"
K4_KERNEL = "windowed_prefill_kernel"
K6_KERNELS = ("mla_prefill_kernel", "mla_build_kv_kernel")   # both stages
WINDOW_LAYERS = 16                 # starcoder2-7b cut to 16 of 32 layers


def kernels(smoke) -> dict:
    from repro_torch.kernels import build_all
    _, libs = build_all()
    smoke.print_ptxas("ragged_prefill",
                      libs["ragged_prefill"].with_suffix(".log"))
    rng = np.random.RandomState(0)
    timer = smoke.Timer(torch)
    out = {}
    for label, kw in (("K2", {}), ("K2-D128", dict(K=8, G=3, D=128))):
        for int8 in (False, True):
            name = label + ("-int8" if int8 else "")
            out[name] = smoke.phase_prefill(torch, rng, timer, int8=int8,
                                            label=label, **kw)
    return out


def window_kernels(smoke) -> dict:
    from repro_torch.kernels import build_all
    _, libs = build_all()
    smoke.print_ptxas("windowed_ragged_prefill",
                      libs["windowed_ragged_prefill"].with_suffix(".log"))
    rng = np.random.RandomState(0)
    timer = smoke.Timer(torch)
    out = {}
    for int8 in (False, True):
        out["K4" + ("-int8" if int8 else "")] = smoke.phase_windowed_prefill(
            torch, rng, timer, int8=int8)
    out["K4-one-chunk"] = smoke.phase_windowed_prefill(
        torch, rng, timer, chunks=((5888, 256),), label="K4-one-chunk")
    return out


def device_profile(smoke, fn, kid="k2", kernel=K2_KERNEL) -> dict:
    """Run ``fn`` under ``chip_smoke.profile_device`` tracing the device
    alone: the kernels' summed device time over the wall time, and the
    share of that device time of the kernels whose names hold ``kernel``
    (a name or a tuple of names; K2's by default; keys start with
    ``kid``); None where it was not measured."""
    names = (kernel,) if isinstance(kernel, str) else kernel
    prof = smoke.profile_device(torch, fn, device_only=True)
    if prof is None:
        return {"busy_share": None, f"{kid}_share_of_device": None}
    wall_us, rows, _ = prof
    busy = sum(t for _, t, _ in rows)
    mine = sum(t for key, t, _ in rows if any(n in key for n in names))
    return {"busy_share": busy / wall_us,
            f"{kid}_share_of_device": mine / busy,
            f"{kid}_device_ms": mine / 1e3, "device_busy_ms": busy / 1e3,
            "profiled_wall_ms": wall_us / 1e3}


def serve_one(smoke, cfg, params, prompts, kv_dtype, spec) -> dict:
    from repro_torch.configs import ServeConfig
    from repro_torch.kernels.ragged_prefill import ragged_prefill
    from repro_torch.serving import Engine
    scfg = ServeConfig(attn_backend="hopper", kv_dtype=kv_dtype,
                       speculate_tokens=spec, **smoke.serve_kwargs())
    ragged_prefill.launches = 0
    eng = Engine(cfg, scfg, params, seed=0, device="cuda")
    _, m = eng.run_offline(prompts, smoke.GEN_TOKENS)
    torch.cuda.synchronize()
    row = {"tokens_per_s": m["tokens_per_s"],
           "ttft_p50_ms": m["ttft_p50_s"] * 1e3,
           "ttft_p95_ms": m["ttft_p95_s"] * 1e3,
           "prefill_steps": m["prefill_steps"],
           "k2_launches": ragged_prefill.launches}
    del eng
    eng = Engine(cfg, scfg, params, seed=0, device="cuda")
    row.update(device_profile(smoke, lambda: eng.run_offline(
        prompts, smoke.GEN_TOKENS)))
    del eng
    print(f"[prefill_cost] {cfg.name} {kv_dtype}"
          f"{f' speculate {spec}' if spec else ''}: "
          f"{row['tokens_per_s']:.1f} tok/s, TTFT p50 "
          f"{row['ttft_p50_ms']:.1f} ms (p95 {row['ttft_p95_ms']:.1f}), "
          f"{row['prefill_steps']} prefill steps, K2 {row['k2_launches']}; "
          f"profiled run: busy {row['busy_share']}, K2 "
          f"{row['k2_share_of_device']} of device time", flush=True)
    return row


def serve(smoke) -> dict:
    from repro_torch.configs import get_arch
    from repro_torch.models.registry import init_params
    out = {}
    for arch, modes in (("qwen2-0.5b", (("bf16", 0), ("bf16", 4),
                                        ("int8", 0))),
                        ("minitron-4b", (("bf16", 0), ("int8", 0)))):
        cfg = get_arch(arch)
        prompts = smoke.serving_workload(np.random.RandomState(0), cfg.vocab)
        with torch.no_grad():
            params = init_params(cfg, 0, "cuda")
            for kv_dtype, spec in modes:
                key = f"{arch} {kv_dtype}" + (f" spec{spec}" if spec else "")
                out[key] = serve_one(smoke, cfg, params, prompts, kv_dtype,
                                     spec)
        del params
        torch.cuda.empty_cache()
    return out


def window_serve(smoke) -> dict:
    import dataclasses
    from repro_torch.configs import ServeConfig, get_arch
    from repro_torch.kernels.ragged_prefill import windowed_prefill
    from repro_torch.models.registry import init_params
    from repro_torch.serving import Engine
    cfg = dataclasses.replace(get_arch("starcoder2-7b"),
                              n_layers=WINDOW_LAYERS)
    rng = np.random.RandomState(1)       # phase_window_serve's at seed 0
    prompts = [rng.randint(1, cfg.vocab, size=n).tolist()
               for n in smoke.SC_PROMPTS]
    out = {}
    with torch.no_grad():
        params = init_params(cfg, 0, "cuda")
        for kv_dtype in ("bf16", "int8"):
            scfg = ServeConfig(attn_backend="hopper", kv_dtype=kv_dtype,
                               **smoke.window_serve_kwargs())
            windowed_prefill.launches = 0
            eng = Engine(cfg, scfg, params, seed=0, device="cuda")
            _, m = eng.run_offline(prompts, smoke.GEN_TOKENS)
            torch.cuda.synchronize()
            row = {"tokens_per_s": m["tokens_per_s"],
                   "ttft_p50_ms": m["ttft_p50_s"] * 1e3,
                   "ttft_p95_ms": m["ttft_p95_s"] * 1e3,
                   "prefill_steps": m["prefill_steps"],
                   "k4_launches": windowed_prefill.launches}
            del eng
            eng = Engine(cfg, scfg, params, seed=0, device="cuda")
            row.update(device_profile(smoke, lambda: eng.run_offline(
                prompts, smoke.GEN_TOKENS), "k4", K4_KERNEL))
            del eng
            print(f"[prefill_cost] {cfg.name} ({WINDOW_LAYERS} layers) "
                  f"{kv_dtype}: {row['tokens_per_s']:.1f} tok/s, TTFT p50 "
                  f"{row['ttft_p50_ms']:.1f} ms (p95 "
                  f"{row['ttft_p95_ms']:.1f}), {row['prefill_steps']} "
                  f"prefill steps, K4 {row['k4_launches']}; profiled run: "
                  f"busy {row['busy_share']}, K4 "
                  f"{row['k4_share_of_device']} of device time", flush=True)
            out[f"{cfg.name} {kv_dtype}"] = row
    return out


def mla_kernels(smoke) -> dict:
    from repro_torch.kernels import build_all
    _, libs = build_all()
    for stem in ("mla_ragged_prefill", "mla_build_kv"):
        if stem in libs:                 # a tree before stage A has one
            smoke.print_ptxas(stem, libs[stem].with_suffix(".log"))
    rng = np.random.RandomState(0)
    timer = smoke.Timer(torch)
    out = {}
    for name, kw in (("K6", {}), ("K6-int8", dict(int8=True)),
                     ("K6-one-chunk", dict(chunks=((1792, 256),),
                                           label="K6-one-chunk"))):
        out[name], kv = smoke.phase_mla_prefill(torch, rng, timer, **kw)
        if kv:
            out[name.replace("K6", "K6-kv")] = kv
    return out


def mla_serve(smoke) -> dict:
    import dataclasses
    from repro_torch.configs import ServeConfig, get_arch
    from repro_torch.kernels import build_all
    from repro_torch.kernels.ragged_prefill import mla_ragged_prefill
    from repro_torch.models.registry import init_params
    from repro_torch.serving import Engine
    cfg = dataclasses.replace(get_arch("deepseek-v2-236b"),
                              n_layers=smoke.DS_LAYERS)
    # phase_mla_serve's prompts at seed 0
    prompts = smoke.serving_workload(np.random.RandomState(2), cfg.vocab)
    build_all()
    out = {}
    with torch.no_grad():
        params = init_params(cfg, 0, "cuda")
        for kv_dtype in ("bf16", "int8"):
            scfg = ServeConfig(attn_backend="hopper", kv_dtype=kv_dtype,
                               **smoke.serve_kwargs())
            # a short unmeasured run first: libraries loaded, first-call
            # set-up (cuBLAS, the caching allocator) out of the timed runs
            Engine(cfg, scfg, params, seed=0, device="cuda").run_offline(
                prompts[:2], 2)
            torch.cuda.synchronize()
            mla_ragged_prefill.launches = 0
            eng = Engine(cfg, scfg, params, seed=0, device="cuda")
            _, m = eng.run_offline(prompts, smoke.GEN_TOKENS)
            torch.cuda.synchronize()
            row = {"tokens_per_s": m["tokens_per_s"],
                   "ttft_p50_ms": m["ttft_p50_s"] * 1e3,
                   "ttft_p95_ms": m["ttft_p95_s"] * 1e3,
                   "prefill_steps": m["prefill_steps"],
                   "k6_launches": mla_ragged_prefill.launches}
            del eng
            eng = Engine(cfg, scfg, params, seed=0, device="cuda")
            row.update(device_profile(smoke, lambda: eng.run_offline(
                prompts, smoke.GEN_TOKENS), "k6", K6_KERNELS))
            del eng
            torch.cuda.empty_cache()
            print(f"[prefill_cost] {cfg.name} ({smoke.DS_LAYERS} layers) "
                  f"{kv_dtype}: {row['tokens_per_s']:.1f} tok/s, TTFT p50 "
                  f"{row['ttft_p50_ms']:.1f} ms (p95 "
                  f"{row['ttft_p95_ms']:.1f}), {row['prefill_steps']} "
                  f"prefill steps, K6 {row['k6_launches']}; profiled run: "
                  f"busy {row['busy_share']}, K6 "
                  f"{row['k6_share_of_device']} of device time", flush=True)
            out[f"{cfg.name} {kv_dtype}"] = row
    return out


PARTS = {"kernels": kernels, "serve": serve, "window-kernels": window_kernels,
         "window-serve": window_serve, "mla-kernels": mla_kernels,
         "mla-serve": mla_serve}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", choices=tuple(PARTS), required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("prefill_cost: needs an NVIDIA card")
    import repro_torch               # the tree under test, before chip_smoke
    sys.path.append(str(ROOT))
    import chip_smoke as smoke
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    numbers = PARTS[args.part](smoke)
    res = {"tree": str(Path(repro_torch.__file__).resolve().parents[2]),
           "part": args.part, "device": smi,
           "seconds": time.perf_counter() - t0, args.part: numbers}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
