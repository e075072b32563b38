"""Time K1 (paged decode) and K3 (speculative verify), K5 and K7 (their
MLA latent counterparts), and the serving runs they carry, for one tree on
the card, to compare two trees in one call.

    PYTHONPATH=src python3 src/repro_torch/launch/decode_cost.py --part kernels
    PYTHONPATH=<other tree>/src python3 src/repro_torch/launch/decode_cost.py --part serve
    PYTHONPATH=src python3 src/repro_torch/launch/decode_cost.py --part mla-kernels
    PYTHONPATH=src python3 src/repro_torch/launch/decode_cost.py --part mla-serve

It imports ``repro_torch`` by absolute name before anything else, so it
measures whichever tree is first on the path (its kernels built from that
tree's sources into that tree's ``build/``); the phase functions, the
workloads, the timer and the profiler come from this checkout's
``chip_smoke.py``.

``--part kernels``: ``chip_smoke.phase_decode`` and ``phase_verify`` for
K1, K1-int8, K3 and K3-int8 (qwen2-0.5b's 2 / 7 heads of 64), and
``phase_ring`` for K1-ring, K3-ring and their int8 modes (starcoder2-7b's
4 / 9 heads of 128 over 257- and 258-page rings) and K3-ring-60 and
K3-ring-60-int8 (command-r-plus-104b's 8 / 12 heads of 128, 60 rows a KV
head): kernel, plain and SDPA times, the bound and the worst error in row
ulps; for the kernel's own call in each phase, the device time a call of
each of its CUDA kernels (``torch.profiler`` tracing the device alone, 20
calls, the L2 flushed before each) and the host time a call of its
wrapper (20 calls enqueued behind a device spin, so that none waits for
the device); and the registers and spills ``ptxas`` reported for the
tree's ``paged_decode`` and ``paged_verify`` libraries.

``--part serve``: qwen2-0.5b (bf16, then n-gram speculation with K = 4)
with the smoke's workload (8 requests of 128..1024 prompt tokens, 32 new
tokens), and starcoder2-7b with n-gram speculation at full width, its
depth cut to ``SC_LAYERS`` of its 32 layers so that the part stays within
a few minutes (4 requests of 1024..6144 tokens), each on the ``hopper``
backend by a fresh engine: tok/s and the decode step p50 (a verify step
where speculation is on); then the same requests by another fresh engine
under ``torch.profiler``, tracing the device alone: the device's busy
share of the wall time and the share of the device time in K1's or K3's
kernels.

The last line is one JSON object with the numbers.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[3]      # the checkout holding chip_smoke.py
# the device kernels of K1 and K3: the split and merge kernels, or the
# single kernel of the earlier one-block-per-KV-head design
ATTEND_KERNELS = ("paged_split_kernel", "paged_merge_kernel",
                  "paged_attend_kernel")
# K5's and K7's: the split and merge kernels, or the single row kernel of
# the earlier design (mla::attend_kernel<512, 64, int8>, demangled or not)
MLA_KERNELS = ("mla_split_kernel", "mla_merge_kernel", "attend_kernel<512",
               "attend_kernelILi512")
SC_LAYERS = 4            # starcoder2-7b's depth in --part serve, of 32


class PhaseTimer:
    """``chip_smoke.Timer``, which also takes, for each callable that
    launches one of ``wrappers`` (K1 and K3 by default, seen by their
    launch counts), the host time a call and, with ``device``, the device
    time a call of each CUDA kernel whose name holds ``paged_``, into
    ``taken``."""

    HOST_HOLD_CYCLES = 20_000_000   # ~10 ms: longer than 20 wrapper calls

    def __init__(self, smoke, wrappers=None, device=True):
        from repro_torch.kernels.paged_attention import (paged_decode,
                                                         paged_verify)
        self.smoke, self.timer = smoke, smoke.Timer(torch)
        self.iters, self.flush = self.timer.iters, self.timer.flush
        self.wrappers = wrappers or (paged_decode, paged_verify)
        self.device = device
        self.taken = []

    def __call__(self, fn) -> float:
        before = sum(w.launches for w in self.wrappers)
        ms = self.timer(fn)
        if sum(w.launches for w in self.wrappers) != before:
            row = {"host_us": self.host_us(fn)}
            if self.device:
                row["device_us"] = self.smoke.device_us(
                    torch, self.timer, fn, r"paged_\w+_kernel")
            self.taken.append(row)
        return ms

    def host_us(self, fn) -> float:
        """Median over 5 rounds of the host time a call, each round 20
        calls enqueued behind a device spin that outlasts them."""
        rounds = []
        for _ in range(5):
            torch.cuda.synchronize()
            torch.cuda._sleep(self.HOST_HOLD_CYCLES)
            t0 = time.perf_counter()
            for _ in range(self.timer.iters):
                fn()
            rounds.append((time.perf_counter() - t0) * 1e6
                          / self.timer.iters)
            torch.cuda.synchronize()
        return sorted(rounds)[len(rounds) // 2]


def kernels(smoke) -> dict:
    from repro_torch.kernels import build_all
    _, libs = build_all()
    for stem in ("paged_decode", "paged_verify"):
        smoke.print_ptxas(stem, libs[stem].with_suffix(".log"))
    rng = np.random.RandomState(0)
    timer = PhaseTimer(smoke)
    out = {}

    def add(rows):
        """Give each phase row of ``rows`` (in the order its phase timed
        the kernels) its device and host time."""
        assert len(timer.taken) == len(rows), (list(rows), timer.taken)
        for (name, row), taken in zip(rows.items(), timer.taken):
            row.update(taken)
            smoke.print_device_us(name, taken["device_us"], "decode_cost")
            print(f"[decode_cost] {name}: {taken['host_us']:.1f} us a call "
                  "on the host", flush=True)
            out[name] = row
        timer.taken.clear()

    for int8 in (False, True):
        sfx = "-int8" if int8 else ""
        add({"K1" + sfx: smoke.phase_decode(torch, rng, timer, int8=int8)})
        add({"K3" + sfx: smoke.phase_verify(torch, rng, timer, int8=int8)})
        add({kid + sfx: row for kid, row in smoke.phase_ring(
            torch, rng, timer, int8=int8).items()})
        add({"K3-ring-60" + sfx: smoke.phase_ring(
            torch, rng, timer, int8=int8, K=smoke.CR_K, G=smoke.CR_G,
            cases=smoke.CR_RING_CASES, label="-60")["K3-ring"]})
    return out


def mla_kernels(smoke) -> dict:
    from repro_torch.kernels import build_all
    from repro_torch.kernels.paged_attention import (mla_paged_decode,
                                                     mla_paged_verify)
    _, libs = build_all()
    ptxas = {stem: smoke.print_ptxas(stem, libs[stem].with_suffix(".log"))
             for stem in ("mla_paged_decode", "mla_paged_verify")}
    rng = np.random.RandomState(0)
    timer = PhaseTimer(smoke, (mla_paged_decode, mla_paged_verify),
                       device=False)
    out = {"ptxas": ptxas}
    for int8 in (False, True):
        sfx = "-int8" if int8 else ""
        for kid, phase in (("K5", smoke.phase_mla_decode),
                           ("K7", smoke.phase_mla_verify)):
            row = phase(torch, rng, timer, int8=int8)
            (taken,) = timer.taken
            timer.taken.clear()
            row.update(taken)
            print(f"[decode_cost] {kid}{sfx}: {taken['host_us']:.1f} us a "
                  "call on the host", flush=True)
            out[kid + sfx] = row
    return out


def device_profile(smoke, fn, kernels=ATTEND_KERNELS) -> dict:
    """Run ``fn`` under ``chip_smoke.profile_device`` tracing the device
    alone: the kernels' summed device time over the wall time, and the
    share of that device time of the kernels whose names hold one of
    ``kernels`` (K1's and K3's by default); None where it was not
    measured."""
    prof = smoke.profile_device(torch, fn, device_only=True)
    if prof is None:
        return {"busy_share": None, "kernel_share_of_device": None}
    wall_us, rows, _ = prof
    busy = sum(t for _, t, _ in rows)
    mine = sum(t for key, t, _ in rows if any(n in key for n in kernels))
    return {"busy_share": busy / wall_us,
            "kernel_share_of_device": mine / busy,
            "kernel_device_ms": mine / 1e3, "device_busy_ms": busy / 1e3,
            "profiled_wall_ms": wall_us / 1e3}


def serve_one(smoke, cfg, params, prompts, spec, kwargs) -> dict:
    from repro_torch.configs import ServeConfig
    from repro_torch.kernels.paged_attention import paged_decode, paged_verify
    from repro_torch.serving import Engine
    scfg = ServeConfig(attn_backend="hopper", speculate_tokens=spec,
                       **kwargs)
    paged_decode.launches = paged_verify.launches = 0
    eng = Engine(cfg, scfg, params, seed=0, device="cuda")
    _, m = eng.run_offline(prompts, smoke.GEN_TOKENS)
    torch.cuda.synchronize()
    row = {"tokens_per_s": m["tokens_per_s"],
           "step_ms_p50": m["decode_step_ms_p50"],
           "steps": m["decode_steps"],
           "k1_launches": paged_decode.launches,
           "k3_launches": paged_verify.launches}
    if spec:
        row["accept_rate"] = m["spec_accept_rate"]
    del eng
    eng = Engine(cfg, scfg, params, seed=0, device="cuda")
    row.update(device_profile(smoke, lambda: eng.run_offline(
        prompts, smoke.GEN_TOKENS)))
    del eng
    kid = "K3" if spec else "K1"
    print(f"[decode_cost] {cfg.name} ({cfg.n_layers} layers)"
          f"{f' n-gram K = {spec}' if spec else ''}: "
          f"{row['tokens_per_s']:.1f} tok/s, "
          f"{'verify' if spec else 'decode'} step p50 "
          f"{row['step_ms_p50']:.3f} ms over {row['steps']} steps, K1 "
          f"{row['k1_launches']}, K3 {row['k3_launches']}; profiled run: "
          f"busy {row['busy_share']}, {kid} {row['kernel_share_of_device']} "
          f"of device time", flush=True)
    return row


def serve(smoke) -> dict:
    from repro_torch.configs import get_arch
    from repro_torch.models.registry import init_params
    out = {}
    cfg = get_arch("qwen2-0.5b")
    prompts = smoke.serving_workload(np.random.RandomState(0), cfg.vocab)
    with torch.no_grad():
        params = init_params(cfg, 0, "cuda")
        for spec in (0, 4):
            out[f"qwen2-0.5b spec{spec}"] = serve_one(
                smoke, cfg, params, prompts, spec, smoke.serve_kwargs())
    del params
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_arch("starcoder2-7b"), n_layers=SC_LAYERS)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, cfg.vocab, size=n).tolist()
               for n in smoke.SC_PROMPTS]
    with torch.no_grad():
        params = init_params(cfg, 0, "cuda")
        out[f"starcoder2-7b ({SC_LAYERS} layers) spec4"] = serve_one(
            smoke, cfg, params, prompts, 4, smoke.window_serve_kwargs())
    del params
    torch.cuda.empty_cache()
    return out


def mla_serve(smoke) -> dict:
    from repro_torch.configs import ServeConfig, get_arch
    from repro_torch.kernels import build_all
    from repro_torch.kernels.paged_attention import (mla_paged_decode,
                                                     mla_paged_verify)
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
        for spec in (0, 4):
            scfg = ServeConfig(attn_backend="hopper", speculate_tokens=spec,
                               **smoke.serve_kwargs())
            # a short unmeasured run first: libraries loaded, first-call
            # set-up (cuBLAS, the caching allocator) out of the timed runs
            Engine(cfg, scfg, params, seed=0, device="cuda").run_offline(
                prompts[:2], 2)
            torch.cuda.synchronize()
            mla_paged_decode.launches = mla_paged_verify.launches = 0
            eng = Engine(cfg, scfg, params, seed=0, device="cuda")
            _, m = eng.run_offline(prompts, smoke.GEN_TOKENS)
            torch.cuda.synchronize()
            row = {"tokens_per_s": m["tokens_per_s"],
                   "step_ms_p50": m["decode_step_ms_p50"],
                   "steps": m["decode_steps"],
                   "k5_launches": mla_paged_decode.launches,
                   "k7_launches": mla_paged_verify.launches}
            if spec:
                row["accept_rate"] = m["spec_accept_rate"]
            del eng
            eng = Engine(cfg, scfg, params, seed=0, device="cuda")
            row.update(device_profile(smoke, lambda: eng.run_offline(
                prompts, smoke.GEN_TOKENS), MLA_KERNELS))
            del eng
            torch.cuda.empty_cache()
            kid = "K7" if spec else "K5"
            print(f"[decode_cost] {cfg.name} ({smoke.DS_LAYERS} layers)"
                  f"{f' n-gram K = {spec}' if spec else ''}: "
                  f"{row['tokens_per_s']:.1f} tok/s, "
                  f"{'verify' if spec else 'decode'} step p50 "
                  f"{row['step_ms_p50']:.3f} ms over {row['steps']} steps, "
                  f"K5 {row['k5_launches']}, K7 {row['k7_launches']}; "
                  f"profiled run: busy {row['busy_share']}, {kid} "
                  f"{row['kernel_share_of_device']} of device time",
                  flush=True)
            out[f"{cfg.name} spec{spec}"] = row
    return out


PARTS = {"kernels": kernels, "serve": serve, "mla-kernels": mla_kernels,
         "mla-serve": mla_serve}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", choices=tuple(PARTS), required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("decode_cost: needs an NVIDIA card")
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
