"""Time K1 (paged decode) and K3 (speculative verify), and the serving
runs they carry, for one tree on the card, to compare two trees in one
call.

    PYTHONPATH=src python3 src/repro_torch/launch/decode_cost.py --part kernels
    PYTHONPATH=<other tree>/src python3 src/repro_torch/launch/decode_cost.py --part serve

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
import re
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
SC_LAYERS = 4            # starcoder2-7b's depth in --part serve, of 32


class PhaseTimer:
    """``chip_smoke.Timer``, which also takes, for each callable that
    launches K1 or K3 (seen by their wrappers' launch counts), the device
    time a call of each CUDA kernel whose name holds ``paged_`` and the
    host time a call, into ``taken``."""

    HOST_HOLD_CYCLES = 20_000_000   # ~10 ms: longer than 20 wrapper calls

    def __init__(self, smoke):
        from repro_torch.kernels.paged_attention import (paged_decode,
                                                         paged_verify)
        self.smoke, self.timer = smoke, smoke.Timer(torch)
        self.wrappers = (paged_decode, paged_verify)
        self.taken = []

    def __call__(self, fn) -> float:
        before = sum(w.launches for w in self.wrappers)
        ms = self.timer(fn)
        if sum(w.launches for w in self.wrappers) != before:
            self.taken.append({"device_us": self.device_us(fn),
                               "host_us": self.host_us(fn)})
        return ms

    def device_us(self, fn):
        flush, n = self.timer.flush, self.timer.iters

        def calls():
            for _ in range(n):
                flush.zero_()
                fn()
        prof = self.smoke.profile_device(torch, calls, device_only=True)
        if prof is None:
            return None                                  # not measured
        us = {}
        for key, t, _ in prof[1]:
            name = re.search(r"paged_\w+_kernel", key)
            if name:
                us[name.group(0)] = us.get(name.group(0), 0.0) + t / n
        return us

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
            dev = taken["device_us"]
            print(f"[decode_cost] {name}: " + (", ".join(
                f"{k} {v:.1f} us" for k, v in dev.items()) if dev else
                "device time not measured") + " a call on the device, "
                f"{taken['host_us']:.1f} us a call on the host", flush=True)
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


def device_profile(smoke, fn) -> dict:
    """Run ``fn`` under ``chip_smoke.profile_device`` tracing the device
    alone: the kernels' summed device time over the wall time, and the
    share of that device time in K1's or K3's kernels; None where it was
    not measured."""
    prof = smoke.profile_device(torch, fn, device_only=True)
    if prof is None:
        return {"busy_share": None, "kernel_share_of_device": None}
    wall_us, rows, _ = prof
    busy = sum(t for _, t, _ in rows)
    mine = sum(t for key, t, _ in rows
               if any(n in key for n in ATTEND_KERNELS))
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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", choices=("kernels", "serve"), required=True)
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
    numbers = kernels(smoke) if args.part == "kernels" else serve(smoke)
    res = {"tree": str(Path(repro_torch.__file__).resolve().parents[2]),
           "part": args.part, "device": smi,
           "seconds": time.perf_counter() - t0, args.part: numbers}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
