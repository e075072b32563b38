"""Time K9 (the training forward's flash attention) and K8 (the RBM's GEMM +
sigmoid) and the training runs they carry, for one tree on the card, to
compare two trees in one call.

    PYTHONPATH=src python3 src/repro_torch/launch/train_cost.py --part flash-kernels
    PYTHONPATH=<other tree>/src python3 src/repro_torch/launch/train_cost.py --part train
    PYTHONPATH=src python3 src/repro_torch/launch/train_cost.py --part rbm-kernels
    PYTHONPATH=src python3 src/repro_torch/launch/train_cost.py --part paper

It imports ``repro_torch`` by absolute name before anything else, so it
measures whichever tree is first on the path (its kernels built from that
tree's sources into that tree's ``build/``); the phase functions, the
shapes and the timer come from this checkout's ``chip_smoke.py``.

``--part flash-kernels``: ``chip_smoke.phase_flash``, K9 at qwen2-0.5b's
training shape (B 8, S 1024, 14 / 2 heads of 64) causal and full in bf16
and causal in fp32, and at minitron-4b's heads (24 / 8 of 128) causal in
bf16: kernel, plain and SDPA times, the function's bound and the
two-term body's, the worst error in row ulps (fp32: over 1e-5), each
request alone against its rows in the batch and, causal, rows 0..999 at S
= 1000 against the S = 1024 call's, bit for bit; the registers and
spills ``ptxas`` reported for the tree's ``flash_attention`` library; and
the gradients of ``flash_attention_train`` against autograd through the
plain version.

``--part train``: ``chip_smoke.train_run``, 20 AdamW steps of full-width,
full-depth qwen2-0.5b (B 8, S 1024, random weights from seed 0) on the
``hopper`` backend: step p50, tokens/s, peak memory and K9 launches; then
3 profiled steps: the device's busy share of the wall time and K9's
share of the device time.

``--part rbm-kernels``: ``chip_smoke.phase_gemm_sigmoid``, K8 at every
layer of full-width mnist-dbn (784-1000-500-250-30), both CD phases at
batch 100 and the forward-propagation job at 60000 rows, fp32, and layer
0's positive phase in bf16: kernel, plain and ``sigmoid(addmm)`` times,
the fp32 and three-term bounds, errors, the bit-equalities, ptxas; then,
at both of layer 0's CD shapes, the wrapper's host time a call (the
median of 500 calls, each made on an idle device) and each CUDA kernel's
device time a call (``torch.profiler``).

``--part paper``: mnist-dbn pre-trained with one CD-1 epoch per RBM
(batch 100) on 60000 synthetic digits from seed 0, as ``chip_smoke``'s
paper phase runs it: CD steps/s of five timed runs and their median,
then one more run under ``torch.profiler`` (device activity only): the
device's busy share of the wall time and K8's share of the device time.

The last line is one JSON object with the numbers.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[3]      # the checkout holding chip_smoke.py


def flash_kernels(smoke) -> dict:
    from repro_torch.kernels import build_all
    build_all()
    return smoke.phase_flash(torch, smoke.Timer(torch))


def train(smoke) -> dict:
    from repro_torch.kernels import build_all
    build_all()
    _, report, _ = smoke.train_run(torch, 0)
    return report


def rbm_kernels(smoke) -> dict:
    from repro_torch.kernels import build_all
    from repro_torch.kernels.rbm_cd import gemm_sigmoid
    build_all()
    shapes, ptxas = smoke.phase_gemm_sigmoid(torch, smoke.Timer(torch), 0)
    gen = torch.Generator(device="cuda").manual_seed(7)
    w = 0.1 * torch.randn((784, 1000), generator=gen, device="cuda")
    host = {}
    for label, x, wt, b in (
            ("L0 hidden [100,784]x[784,1000]",
             torch.rand((100, 784), generator=gen, device="cuda"), w,
             torch.rand((1000,), generator=gen, device="cuda")),
            ("L0 visible [100,1000]xW.T",
             (torch.rand((100, 1000), generator=gen, device="cuda") < 0.5)
             .float(), w.T, torch.rand((784,), generator=gen,
                                       device="cuda"))):
        for _ in range(50):
            gemm_sigmoid(x, wt, b)
        calls = []
        for _ in range(500):            # each call on an idle device
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gemm_sigmoid(x, wt, b)
            calls.append(time.perf_counter() - t0)
        host_us = sorted(calls)[len(calls) // 2] * 1e6
        torch.cuda.synchronize()
        prof = smoke.profile_device(
            torch, lambda: [gemm_sigmoid(x, wt, b) for _ in range(50)],
            device_only=True)
        kernels = {k: t / 50 for k, t, _ in prof[1]} if prof else None
        print(f"[train_cost] K8 {label}: wrapper host {host_us:.2f} us a "
              f"call (median); device us a call: {kernels}", flush=True)
        host[label] = {"host_us_per_call": host_us,
                       "device_us_per_call": kernels}
    return {"shapes": shapes, "ptxas": ptxas, "cd_calls": host}


RUNS = 5         # timed pre-training runs of the paper part


def paper(smoke) -> dict:
    from repro_torch.configs.mnist_dbn import STACK
    from repro_torch.core import DBNConfig, train_dbn
    from repro_torch.data import train_test
    from repro_torch.kernels import build_all
    from repro_torch.kernels.rbm_cd import gemm_sigmoid
    build_all()
    xtr = torch.as_tensor(train_test(n_train=60000, n_test=10, seed=0)[0],
                          device="cuda")
    cfg = DBNConfig(stack=STACK, max_epoch=1, batch_size=100)
    train_dbn(xtr[:2000], cfg, torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    cd_steps = 600 * (len(STACK) - 1)
    rates = []
    for _ in range(RUNS):
        gemm_sigmoid.launches = 0
        t0 = time.perf_counter()
        train_dbn(xtr, cfg, torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        rates.append(cd_steps / (time.perf_counter() - t0))
    out = {"cd_steps": cd_steps, "cd_steps_per_s_runs": rates,
           "cd_steps_per_s": sorted(rates)[len(rates) // 2],
           "k8_launches": gemm_sigmoid.launches}
    prof = smoke.profile_device(
        torch, lambda: train_dbn(
            xtr, cfg, torch.Generator(device="cuda").manual_seed(0)),
        device_only=True)
    if prof is not None:
        wall_us, kernels, _ = prof
        busy_us = sum(t for _, t, _ in kernels)
        k8_us = sum(t for k, t, _ in kernels if "gemm_sigmoid" in k)
        out.update(busy_share=busy_us / wall_us, k8_share=k8_us / busy_us,
                   k8_device_ms=k8_us / 1e3, device_ms=busy_us / 1e3,
                   top_kernels=[(k[:80], t / 1e3, n)
                                for k, t, n in kernels[:8]])
    print(f"[train_cost] paper: {cd_steps} CD steps a run, CD steps/s "
          f"{', '.join(f'{r:.1f}' for r in rates)} (median "
          f"{out['cd_steps_per_s']:.1f}), K8 launches a run "
          f"{out['k8_launches']}; profiled run: busy share "
          f"{out.get('busy_share')}, K8 share of device time "
          f"{out.get('k8_share')}", flush=True)
    return out


PARTS = {"flash-kernels": flash_kernels, "train": train,
         "rbm-kernels": rbm_kernels, "paper": paper}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", choices=tuple(PARTS), required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("train_cost: needs an NVIDIA card")
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
