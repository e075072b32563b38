"""Time K9 (the training forward's flash attention) and the training steps
it carries, for one tree on the card, to compare two trees in one call.

    PYTHONPATH=src python3 src/repro_torch/launch/train_cost.py --part flash-kernels
    PYTHONPATH=<other tree>/src python3 src/repro_torch/launch/train_cost.py --part train

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


PARTS = {"flash-kernels": flash_kernels, "train": train}


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
