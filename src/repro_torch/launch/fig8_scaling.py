"""Paper Fig. 8: running time vs number of workers (MapReduce speed-up):
the port of ``benchmarks/fig8_scaling.py``.

Strong scaling of one RBM CD-1 job (784 x 512, the global batch
``dataset(2048, seed=0)``): for each worker count ``n`` a fresh group of
``n`` processes runs ``core.make_rbm_step`` over ``dp_groups(n_pod=1)``,
one pod of ``n`` mappers, each holding its 2048 / n rows in rank order; one
warm-up job, then 10 timed jobs.  The processes meet through a file store
and talk over loopback.  On the CPU they run on ``gloo`` with one
intra-op thread each, so the sweep divides the work instead of contending
for cores; on the card a world of one process runs on ``nccl``, every
probability through kernel K8.  Beside the measured time, the columns of
the JAX script: the per-device work fraction (1/n) and the all-reduce's
bytes a device, the quantities that transfer to a real fleet.

  PYTHONPATH=src python -m repro_torch.launch.fig8_scaling --device cpu \\
      [--workers 1 2 4 8]
"""
from __future__ import annotations

import argparse
import datetime
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from .. import resolve_device
from ..core import RBMConfig, dp_groups, make_rbm_step, rbm_init
from ..data import dataset
from ..kernels.rbm_cd import gemm_sigmoid

N_VIS, N_HID, GLOBAL_BATCH, TIMED_JOBS = 784, 512, 2048, 10
SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _worker(rank: int, world: int, store: str, device: str) -> dict:
    """One mapper of the sweep: its shard of the global batch, the warm-up
    job and the timed jobs; returns rank 0's time with this rank's digest
    of the final parameters and its K8 launches."""
    torch.set_num_threads(1)
    dev = resolve_device(device)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"file://{store}", world_size=world,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        cfg = RBMConfig(n_vis=N_VIS, n_hid=N_HID)
        X, _ = dataset(GLOBAL_BATCH, seed=0)
        rows = GLOBAL_BATCH // world
        x = torch.as_tensor(X[rank * rows:(rank + 1) * rows], device=dev)
        # every rank draws the same parameters and the same uniforms, as
        # the JAX job hands every device the same key
        gen = torch.Generator(device=dev).manual_seed(0)
        p = rbm_init(gen, cfg)
        vel = {k: torch.zeros_like(v) for k, v in p.items()}
        step = make_rbm_step(cfg, dp_groups(1))
        n0 = gemm_sigmoid.launches
        _, _, err = step(p, vel, x, gen, 0)            # warm-up
        float(err)
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(TIMED_JOBS):
            p, vel, err = step(p, vel, x, gen, 0)
        err = float(err)                               # waits for the device
        dt = (time.perf_counter() - t0) / TIMED_JOBS
        digest = hashlib.sha256(b"".join(
            p[k].cpu().numpy().tobytes() for k in sorted(p))).hexdigest()
        return {"workers": world, "s_per_job": dt, "err": err,
                "threads": torch.get_num_threads(), "device": str(dev),
                "param_digest": digest,
                "k8_launches": gemm_sigmoid.launches - n0}
    finally:
        dist.destroy_process_group()


def _run_workers(n: int, device: str) -> list:
    """``n`` worker processes; each one's result, in rank order."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    tmp = tempfile.mkdtemp(prefix="fig8_")
    procs = []
    try:
        for rank in range(n):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.fig8_scaling",
                 "--device", device, "--worker", str(rank), str(n),
                 os.path.join(tmp, "store")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=env))
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    recs = []
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT")]
        if p.returncode != 0 or not lines:
            raise RuntimeError(f"fig8 worker {rank} of {n} exited with "
                               f"{p.returncode}: {err[-1500:]}")
        recs.append(json.loads(lines[0][len("RESULT"):]))
    return recs


def run(worker_counts=None, csv=True, device="cuda"):
    """One row a worker count.  ``worker_counts`` defaults to (1, 2, 4, 8)
    on the CPU and (1,) on the card: NCCL gives each rank a card of its own
    and will not put two on one, so more than one worker on ``cuda``
    raises."""
    dev = resolve_device(device)
    if worker_counts is None:
        worker_counts = (1,) if dev.type == "cuda" else (1, 2, 4, 8)
    for n in worker_counts:
        if dev.type == "cuda" and n > 1:
            raise ValueError(
                f"fig8: {n} workers on cuda: NCCL needs a card for each "
                "rank and will not put two ranks on one card, and this "
                "sweep drives one card; run the worker sweep with --device "
                "cpu (gloo)")
        if GLOBAL_BATCH % n:
            raise ValueError(f"fig8: {GLOBAL_BATCH} rows do not split over "
                             f"{n} workers")
    rows = []
    base = None
    for n in worker_counts:
        recs = _run_workers(n, str(dev))
        rec = {k: v for k, v in recs[0].items() if k != "param_digest"}
        rec["param_digests"] = [r["param_digest"] for r in recs]
        if base is None:
            base = rec["s_per_job"]
        # analytic model for a real fleet: mapper work scales 1/n; the
        # reducer all-reduce moves 2(n-1)/n * |W| bytes per device
        wire_mb = 2 * (n - 1) / n * (784 * 512 * 4) / 1e6
        rec["ideal_work_fraction"] = 1.0 / n
        rec["allreduce_mb_per_device"] = wire_mb
        rec["speedup_measured"] = base / rec["s_per_job"]
        rows.append(rec)
        if csv:
            print(f"fig8_scaling,workers={n},s_per_job={rec['s_per_job']:.4f},"
                  f"speedup={rec['speedup_measured']:.2f},"
                  f"ideal_work_fraction={rec['ideal_work_fraction']:.3f},"
                  f"allreduce_mb_per_dev={wire_mb:.2f}")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workers", type=int, nargs="+", default=None,
                    help="worker counts (default: 1 2 4 8 on cpu, 1 on cuda)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--worker", nargs=3, metavar=("RANK", "WORLD", "STORE"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        rank, world, store = args.worker
        print("RESULT" + json.dumps(_worker(int(rank), int(world), store,
                                            args.device)), flush=True)
        return None
    return run(args.workers, device=args.device)


if __name__ == "__main__":
    main()
