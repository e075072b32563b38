"""Dry-run sweep: one subprocess per (arch x shape x mesh) cell, the
counterpart of ``repro.launch.sweep``.

Each cell runs ``python -m repro_torch.launch.dryrun`` in a fresh process
(bounded memory) and writes its JSON record under ``--out``; cells already
written are read back and not run again, so the sweep resumes where it
stopped.  The meshes are the port's production layouts, ``256`` and
``2x256`` (``launch/mesh.py``).  Nothing runs on a device:

  PYTHONPATH=src python -m repro_torch.launch.sweep
  PYTHONPATH=src python -m repro_torch.launch.figures --only roofline --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from ..configs import ARCHS, SHAPES
from .mesh import make_production_mesh, mesh_name

OUT = os.path.join("experiments", "dryrun_torch")
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))


def cell_list(archs, shapes, meshes):
    for a in archs:
        for s in shapes:
            for mp in meshes:
                yield a, s, mp


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--timeout", type=int, default=3000)
    ap.add_argument("--remat", default=None)
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else sorted(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    os.makedirs(args.out, exist_ok=True)
    results = []
    t00 = time.time()
    for a, s, mp in cell_list(archs, shapes, [False, True]):
        mesh = mesh_name(make_production_mesh(multi_pod=mp))
        path = os.path.join(args.out, f"{a}__{s}__{mesh}.json")
        if os.path.exists(path):
            with open(path) as f:
                rec = json.load(f)
            results.append(rec)
            print(f"[sweep] cached {a} {s} {mesh}: {rec['status']}")
            continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a,
               "--shape", s, "--out", args.out]
        if mp:
            cmd.append("--multipod")
        if args.remat:
            cmd += ["--remat", args.remat]
        t0 = time.time()
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (SRC, env.get("PYTHONPATH", "")) if p)
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=args.timeout, env=env)
            tail = (proc.stdout + proc.stderr).strip().splitlines()[-3:]
        except subprocess.TimeoutExpired:
            tail = ["TIMEOUT"]
        if os.path.exists(path):
            with open(path) as f:
                rec = json.load(f)
        else:
            rec = {"arch": a, "shape": s, "mesh": mesh, "status": "error",
                   "error": "; ".join(tail)}
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
        results.append(rec)
        print(f"[sweep] {a:24s} {s:12s} {mesh:8s} -> {rec['status']:5s} "
              f"({time.time() - t0:.0f}s, total {time.time() - t00:.0f}s)",
              flush=True)
    n = {"ok": 0, "skip": 0, "error": 0}
    for r in results:
        n[r["status"]] = n.get(r["status"], 0) + 1
    print(f"[sweep] done: {n}")


if __name__ == "__main__":
    main()
