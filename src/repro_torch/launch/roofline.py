"""Aggregate the dry-run sweep's JSONs into the roofline table: the
counterpart of ``benchmarks/roofline.py``, on the H100's constants.

Reads ``experiments/dryrun_torch/*.json`` (written by
``repro_torch.launch.sweep``) and prints a CSV line a traced cell, then a
markdown table with the three roofline terms of the traced reference
path (``hlo_cost``'s byte rule), the dominant one, the least bound
(``roofline_min``: model FLOPs and the bytes a step must move), model
FLOPs over traced FLOPs, the planned bytes a device against the card's
80 GB, and a one-line note on what would move the dominant term.  Every
number is a plan from ``launch/dryrun.py``, not a measurement:

  PYTHONPATH=src python -m repro_torch.launch.figures --only roofline --device cpu
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List

from .sweep import OUT

NOTES = {
    ("compute",): "raise a device's work (bigger local batch); the eager "
                  "port's fp32 elementwise ops count at the bf16 rate",
    ("memory",): "fuse attention (K2/K4/K9 keep the scores on chip: see "
                 "roofline_flash), fewer eager elementwise ops and casts",
    ("collective",): "overlap the MapReduce reduce with the backward, or "
                     "compress it across pods (reduce_mode=compressed)",
}


def load(out_dir: str = OUT) -> List[Dict]:
    rows = []
    for fn in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(fn) as f:
            rows.append(json.load(f))
    return rows


def fmt_row(r: Dict) -> str:
    if r["status"] != "ok":
        reason = r.get("reason", r.get("error", ""))[:60]
        return (f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['status']} "
                f"| — | — | — | — | — | — | — | {reason} |")
    roof = r["roofline"]
    dom = roof["dominant"]
    note = NOTES.get((dom,), "")
    return (f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok "
            f"| {roof['compute_s']:.3f} | {roof['memory_s']:.3f} "
            f"| {roof['collective_s']:.3f} | **{dom}** "
            f"| {r['roofline_min']['step_lower_bound_s']:.4f} "
            f"| {r['useful_flops_ratio']:.2f} "
            f"| {r['analytic_bytes_per_device'] / 1e9:.1f}"
            f"{'' if r['fits_80GB'] else ' (> 80)'} | {note} |")


def run(out_dir: str = OUT, csv: bool = True):
    rows = load(out_dir)
    ok = [r for r in rows if r["status"] == "ok"]
    if csv:
        for r in ok:
            roof = r["roofline"]
            print(f"roofline,{r['arch']},{r['shape']},{r['mesh']},"
                  f"compute_s={roof['compute_s']:.4f},"
                  f"memory_s={roof['memory_s']:.4f},"
                  f"collective_s={roof['collective_s']:.4f},"
                  f"dominant={roof['dominant']},"
                  f"least_s={r['roofline_min']['step_lower_bound_s']:.6f},"
                  f"useful_ratio={r['useful_flops_ratio']:.3f},"
                  f"planned_gb={r['analytic_bytes_per_device'] / 1e9:.2f}")
    return rows


def markdown(out_dir: str = OUT) -> str:
    rows = load(out_dir)
    hdr = ("| arch | shape | mesh | status | compute s | memory s | "
           "collective s | dominant | least s | useful/traced | "
           "GB a device | note |\n"
           "|---|---|---|---|---|---|---|---|---|---|---|---|")
    return hdr + "\n" + "\n".join(fmt_row(r) for r in rows)


if __name__ == "__main__":
    run()
    print()
    print(markdown())
