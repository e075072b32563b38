"""Perf hillclimb on the PyTorch port: hypothesis -> change ->
re-trace -> compare, the counterpart of ``experiments/hillclimb.py``.

Runs ``repro_torch.launch.dryrun.dryrun_cell`` with config overrides and
prints a before/after table of the three roofline terms on the H100's
constants.  ``EXPERIMENTS`` is the JAX script's table.  A variant that
would trace an unchanged step is recorded as ``skip`` with its reason,
not reported as a 1.00x variant: ``dryrun_cell`` skips an override no
model of the port reads (``pad_heads_to``, ``seq_parallel``: the port has
no tensor-parallel step to pad heads or split residuals for), ``remat``
(the port keeps every activation), ``engine`` (the port has one engine,
the MapReduce step) and any variant on a mesh with a ``model`` axis > 1;
here, a traced variant whose count equals the baseline's in every term
skips too.  Nothing runs on a device.

  PYTHONPATH=src python experiments/hillclimb_torch.py --cell qwen_train
  PYTHONPATH=src python experiments/hillclimb_torch.py --cell commandr_train --reduced
"""
import argparse
import json
import os

from repro_torch.launch.dryrun import dryrun_cell

# (arch, shape, list of (label, overrides/kwargs))
EXPERIMENTS = {
    # worst useful-FLOPs ratio: 14 heads not divisible by model=16 ->
    # attention fully replicated across the TP axis
    "qwen_train": ("qwen2-0.5b", "train_4k", [
        ("baseline (paper-faithful DP+TP)", {}),
        ("pad heads 14->16 for TP", {"overrides": {"pad_heads_to": 16}}),
        ("+ remat dots", {"overrides": {"pad_heads_to": 16}, "remat": "dots"}),
        ("+ bigger loss chunk (1024)", {"overrides": {
            "pad_heads_to": 16, "loss_chunk": 1024}}),
    ]),
    # most collective-bound hybrid: RG-LRU gates resharded every block
    "rg_train": ("recurrentgemma-2b", "train_4k", [
        ("baseline", {}),
        ("pad heads 10->16 for TP", {"overrides": {"pad_heads_to": 16}}),
        ("+ remat dots", {"overrides": {"pad_heads_to": 16}, "remat": "dots"}),
    ]),
    # worst roofline fraction: 56 heads % 16 != 0 -> attention replicated
    # across the whole TP axis (memory term 4x compute)
    "llava_train": ("llava-next-34b", "train_4k", [
        ("baseline (replicated attention)", {}),
        ("pad heads 56->64 for TP", {"overrides": {"pad_heads_to": 64}}),
        ("+ remat dots", {"overrides": {"pad_heads_to": 64}, "remat": "dots"}),
        ("+ q_block 1024", {"overrides": {"pad_heads_to": 64,
                                          "attn_q_block": 1024}}),
    ]),
    # most representative of the paper's technique (pure DP gradient
    # aggregation dominates): the 104B dense model
    "commandr_train": ("command-r-plus-104b", "train_4k", [
        ("baseline (pjit engine)", {}),
        ("paper-faithful mapreduce engine", {"engine": "mapreduce"}),
        ("remat dots (cut recompute ARs)", {"remat": "dots"}),
        ("q_block 1024", {"overrides": {"attn_q_block": 1024}}),
        ("loss_chunk 2048 (fewer CE psums)", {"overrides": {
            "loss_chunk": 2048}}),
        ("seq-parallel residuals (SP)", {"overrides": {"seq_parallel": True}}),
        ("SP + remat dots", {"remat": "dots", "overrides": {
            "seq_parallel": True}}),
        ("SP + dots + loss_chunk 2048", {"remat": "dots", "overrides": {
            "seq_parallel": True, "loss_chunk": 2048}}),
    ]),
    # MoE EP dispatch
    "deepseek_train": ("deepseek-v2-236b", "train_4k", [
        ("baseline", {}),
        ("capacity factor 1.0", {"overrides": {"capacity_factor": 1.0}}),
    ]),
}


# what a traced variant's count must differ from the baseline's in
TRACED = ("traced_flops_per_device", "bytes", "eager_bytes", "n_ops",
          "live_bytes_per_device", "collectives")


def fmt(rec):
    if rec["status"] != "ok":
        return f"{rec['status']}: {rec.get('reason', rec.get('error', ''))}"
    r = rec["roofline"]
    rf = rec.get("roofline_flash", {})
    return (f"compute={r['compute_s'] * 1e3:.4g}ms "
            f"memory={r['memory_s'] * 1e3:.4g}ms "
            f"coll={r['collective_s'] * 1e3:.4g}ms dom={r['dominant']} "
            f"useful={rec['useful_flops_ratio']:.3f} "
            f"| flash-mem={rf.get('memory_s', float('nan')) * 1e3:.4g}ms")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, choices=sorted(EXPERIMENTS))
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's CPU-size config (configs.reduced)")
    ap.add_argument("--out", default="experiments/hillclimb_torch")
    args = ap.parse_args(argv)

    arch, shape, variants = EXPERIMENTS[args.cell]
    os.makedirs(args.out, exist_ok=True)
    results = []
    for label, kw in variants:
        rec = dryrun_cell(arch, shape, multi_pod=args.multipod, verbose=False,
                          reduced=args.reduced, **kw)
        rec["label"] = label
        if results and rec["status"] == "ok" and all(
                rec[k] == results[0][k] for k in TRACED):
            rec = {**rec, "status": "skip",
                   "reason": "traced the baseline's step: its count is "
                             "the baseline's in every term"}
        results.append(rec)
        print(f"[{args.cell}] {label:42s} {fmt(rec)}", flush=True)
        with open(os.path.join(args.out, f"{args.cell}.json"), "w") as f:
            json.dump(results, f, indent=1)
    bounds = [r["roofline"]["step_lower_bound_s"] for r in results
              if r["status"] == "ok"]           # the baseline always traces
    base, best = bounds[0], min(bounds)
    print(f"[{args.cell}] step lower bound: {base * 1e3:.4g}ms -> "
          f"{best * 1e3:.4g}ms "
          f"({base / best:.2f}x) over {len(bounds)} traced of "
          f"{len(results)} variants")
    return results


if __name__ == "__main__":
    main()
