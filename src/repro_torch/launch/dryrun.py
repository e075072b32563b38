"""Dry run: trace every (arch x shape) cell's step on ``meta`` stand-ins
(zero allocation, no device) on the port's layouts, and record the memory
plan, the op-by-op cost, the collectives and the roofline on the H100's
constants: the counterpart of ``repro.launch.dryrun``.

The JAX package lowers and compiles each cell on 256 or 512 TPU devices
and reads XLA's analyses; the port runs its eager step once under
``launch/op_cost.py`` at one device's local shape (the batch split over
the mesh's ``pod`` x ``data`` axes where it divides, as
``models.shardings.resolve`` assigns it) and lists the MapReduce reduce
with ``core.mapreduce.reduce_plan``.  Attention traces through the
``reference`` backend, as JAX's dry run compiles XLA attention;
``roofline_flash`` takes out the score traffic K2, K4 and K9 keep on chip
(``analysis.attn_score_traffic``).  Nothing here allocates on a device or
calls CUDA: a record is a plan for the card, not a measurement.

The port's only multi-process layout is data parallelism, so its
production meshes are ``256`` and ``2x256`` (``launch/mesh.py``).  On a
mesh with a ``model`` axis > 1 a cell plans memory under the sharding
rules, then records ``skip``: the port has no tensor-parallel step.  A
setting that would trace an unchanged step records ``skip`` too, with its
reason: a config override the port's models never read, ``remat`` (the
port keeps every activation), ``unroll`` (eager dispatch visits every
layer anyway) and ``engine`` (the port has one engine, the MapReduce step,
which every cell traces).

Two bounds are recorded.  ``roofline`` is the traced reference path's
under ``hlo_cost``'s byte rule (``op_cost``: index writes and gathers
charged their whole input, reference score chunks in fp32), not the path
the card runs with the hopper kernels; ``roofline_min`` is the least the
step could take: the model FLOPs over the bf16 peak, and over ``HBM_BW``
the bytes it must move at least (``min_bytes``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out experiments/dryrun_torch
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --reduced   # CPU-size configs
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import functools
import json
import math
import os
import time
import traceback
from pathlib import Path

from ..configs import ARCHS, SHAPES, ShapeConfig, get_arch, get_shape, supports
from ..configs import reduced as reduced_config
from ..core.mapreduce import reduce_plan
from ..models.params import param_bytes, sharded_bytes, tree_leaves
from ..models.registry import build_model, cache_defs_with_pos, input_defs
from ..models.shardings import MeshSpec, dp_axes
from ..models.steps import (abstract_serve_args, abstract_train_args,
                            make_serve_step, make_train_step, whole_state)
from ..optim import OptConfig, opt_state_defs
from . import analysis, op_cost
from .mesh import HBM_BYTES, make_production_mesh, mesh_name

DEVICE = "H100 80GB HBM3 (planned, not measured)"
NO_TP = ("the port has no tensor-parallel step: its only multi-process "
         "layout is MapReduce data parallelism over pod x data")


@functools.lru_cache(maxsize=None)
def read_fields() -> frozenset:
    """Every attribute name the port's model code reads (``x.name``)."""
    names = set()
    for path in (Path(__file__).resolve().parents[1] / "models").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Attribute):
                names.add(node.attr)
    return frozenset(names)


def unchanged(overrides: dict, remat, unroll, engine) -> list:
    """The settings of a variant that leave the port's step as it is,
    each with its reason."""
    out = [f"{k} (never read by the port's models)"
           for k in sorted(overrides) if k not in read_fields()]
    if remat not in (None, "none"):
        out.append("remat (the port keeps every activation)")
    if unroll:
        out.append("unroll (eager dispatch visits every layer)")
    if engine is not None:
        out.append("engine (the port has one engine: the MapReduce step "
                   "every cell traces)")
    return out


def _dp(mesh: MeshSpec) -> tuple:
    """(n_pod, n_data) of the mesh's data-parallel axes."""
    sizes = mesh.shape
    return sizes.get("pod", 1), sizes.get("data", 1)


def memory_plan(cfg, shape, mesh, opt_cfg) -> dict:
    """The JAX dry run's analytic steady-state bytes a device
    (``repro/launch/dryrun.py``) over the port's defs: parameters under
    the sharding rules, the optimizer state as the port holds it (whole:
    no ZeRO), a bf16 gradient transient, and the residuals of every layer
    for training; parameters and the decode cache for serving."""
    model = build_model(cfg)
    pdefs = model.param_defs()
    p_bytes = sharded_bytes(pdefs, mesh)
    if shape.kind == "train":
        o_bytes = sharded_bytes(whole_state(opt_state_defs(pdefs, opt_cfg)),
                                mesh)
        g_bytes = p_bytes
        dp = math.prod(mesh.shape[a] for a in dp_axes(mesh))
        n_layers = (cfg.n_layers if not cfg.enc_dec
                    else cfg.n_enc_layers + cfg.n_dec_layers)
        resid = (n_layers * (shape.global_batch // dp) * shape.seq_len
                 * cfg.d_model * 2)
        analytic = p_bytes + o_bytes + g_bytes + resid
    else:
        o_bytes = 0
        c_bytes = (sharded_bytes(cache_defs_with_pos(
            cfg, shape.global_batch, shape.seq_len), mesh)
            if shape.kind == "decode" else 0)
        analytic = p_bytes + c_bytes
    return {"analytic_bytes_per_device": analytic,
            "params_bytes_per_device": p_bytes,
            "opt_bytes_per_device": o_bytes,
            "min_bytes_per_device": min_bytes(cfg, shape, mesh, p_bytes,
                                              o_bytes),
            "fits_80GB": bool(analytic < HBM_BYTES)}


def min_bytes(cfg, shape, mesh, p_bytes, o_bytes) -> float:
    """The bytes a device's step must move at least, each once: the
    inputs read; for training every parameter and optimizer state read
    and written (AdamW updates them all); for serving the parameters read
    (a MoE's routed experts at ``top_k`` of them: a batch may route every
    token alike) and, for decode, the cache read (a decode cell's context
    fills it)."""
    inputs = sharded_bytes(input_defs(cfg, shape), mesh)
    if shape.kind == "train":
        return inputs + 2 * (p_bytes + o_bytes)
    if cfg.is_moe:
        p_bytes *= cfg.param_count(active_only=True) / cfg.param_count()
    cache = (sharded_bytes(build_model(cfg).cache_defs(
        shape.global_batch, shape.seq_len), mesh)
        if shape.kind == "decode" else 0)
    return inputs + p_bytes + cache


def dryrun_cell(arch_name: str, shape_name, *, multi_pod: bool = False,
                opt_name: str = "adamw", remat: str = None,
                unroll: bool = False, overrides: dict = None,
                engine: str = None, reduce_mode: str = "allreduce",
                verbose: bool = True, mesh: MeshSpec = None,
                reduced: bool = False) -> dict:
    """One cell's record.  JAX's signature, plus ``mesh`` (plan on this
    mesh instead of the production one), ``reduced`` (the arch's CPU-size
    config) and a ``ShapeConfig`` accepted for ``shape_name``.  A cell
    traces the port's one engine, the MapReduce step: on a mesh of more
    than one process its collectives are ``reduce_plan(...,
    reduce_mode)``'s.  ``remat``, ``unroll``, ``engine`` and an override
    no model reads record ``skip`` (``unchanged``)."""
    overrides = dict(overrides or {})
    cfg = get_arch(arch_name)
    if reduced:
        cfg = reduced_config(cfg)
    shape = shape_name if isinstance(shape_name, ShapeConfig) \
        else get_shape(shape_name)
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    head = {"arch": arch_name, "shape": shape.name, "mesh": mesh_name(mesh)}
    ok, why = supports(cfg, shape)
    if not ok:
        return {**head, "status": "skip", "reason": why}
    same = unchanged(overrides, remat, unroll, engine)
    if same:
        return {**head, "status": "skip",
                "reason": f"leaves the port's step unchanged: "
                          f"{'; '.join(same)}"}
    cfg = dataclasses.replace(cfg, **overrides)
    opt_cfg = OptConfig(name=opt_name)
    n_chips = mesh.size
    plan = memory_plan(cfg, shape, mesh, opt_cfg)
    if mesh.shape.get("model", 1) > 1:
        return {**head, "n_chips": n_chips, "status": "skip",
                "reason": NO_TP, "device": DEVICE, **plan}

    t0 = time.perf_counter()
    if shape.kind == "train":
        step = make_train_step(cfg, opt_cfg, attn_backend="reference")
        args = abstract_train_args(cfg, shape, mesh, opt_cfg)
    else:
        step = make_serve_step(cfg, shape.kind, attn_backend="reference")
        args = abstract_serve_args(cfg, shape, mesh)
    local_batch = next(tree_leaves(args[-1]))[1].shape[0]
    cost = op_cost.step_cost(step, *args)
    t_trace = time.perf_counter() - t0
    if cost.devices != {"meta"}:
        raise RuntimeError(f"the trace touched {sorted(cost.devices)}")

    n_pod, n_data = _dp(mesh)
    colls = []
    if shape.kind == "train" and n_pod * n_data > 1:
        colls = reduce_plan(build_model(cfg).param_defs(), n_pod, n_data,
                            reduce_mode)
    summary = analysis.collective_summary(colls)
    wire = summary["wire_bytes_by_link"]
    roof = analysis.roofline(cost.flops, cost.bytes, wire)
    score = analysis.attn_score_traffic(cfg, shape, mesh.shape)
    roof_flash = analysis.roofline(
        cost.flops, max(cost.bytes - score, cost.flops / 500.0), wire)
    mflops = analysis.model_flops(cfg, shape)
    roof_min = analysis.roofline(mflops / n_chips,
                                 plan["min_bytes_per_device"], wire)
    rec = {
        **head, "n_chips": n_chips, "status": "ok", "device": DEVICE,
        "engine": "mapreduce",
        "reduce_mode": reduce_mode if colls else None,
        "local_batch": local_batch, "trace_s": round(t_trace, 2),
        "live_bytes_per_device": cost.peak_live_bytes,
        **plan,
        "traced_flops_per_device": cost.flops,
        "product_flops_per_device": cost.product_flops,
        "bytes": cost.bytes, "eager_bytes": cost.eager_bytes,
        "n_ops": cost.n_ops,
        "collectives": summary,
        "roofline": roof,
        "attn_score_bytes_per_device": score,
        "roofline_flash": roof_flash,
        "roofline_min": roof_min,
        "model_flops_global": mflops,
        "model_flops_per_device": mflops / n_chips,
        "useful_flops_ratio": ((mflops / n_chips) / cost.flops
                               if cost.flops else 0.0),
    }
    if verbose:
        print(json.dumps({k: rec[k] for k in
                          ("arch", "shape", "mesh", "status", "trace_s",
                           "analytic_bytes_per_device", "fits_80GB")}))
        print(f"  live bytes/dev {cost.peak_live_bytes:.4e}, params "
              f"{param_bytes(build_model(cfg).param_defs()):.4e} B")
        print(f"  cost: flops/dev {cost.flops:.4e} bytes/dev {cost.bytes:.4e}"
              f" eager bytes/dev {cost.eager_bytes:.4e} ops {cost.n_ops}")
        print("  collectives:", json.dumps(summary["ops"]))
        print("  roofline (reference path, hlo_cost's byte rule):",
              json.dumps(roof))
        print("  roofline_min (model FLOPs, least bytes):",
              json.dumps(roof_min))
        print(f"  useful_flops_ratio: {rec['useful_flops_ratio']:.3f}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--opt", default="adamw")
    ap.add_argument("--remat", default=None)
    ap.add_argument("--unroll", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="each arch's CPU-size config (configs.reduced)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = sorted(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) \
        else [args.multipod]

    results = []
    for a in archs:
        for s in shapes:
            for mp in meshes:
                try:
                    rec = dryrun_cell(a, s, multi_pod=mp, opt_name=args.opt,
                                      remat=args.remat, unroll=args.unroll,
                                      reduced=args.reduced)
                except Exception as e:  # a failed cell is a bug: record it
                    traceback.print_exc()
                    rec = {"arch": a, "shape": s,
                           "mesh": mesh_name(make_production_mesh(
                               multi_pod=mp)),
                           "status": "error",
                           "error": f"{type(e).__name__}: {e}"}
                results.append(rec)
                if rec["status"] == "skip":
                    print(f"{a} {s} {rec['mesh']}: skip ({rec['reason']})")
                if args.out:
                    os.makedirs(args.out, exist_ok=True)
                    fn = os.path.join(args.out,
                                      f"{a}__{s}__{rec['mesh']}.json")
                    with open(fn, "w") as f:
                        json.dump(rec, f, indent=1)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skip" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\n== dry-run: {n_ok} ok, {n_skip} skip, {n_err} error "
          f"of {len(results)} cells ==")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
