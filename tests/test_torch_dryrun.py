"""The port's dry-run and roofline tooling against the JAX package's
(``repro_torch.launch.{analysis,op_cost,dryrun,sweep,roofline}``,
``core.mapreduce.reduce_plan``, ``experiments/hillclimb_torch.py``).

* ``model_flops`` and ``attn_score_traffic`` (copies) equal JAX's for
  every arch x shape, the latter on several meshes; ``roofline`` equals
  JAX's once JAX's constants are patched to the H100's (the collective
  term over the one link JAX knows).
* The op counter on a reduced qwen2-0.5b train step (B 2, S 64): its
  product FLOPs equal the analytic GEMM count exactly (3 x the forward's:
  every product's operands need gradients), and its total FLOPs lie
  within 1 % of ``hlo_cost.module_cost`` on JAX's compiled step of the
  same reduced config (measured 0.99903: XLA and eager attention spend a
  few elementwise ops differently); ``peak_live_bytes`` on hand-counted
  toys, with a view, an in-place op and a tensor autograd saves.
* ``reduce_plan`` equals the collectives gloo steps issue (recorded by
  wrapping ``torch.distributed``'s calls in the workers): world size 2
  for ``allreduce``, 2 x 2 for ``hierarchical`` and ``compressed``.
* ``dryrun_cell`` on every family's reduced config gives ``ok`` for a
  train, prefill and decode cell with every tensor on ``meta``; a
  ``model`` > 1 mesh plans memory and skips (no tensor-parallel step);
  ``long_500k`` gives JAX's skip; a setting that leaves the step
  unchanged skips (an override the port never reads, ``remat``,
  ``unroll``, ``engine``).  ``roofline_min`` counts the model FLOPs and a
  step's least bytes (weights, cache, AdamW state) by hand.
* The sweep resumes from its cache, and ``figures --only roofline``
  prints one row a cell.  The hillclimb reports no variant that traces
  the baseline's step (``qwen_train``, ``commandr_train``).
"""
import json
import os
import shutil
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest

from _torch_common import one_thread  # noqa: F401

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.launch.analysis as j_analysis  # noqa: E402
from repro.configs import ARCHS as J_ARCHS, SHAPES as J_SHAPES  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.launch import hlo_cost  # noqa: E402
from repro.launch.mesh import make_host_mesh as j_host_mesh  # noqa: E402
from repro.models.steps import abstract_train_args as j_train_args  # noqa: E402
from repro.models.steps import make_train_step as j_train_step  # noqa: E402
from repro.optim import OptConfig as JOpt  # noqa: E402
from repro_torch.configs import (ARCHS, SHAPES, ShapeConfig,  # noqa: E402
                                 get_arch, reduced)
from repro_torch.core.mapreduce import reduce_plan  # noqa: E402
from repro_torch.launch import analysis, mesh as t_mesh, op_cost  # noqa: E402
from repro_torch.launch import figures, sweep  # noqa: E402
from repro_torch.launch.dryrun import NO_TP, dryrun_cell  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.models.shardings import MeshSpec  # noqa: E402
from repro_torch.models.steps import (abstract_train_args,  # noqa: E402
                                      make_train_step)
from repro_torch.optim import OptConfig  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
HLO_TOL = 0.01            # op_cost's FLOPs vs hlo_cost's, relative
TINY = ShapeConfig("tiny_train", "train", 64, 2)


# ----------------------------------------------- the framework-free copies

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_flops_and_score_traffic_equal_jax(arch):
    for name in SHAPES:
        t, j = get_arch(arch), J_ARCHS[arch]
        assert analysis.model_flops(t, SHAPES[name]) \
            == j_analysis.model_flops(j, J_SHAPES[name])
        for axes in ({"data": 256}, {"pod": 2, "data": 256},
                     {"data": 16, "model": 16}, {"data": 32, "model": 8}):
            assert analysis.attn_score_traffic(t, SHAPES[name], axes) \
                == j_analysis.attn_score_traffic(j, J_SHAPES[name], axes)


def test_roofline_equals_jax_on_h100_constants(monkeypatch):
    monkeypatch.setattr(j_analysis, "PEAK_FLOPS_BF16", t_mesh.PEAK_FLOPS_BF16)
    monkeypatch.setattr(j_analysis, "HBM_BW", t_mesh.HBM_BW)
    for link, bw in (("nvlink", t_mesh.NVLINK_BW), ("net", t_mesh.NET_BW)):
        monkeypatch.setattr(j_analysis, "ICI_BW", bw)
        for fl, by, wire in ((2.537e13, 1.8e11, 0.0), (1e12, 5e12, 3e9),
                             (1e15, 1e9, 4e13), (0.0, 0.0, 0.0)):
            assert analysis.roofline(fl, by, {link: wire}) \
                == j_analysis.roofline(fl, by, wire)
    two = analysis.roofline(0.0, 0.0, {"nvlink": 4.5e11, "net": 5e10})
    assert two["collective_s"] == 2.0 and two["dominant"] == "collective"


# ----------------------------------------------------------- the op counter

def test_op_counter_against_gemm_count_and_hlo_cost():
    B, S = 2, 64
    cfg = reduced(get_arch("qwen2-0.5b"))
    opt = OptConfig()
    cost = op_cost.step_cost(make_train_step(cfg, opt),
                             *abstract_train_args(cfg, TINY, t_mesh.make_host_mesh(), opt))
    assert cost.devices == {"meta"}
    T, d, hd = B * S, cfg.d_model, cfg.head_dim_
    H, K, L = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
    proj = 2 * T * d * (2 * H * hd + 2 * K * hd)        # q, o and k, v
    mlp = 2 * T * d * cfg.d_ff * 3                      # gate, up, down
    scores = 2 * 2 * B * H * S * S * hd                 # QK^T and PV
    logits = 2 * T * d * cfg.vocab_padded               # tied embedding
    assert cost.product_flops == 3 * (L * (proj + mlp + scores) + logits)

    jcfg = j_reduced(J_ARCHS["qwen2-0.5b"])
    mesh = j_host_mesh()
    args = j_train_args(jcfg, JShape("t", "train", S, B), mesh, JOpt())
    with jax.sharding.set_mesh(mesh):
        hlo = jax.jit(j_train_step(jcfg, mesh, JOpt())).lower(
            *args).compile().as_text()
    ratio = cost.flops / hlo_cost.module_cost(hlo).flops
    assert abs(ratio - 1.0) <= HLO_TOL, ratio


def test_peak_live_bytes_on_hand_counted_toys():
    n = 256 * 256 * 4                                   # one [256, 256] fp32

    def fn(x):
        y = x @ x                                       # + n
        v = y.t()                                       # a view: + 0
        z = v + 1                                       # + n
        z.add_(1)                                       # in place: + 0
        del y, v                                        # - n
        w = torch.cat([z, z])                           # + 2n
        return w.sum()                                  # + 4

    x = torch.empty(256, 256, device="meta")
    c = op_cost.step_cost(fn, x)
    assert c.peak_live_bytes == n + n + 2 * n + 4       # x, z, w, the sum
    assert c.n_ops == 5                                 # mm, add, add_, cat, sum
    assert c.bytes == 3 * n + 2 * (2 * n) + 2 * 4       # mm in + out, cat, sum

    def saved(w):
        h = w @ w                                       # saved by sin
        a = h.sin()
        del h
        return a

    w = torch.empty(256, 256, device="meta", requires_grad=True)
    assert op_cost.step_cost(saved, w).peak_live_bytes == 3 * n


# --------------------------------------------------------- the collectives

WORKER = textwrap.dedent("""
    import datetime, json, sys
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_arch, reduced
    from repro_torch.core.mapreduce import dp_groups
    from repro_torch.models.registry import init_params
    from repro_torch.models.steps import make_train_step
    from repro_torch.optim import OptConfig, init_opt_state

    rank, world, store, n_pod = sys.argv[1:5]
    rank, world, n_pod = int(rank), int(world), int(n_pod)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    groups = dp_groups(n_pod)
    calls = []
    real = {"all_reduce": dist.all_reduce, "all_gather": dist.all_gather}

    def all_reduce(t, op=dist.ReduceOp.SUM, group=None, **kw):
        calls.append(["all_reduce", t.numel() * t.element_size(),
                      dist.get_world_size(group)])
        return real["all_reduce"](t, op=op, group=group, **kw)

    def all_gather(out, t, group=None, **kw):
        calls.append(["all_gather", sum(o.numel() * o.element_size()
                                        for o in out),
                      dist.get_world_size(group)])
        return real["all_gather"](out, t, group=group, **kw)

    dist.all_reduce, dist.all_gather = all_reduce, all_gather
    cfg = reduced(get_arch("qwen2-0.5b"))
    opt = OptConfig()
    params = init_params(cfg, 0, "cpu")
    state = init_opt_state(params, opt)
    tokens = torch.randint(1, cfg.vocab, (2, 16), generator=torch.Generator().manual_seed(rank))
    out = {}
    for mode in sys.argv[5].split(","):
        calls.clear()
        step = make_train_step(cfg, opt, engine="mapreduce", reduce_mode=mode,
                               groups=groups)
        step(params, state, {"tokens": tokens})
        out[mode] = list(calls)
    dist.barrier()
    print("RESULT" + json.dumps(out))
""")


def run_workers(world: int, n_pod: int, modes: str) -> list:
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env["GLOO_SOCKET_IFNAME"] = "lo"
    store = os.path.join(tempfile.mkdtemp(prefix="reduce-plan-"), "store")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(world), store,
         str(n_pod), modes], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env) for r in range(world)]
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=120)
            assert p.returncode == 0, stderr[-2000:]
            line = [x for x in stdout.splitlines()
                    if x.startswith("RESULT")][-1]
            outs.append(json.loads(line[len("RESULT"):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        shutil.rmtree(os.path.dirname(store), ignore_errors=True)
    return outs


@pytest.mark.parametrize("world,n_pod,modes", [
    (2, 1, "allreduce"), (4, 2, "hierarchical,compressed")])
def test_reduce_plan_equals_what_gloo_steps_issue(world, n_pod, modes):
    defs = build_model(reduced(get_arch("qwen2-0.5b"))).param_defs()
    outs = run_workers(world, n_pod, modes)
    for mode in modes.split(","):
        plan = reduce_plan(defs, n_pod, world // n_pod, mode)
        want = [[c["op"], c["bytes"], len(c["groups"][0])] for c in plan]
        for rank_calls in outs:
            assert rank_calls[mode] == want, mode
        assert {analysis.link(c["groups"]) for c in plan} == {"nvlink"}


def test_reduce_plan_links_and_wire_bytes():
    defs = build_model(get_arch("qwen2-0.5b")).param_defs()
    n_bytes = 4 * sum(int(np.prod(d.shape)) for _, d in tree_leaves(defs))
    one = reduce_plan(defs, 1, 256)
    grads = one[:-1]
    assert sum(c["bytes"] for c in grads) == n_bytes
    assert all(analysis.link(c["groups"]) == "net"
               and c["groups"] == [list(range(256))] for c in one)
    assert analysis.collective_summary(grads)["wire_bytes_by_link"] \
        == {"net": pytest.approx(n_bytes * 2 * 255 / 256)}
    # 2 pods of 4: each pod's ranks share a node; across pods they do not
    hier = reduce_plan(defs, 2, 4, "hierarchical")
    links = [analysis.link(c["groups"]) for c in hier]
    assert set(links[:len(grads)]) == {"nvlink"}
    assert set(links[len(grads):]) == {"nvlink"}  # 8 ranks: one node
    wide = reduce_plan(defs, 2, 8, "compressed")
    links = [analysis.link(c["groups"]) for c in wide]
    assert set(links[:len(grads)]) == {"nvlink"}
    assert {c["op"] for c in wide[len(grads):-1]} == {"all_gather"}
    assert set(links[len(grads):-1]) == {"net"}
    assert wide[len(grads)]["groups"][3] == [3, 11]
    summary = analysis.collective_summary(wide)
    assert summary["count"] == len(wide)
    assert summary["ops"]["all_gather"]["wire_bytes"] == pytest.approx(
        summary["ops"]["all_gather"]["bytes"] / 2)
    assert sum(summary["wire_bytes_by_link"].values()) == pytest.approx(
        summary["total_wire_bytes"])
    assert analysis.wire_factor("all_reduce", 1) == 0.0


# ------------------------------------------------------------- the dry run

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_dryrun_every_family_reduced(arch):
    mesh = MeshSpec((2,), ("data",))
    for shape in (TINY, ShapeConfig("tiny_prefill", "prefill", 64, 2),
                  ShapeConfig("tiny_decode", "decode", 64, 2)):
        rec = dryrun_cell(arch, shape, mesh=mesh, reduced=True,
                          verbose=False)
        assert rec["status"] == "ok", rec
        assert rec["device"] == "H100 80GB HBM3 (planned, not measured)"
        assert rec["local_batch"] == 1 and rec["mesh"] == "2"
        assert rec["traced_flops_per_device"] >= rec[
            "product_flops_per_device"] > 0
        assert rec["eager_bytes"] >= rec["bytes"] > 0
        assert rec["live_bytes_per_device"] > rec["params_bytes_per_device"]
        assert 0 < rec["roofline"]["step_lower_bound_s"]
        assert rec["roofline_flash"]["memory_s"] <= rec["roofline"]["memory_s"]
        # the MapReduce reduce of a train step: a leaf's all-reduce each
        # and the loss's, over both processes
        n_leaves = len(list(tree_leaves(
            build_model(reduced(get_arch(arch))).param_defs())))
        assert rec["collectives"]["count"] == (
            n_leaves + 1 if shape.kind == "train" else 0)
    assert not torch.cuda.is_initialized()


def test_dryrun_skips_tensor_parallel_long_500k_and_unread_overrides():
    rec = dryrun_cell("deepseek-v2-236b", "train_4k", verbose=False,
                      mesh=MeshSpec((16, 16), ("data", "model")))
    assert rec["status"] == "skip" and rec["reason"] == NO_TP
    assert round(rec["params_bytes_per_device"] / 1e9, 1) == 30.9
    assert rec["fits_80GB"] is False
    prod = dryrun_cell("deepseek-v2-236b", "decode_32k", verbose=False,
                       multi_pod=True, overrides={"pad_heads_to": 16})
    assert prod["status"] == "skip" and "pad_heads_to" in prod["reason"]
    rec = dryrun_cell("qwen2-0.5b", "long_500k", verbose=False)
    from repro.configs import supports as j_supports
    want = j_supports(J_ARCHS["qwen2-0.5b"], J_SHAPES["long_500k"])[1]
    assert rec == {"arch": "qwen2-0.5b", "shape": "long_500k", "mesh": "256",
                   "status": "skip", "reason": want}
    for kw, word in (({"remat": "dots"}, "remat"),
                     ({"unroll": True}, "unroll"),
                     ({"engine": "mapreduce"}, "one engine")):
        rec = dryrun_cell("qwen2-0.5b", TINY, reduced=True, verbose=False,
                          **kw)
        assert rec["status"] == "skip" and word in rec["reason"], kw


def test_least_bound_counts_weights_cache_and_state():
    """``roofline_min``: the model FLOPs over the bf16 peak, and the
    bytes a step must move at least over ``HBM_BW``: a decode step's
    weights, cache and tokens read once; a train step's tokens read and
    its parameters and AdamW state read and written once.  Below the
    traced reference path's bound in both."""
    from repro_torch.models.params import param_bytes
    from repro_torch.optim import opt_state_defs
    from repro_torch.models.steps import whole_state
    cfg = get_arch("qwen2-0.5b")
    model = build_model(cfg)
    p = param_bytes(model.param_defs())
    mesh = t_mesh.make_host_mesh()
    dec = dryrun_cell("qwen2-0.5b", ShapeConfig("d", "decode", 1056, 8),
                      mesh=mesh, verbose=False)
    cache = param_bytes(model.cache_defs(8, 1056))
    assert dec["min_bytes_per_device"] == p + cache + 8 * 4
    tr = dryrun_cell("qwen2-0.5b", ShapeConfig("t", "train", 1024, 8),
                     mesh=mesh, verbose=False)
    o = param_bytes(whole_state(opt_state_defs(model.param_defs(),
                                               OptConfig())))
    assert tr["min_bytes_per_device"] == 8 * 1024 * 4 + 2 * (p + o)
    for rec in (dec, tr):
        least = rec["roofline_min"]
        assert least["compute_s"] == pytest.approx(
            rec["model_flops_global"] / t_mesh.PEAK_FLOPS_BF16)
        assert least["memory_s"] == pytest.approx(
            rec["min_bytes_per_device"] / t_mesh.HBM_BW)
        assert least["step_lower_bound_s"] \
            < rec["roofline"]["step_lower_bound_s"]
    assert tr["roofline_min"]["dominant"] == "compute"
    assert dec["roofline_min"]["dominant"] == "memory"


def test_sweep_resumes_and_figures_print_the_roofline(tmp_path, capsys):
    out = str(tmp_path / "dryrun")
    os.makedirs(out)
    rec = dryrun_cell("qwen2-0.5b", "decode_32k", verbose=False)
    with open(os.path.join(out, "qwen2-0.5b__decode_32k__256.json"), "w") as f:
        json.dump(rec, f)
    argv = ["--out", out, "--arch", "qwen2-0.5b", "--shape", "decode_32k"]
    sweep.main(argv)                       # one cell cached, one run
    first = capsys.readouterr().out
    assert "[sweep] cached qwen2-0.5b decode_32k 256: ok" in first
    assert "2x256    -> ok" in first
    sweep.main(argv)                       # both cached now
    second = capsys.readouterr().out
    assert second.count("[sweep] cached") == 2 and "->" not in second
    figures.main(["--only", "roofline", "--device", "cpu",
                  "--dryrun-dir", out])
    text = capsys.readouterr().out
    rows = [x for x in text.splitlines() if x.startswith("| qwen2-0.5b")]
    assert len(rows) == 2 and all("| ok |" in r for r in rows)
    assert text.count("roofline,qwen2-0.5b,decode_32k,") == 2


def test_hillclimb_skips_what_the_port_never_reads(tmp_path, capsys):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "hillclimb_torch", os.path.join(ROOT, "experiments",
                                        "hillclimb_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    recs = mod.main(["--cell", "qwen_train", "--out", str(tmp_path)])
    assert [r["status"] for r in recs] == ["ok", "skip", "skip", "skip"]
    assert all("pad_heads_to" in r["reason"] for r in recs[1:])
    assert "over 1 traced of 4 variants" in capsys.readouterr().out
    # the paper's own cell: no variant is a relabelled baseline
    recs = mod.main(["--cell", "commandr_train", "--reduced",
                     "--out", str(tmp_path)])
    assert [r["status"] for r in recs] == [
        "ok", "skip", "skip", "ok", "ok", "skip", "skip", "skip"]
    assert "one engine" in recs[1]["reason"]
    assert "remat" in recs[2]["reason"]
    assert all("seq_parallel" in r["reason"] for r in recs[5:])
    for r in recs[3:5]:                  # q_block, loss_chunk: new counts
        assert any(r[k] != recs[0][k] for k in mod.TRACED), r["label"]
    assert "over 3 traced of 8 variants" in capsys.readouterr().out
