"""Step analysis: the collective summary and the three-term roofline,
keyed on the H100's constants; the port of ``repro.launch.analysis``.

``launch/op_cost.py`` counts each device's FLOPs and bytes of one step;
``core.mapreduce.reduce_plan`` lists its collectives and the ranks of
their groups, and ``collective_summary`` puts each on its link and counts
its bytes on the wire.  Roofline terms are seconds a device:

    compute    = FLOPs / PEAK_FLOPS_BF16
    memory     = bytes / HBM_BW
    collective = sum over links of wire_bytes / the link's bandwidth
                 (NVLINK_BW inside a node, NET_BW across nodes)

``attn_score_traffic`` and ``model_flops`` are copies of the JAX functions
(framework-free); the JAX package's HLO regexes (``parse_collectives``)
have no counterpart: there is no HLO to parse.
"""
from __future__ import annotations

from typing import Dict, List

from .mesh import GPUS_PER_NODE, HBM_BW, NET_BW, NVLINK_BW, PEAK_FLOPS_BF16

LINK_BW = {"nvlink": NVLINK_BW, "net": NET_BW}


def wire_factor(op: str, n: int) -> float:
    """Ring-algorithm bytes each process sends per byte of the result, in
    a group of ``n``: all-reduce 2(n-1)/n, all-gather (n-1)/n (the JAX
    package's factors)."""
    if n <= 1:
        return 0.0
    return 2.0 * (n - 1) / n if op == "all_reduce" else (n - 1) / n


def link(groups: List[List[int]]) -> str:
    """``nvlink`` when every group's ranks lie on one node
    (``GPUS_PER_NODE`` consecutive ranks a node), else ``net``."""
    one_node = all(len({r // GPUS_PER_NODE for r in g}) == 1 for g in groups)
    return "nvlink" if one_node else "net"


def collective_summary(plan: List[Dict]) -> Dict:
    """Totals of a ``reduce_plan``: by op, by link, and overall; each
    call's wire bytes by ``wire_factor`` on its ``link``."""
    by_op: Dict[str, Dict] = {}
    by_link: Dict[str, float] = {}
    total_wire = 0.0
    for c in plan:
        wire = c["bytes"] * wire_factor(c["op"], len(c["groups"][0]))
        d = by_op.setdefault(c["op"], {"count": 0, "bytes": 0, "wire_bytes": 0.0})
        d["count"] += 1
        d["bytes"] += c["bytes"]
        d["wire_bytes"] += wire
        lk = link(c["groups"])
        by_link[lk] = by_link.get(lk, 0.0) + wire
        total_wire += wire
    return {"ops": by_op,
            "wire_bytes_by_link": by_link,
            "total_bytes": sum(c["bytes"] for c in plan),
            "total_wire_bytes": total_wire,
            "count": len(plan)}


def roofline(flops_per_dev: float, bytes_per_dev: float,
             wire_bytes_by_link: Dict[str, float]) -> Dict:
    compute_s = flops_per_dev / PEAK_FLOPS_BF16
    memory_s = bytes_per_dev / HBM_BW
    coll_s = sum(w / LINK_BW[link] for link, w in wire_bytes_by_link.items())
    terms = {"compute_s": compute_s, "memory_s": memory_s, "collective_s": coll_s}
    dom = max(terms, key=terms.get)
    total = max(terms.values())
    return {**terms, "dominant": dom.replace("_s", ""),
            "step_lower_bound_s": total,
            "compute_fraction": compute_s / total if total else 0.0}


def attn_score_traffic(cfg, shape, mesh_axes: Dict[str, int]) -> float:
    """Per-device HBM bytes attributable to materialized attention-score
    tensors in the XLA (non-flash) attention path.  The Pallas flash kernel
    (kernels/flash_attention) keeps these blocks in VMEM, so the 'with flash'
    roofline subtracts this traffic.  Factors: train ≈ 6 passes over the score
    tensor (fwd write+read, remat re-fwd, bwd dS write+read), prefill ≈ 2.
    """
    if not cfg.n_heads:
        return 0.0
    if shape.kind == "decode":
        return 0.0                      # one q row; negligible and streamed
    S, B = shape.seq_len, shape.global_batch
    model = mesh_axes.get("model", 1)
    dp = 1
    for a in ("pod", "data"):
        dp *= mesh_axes.get(a, 1)
    H = cfg.n_heads
    h_local = H // model if H % model == 0 else H   # non-divisible -> replicated
    b_local = max(1, B // dp)
    L = cfg.n_layers if not cfg.enc_dec else cfg.n_enc_layers + cfg.n_dec_layers
    if cfg.family == "hybrid":
        L = max(1, cfg.n_layers // len(cfg.block_pattern or (1,)))
    win = cfg.attn_window if cfg.family == "hybrid" else cfg.sliding_window
    pairs = (S * min(win, S)) if win else (S * S * 0.5)
    passes = 6.0 if shape.kind == "train" else 2.0
    return passes * 4.0 * b_local * h_local * pairs * L


def model_flops(cfg, shape) -> float:
    """Useful-work FLOPs: 6·N·D for training, 2·N·D for inference forward, with
    the quadratic attention term added explicitly.  MoE counts active params."""
    N = cfg.param_count(active_only=True)
    S, B = shape.seq_len, shape.global_batch
    if shape.kind == "train":
        D = S * B
        base = 6.0 * N * D
        mult = 3.0          # fwd + 2x bwd
    elif shape.kind == "prefill":
        D = S * B
        base = 2.0 * N * D
        mult = 1.0
    else:  # decode: one token per sequence
        D = B
        base = 2.0 * N * D
        mult = 1.0
    attn = 0.0
    if cfg.n_heads and not cfg.use_mla:
        hd = cfg.head_dim_
        H = cfg.n_heads
        L = cfg.n_layers if not cfg.enc_dec else cfg.n_enc_layers + cfg.n_dec_layers
        if shape.kind == "decode":
            ctx = min(S, cfg.attn_window or S) if cfg.family == "hybrid" else S
            attn = 4.0 * B * ctx * H * hd * L * mult
            if cfg.family == "hybrid":
                n_g, tail, n_attn = 0, 0, 0
                attn *= (cfg.n_layers // 3) / cfg.n_layers  # only attn layers
        else:
            causal = 0.5
            win = cfg.attn_window if cfg.family == "hybrid" else (cfg.sliding_window or 0)
            if win:
                ctx_pairs = min(win, S) * S
            else:
                ctx_pairs = S * S * causal
            n_attn_layers = L if cfg.family != "hybrid" else max(1, cfg.n_layers // 3)
            attn = 4.0 * B * ctx_pairs * H * hd * n_attn_layers * mult
    elif cfg.use_mla:
        L = cfg.n_layers
        qk = cfg.nope_head_dim + cfg.rope_head_dim
        H = cfg.n_heads
        if shape.kind == "decode":
            attn = 2.0 * B * S * (cfg.kv_lora_rank + cfg.rope_head_dim) * H * 2
        else:
            attn = 4.0 * B * S * S * 0.5 * H * (qk + cfg.v_head_dim) / 2 * L * \
                (3.0 if shape.kind == "train" else 1.0)
    return base + attn
