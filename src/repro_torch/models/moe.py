"""Mixture-of-Experts with token-choice top-k routing and per-expert
capacity: the port of ``repro.models.moe``, single device (no expert
sharding).

Dispatch is gather-based, as in the JAX package: for each (group, expert)
the top-C tokens by gate probability are gathered into a dense ``[G, E, C,
D]`` buffer (C = capacity), run through the expert matmuls, weighted by
their gate and added back to their tokens.  Tokens over capacity are
dropped, lowest gate first; a group's padding tokens route and take
capacity like any other.

Two orders are spelled out where PyTorch leaves them open.  ``jax.lax
.top_k`` breaks ties toward the lower index, ``torch.topk`` promises
nothing: both top-k selections here are a stable descending sort.  The JAX
scatter-add back into the tokens runs over the gathered slots expert by
expert; here each token sums its (at most ``top_k``) expert outputs in
ascending expert order, a gather instead of an ``index_add_`` (whose CUDA
atomics add in no fixed order), so the sum rounds the same way on every
run and device.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..configs.base import ArchConfig, round_up
from .attention import softmax
from .layers import act_fn
from .params import ParamDef


def moe_defs(cfg: ArchConfig):
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    defs = {
        "router": ParamDef((d, e), ("embed", None), dtype=torch.float32),
        "up": ParamDef((e, d, f), ("experts", "embed", "ff")),
        "down": ParamDef((e, f, d), ("experts", "ff", "embed")),
    }
    if cfg.mlp_gated:
        defs["gate"] = ParamDef((e, d, f), ("experts", "embed", "ff"))
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * f
        defs["shared_up"] = ParamDef((d, fs), ("embed", "ff"))
        defs["shared_down"] = ParamDef((fs, d), ("ff", "embed"))
        if cfg.mlp_gated:
            defs["shared_gate"] = ParamDef((d, fs), ("embed", "ff"))
    return defs


def capacity(cfg: ArchConfig, tokens_per_group: int) -> int:
    c = math.ceil(tokens_per_group * cfg.top_k / cfg.n_experts
                  * cfg.capacity_factor)
    return min(tokens_per_group, max(8, round_up(c, 8)))


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values, ties
    broken toward the lower index (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(cfg: ArchConfig, p, x, *,
              cap: Optional[int] = None) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """x: [G, S, D] (groups route independently).  Returns (out, aux_loss).

    ``cap`` overrides the expert capacity; ``cap == S`` guarantees no token
    is ever dropped, making each token's output independent of its
    co-batched neighbours."""
    G, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = capacity(cfg, S) if cap is None else cap
    act = act_fn(cfg.act)

    logits = x.float() @ p["router"]                              # [G,S,E]
    probs = softmax(logits)
    top_p, top_i = top_k(probs, K)                                 # [G,S,K]
    top_p = top_p / top_p.sum(-1, keepdim=True)
    gates = torch.zeros((G, S, E), dtype=torch.float32, device=x.device)
    gates.scatter_(2, top_i, top_p)          # top-k indices are distinct

    # per-expert top-C tokens by gate (capacity with lowest-gate dropping)
    vals, idx = top_k(gates.transpose(1, 2), C)                    # [G,E,C]
    keep = vals > 0.0
    g_ix = torch.arange(G, device=x.device)[:, None]
    xe = x[g_ix[..., None], idx]                                   # [G,E,C,D]
    if cfg.mlp_gated:
        h = act(torch.einsum("gecd,edf->gecf", xe, p["gate"])) \
            * torch.einsum("gecd,edf->gecf", xe, p["up"])
    else:
        h = act(torch.einsum("gecd,edf->gecf", xe, p["up"]))
    ye = torch.einsum("gecf,efd->gecd", h, p["down"])
    ye = ye * (vals * keep)[..., None].to(ye.dtype)

    # back to the tokens: slot[g, s, e] = where token s sits in expert e's
    # buffer (C when it was not gathered); each token adds its routed
    # experts' outputs in ascending expert order
    slot = torch.full((G, E, S), C, dtype=torch.long, device=x.device)
    slot.scatter_(2, idx, torch.arange(C, device=x.device).expand(G, E, C))
    slot = slot.transpose(1, 2)                                    # [G,S,E]
    ye_pad = torch.cat([ye, ye.new_zeros(G, E, 1, D)], 2)   # [G,E,C+1,D]
    experts = top_i.sort(-1).values                                # [G,S,K]
    out = torch.zeros_like(x)
    for k in range(K):
        e = experts[..., k]                                        # [G,S]
        at = torch.gather(slot, 2, e[..., None])[..., 0]          # [G,S]
        out = out + ye_pad[g_ix, e, at]

    if cfg.n_shared_experts:
        if cfg.mlp_gated:
            hs = act(x @ p["shared_gate"]) * (x @ p["shared_up"])
        else:
            hs = act(x @ p["shared_up"])
        out = out + hs @ p["shared_down"]

    # switch-style load-balance auxiliary loss
    frac = (gates > 0.0).float().mean(dim=(0, 1))
    mean_p = probs.mean(dim=(0, 1))
    aux = E * (frac * mean_p).sum()
    return out, aux


def moe_decode_apply(cfg: ArchConfig, p, x) -> torch.Tensor:
    """x: [B, D] single-token batch, routed as one group of B tokens."""
    out, _ = moe_apply(cfg, p, x[None])
    return out[0]
