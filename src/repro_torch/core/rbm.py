"""Restricted Boltzmann Machine with CD-k — the paper's Algorithm 2/3
mapper/reducer: the port of ``repro.core.rbm``.

Function names follow the paper's pseudo-code (``getposphase``,
``getnegphase``, ``update``).  The mapper computes the CD statistics of its
(micro)batch; the reducer is the cross-process mean delivered by
``core.mapreduce``.  Following Hinton's practical guide: hidden
*probabilities* are used for statistics, hidden *samples* drive the
negative phase, and the reconstruction uses probabilities.

Samples are drawn from an explicit ``torch.Generator`` on the model's
device (the JAX package splits PRNG keys; the two never give the same
bits, so tests feed both the same samples).  The hidden and visible
probabilities are kernel K8 (``kernels.rbm_cd.gemm_sigmoid``): the Hopper
kernel on a CUDA device, its plain version on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..kernels.rbm_cd import gemm_sigmoid
from .mapreduce import DPGroups, map_reduce_job


@dataclasses.dataclass(frozen=True)
class RBMConfig:
    n_vis: int
    n_hid: int
    lr: float = 0.1
    momentum: float = 0.5
    final_momentum: float = 0.9
    momentum_switch: int = 5          # epoch at which momentum increases
    weight_decay: float = 2e-4
    cd_k: int = 1


def rbm_init(gen: torch.Generator, cfg: RBMConfig) -> Dict[str, torch.Tensor]:
    """W ~ 0.1 N(0, 1) drawn from ``gen`` on its device; zero biases."""
    dev = gen.device
    w = 0.1 * torch.randn((cfg.n_vis, cfg.n_hid), generator=gen,
                          dtype=torch.float32, device=dev)
    return {"W": w,
            "bv": torch.zeros((cfg.n_vis,), dtype=torch.float32, device=dev),
            "bh": torch.zeros((cfg.n_hid,), dtype=torch.float32, device=dev)}


def hidden_probs(p, v):
    return gemm_sigmoid(v, p["W"], p["bh"])


def visible_probs(p, h):
    """``W.T`` is a view: K8 reads the weight transposed by index."""
    return gemm_sigmoid(h, p["W"].T, p["bv"])


def _sample(prob, gen: torch.Generator):
    u = torch.rand(prob.shape, generator=gen, dtype=torch.float32,
                   device=prob.device)
    return (u < prob).to(prob.dtype)


def getposphase(p, v, gen: torch.Generator):
    """Positive phase: hidden probabilities + samples for one batch."""
    h_prob = hidden_probs(p, v)
    return h_prob, _sample(h_prob, gen).to(v.dtype)


def getnegphase(p, h_sample, gen: Optional[torch.Generator], cd_k: int = 1):
    """Negative (reconstruction) phase, CD-k: CD-1 draws nothing."""
    h = h_sample
    for i in range(cd_k):
        v_prob = visible_probs(p, h)
        h_prob = hidden_probs(p, v_prob)
        if i < cd_k - 1:
            h = _sample(h_prob, gen).to(v_prob.dtype)
    return v_prob, h_prob


def phase_statistics(v, h_prob, v_neg, h_neg):
    """The CD statistics of one batch from its two phases."""
    B = v.shape[0]
    return {"W": (v.T @ h_prob - v_neg.T @ h_neg) / B,
            "bv": torch.mean(v - v_neg, dim=0),
            "bh": torch.mean(h_prob - h_neg, dim=0),
            "err": torch.mean(torch.square(v - v_neg))}


def cd_statistics(p, v, gen: torch.Generator, cfg: RBMConfig):
    """The mapper: per-batch CD statistics (already combiner-aggregated)."""
    h_prob, h_sample = getposphase(p, v, gen)
    v_neg, h_neg = getnegphase(p, h_sample, gen, cfg.cd_k)
    return phase_statistics(v, h_prob, v_neg, h_neg)


def update(p, vel, stats, cfg: RBMConfig, epoch):
    """Momentum update from reduced statistics (the paper's weight update)."""
    mom = cfg.final_momentum if epoch >= cfg.momentum_switch \
        else cfg.momentum
    new_vel = {
        "W": mom * vel["W"] + cfg.lr * (stats["W"] - cfg.weight_decay * p["W"]),
        "bv": mom * vel["bv"] + cfg.lr * stats["bv"],
        "bh": mom * vel["bh"] + cfg.lr * stats["bh"],
    }
    new_p = {k: p[k] + new_vel[k] for k in p}
    return new_p, new_vel


def make_rbm_step(cfg: RBMConfig, group: Optional[DPGroups] = None):
    """The MapReduce CD step: ``step(params, vel, batch, gen, epoch) ->
    (params, vel, err)``, the statistics averaged over ``group``'s
    processes (local with no group)."""
    job = map_reduce_job(
        lambda pg, batch: cd_statistics(pg[0], batch, pg[1], cfg),
        group, reduce="mean")

    @torch.no_grad()
    def step(p, vel, batch, gen, epoch):
        stats = job((p, gen), batch)
        err = stats.pop("err")
        new_p, new_vel = update(p, vel, stats, cfg, epoch)
        return new_p, new_vel, err

    return step


def free_energy(p, v):
    """RBM free energy (diagnostic; decreasing on train data = learning).
    softplus as ``logaddexp(x, 0)``, jax.nn.softplus's definition."""
    wx = v @ p["W"] + p["bh"]
    return -v @ p["bv"] - torch.sum(torch.logaddexp(wx, torch.zeros_like(wx)),
                                    dim=-1)
