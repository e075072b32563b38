"""AdaBoost precision refinement (paper §IV-C), multiclass SAMME: the port
of ``repro.core.adaboost``.

The paper sketches Adaboosting as the third stage ("get one weak classifier
from part of the training set; get more using different parts ...;
assemble them").  SAMME (the standard multiclass AdaBoost) runs over small
sigmoid-MLP weak learners: each round trains on a weighted resample of the
data, the ensemble votes with log((1-eps)/eps) + log(K-1) weights; with
K=10 classes the weak-learning condition is eps < 0.9 rather than M1's
eps < 0.5.

Draws come from an explicit ``torch.Generator`` on its device (initial
weights, resamples, epoch permutations); the data goes to that device once
and every minibatch is an index into it there.  The resample draws differ
from the JAX package's by design.  The hidden layer is plain torch ops, not
kernel K8: the JAX package computes it outside any Pallas kernel, and the
weak learner needs its gradient.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from .mapreduce import value_and_grad


@dataclasses.dataclass(frozen=True)
class BoostConfig:
    n_rounds: int = 5
    n_hidden: int = 64
    n_classes: int = 10
    epochs: int = 3
    batch_size: int = 100
    lr: float = 0.5
    sample_frac: float = 1.0


def _mlp_init(gen: torch.Generator, n_in, n_hid, n_out):
    """0.1 N(0, 1) weights drawn from ``gen`` on its device, zero biases."""
    dev = gen.device
    w1 = 0.1 * torch.randn((n_in, n_hid), generator=gen, dtype=torch.float32,
                           device=dev)
    w2 = 0.1 * torch.randn((n_hid, n_out), generator=gen,
                           dtype=torch.float32, device=dev)
    return {"W1": w1,
            "b1": torch.zeros((n_hid,), dtype=torch.float32, device=dev),
            "W2": w2,
            "b2": torch.zeros((n_out,), dtype=torch.float32, device=dev)}


def _mlp_logits(p, x):
    h = torch.sigmoid(x @ p["W1"] + p["b1"])
    return h @ p["W2"] + p["b2"]


def _ce_loss(p, batch):
    lg = _mlp_logits(p, batch["x"])
    gold = torch.gather(lg, -1, batch["y"].long()[:, None])[:, 0]
    return torch.mean(torch.logsumexp(lg, dim=-1) - gold), {}


@torch.no_grad()
def _sgd_step(p, x, y, lr):
    """Plain SGD on mean(logsumexp - picked logit): new parameters."""
    _, _, g = value_and_grad(_ce_loss, p, {"x": x, "y": y})
    return {k: p[k] - lr * g[k] for k in p}


def _train_weak(gen: torch.Generator, X, y, cfg: BoostConfig):
    """One weak learner on device tensors X [n, d], y [n]: ``cfg.epochs``
    passes of ``n // batch_size`` minibatches (the tail dropped; one batch
    of all rows if n is below a batch), a fresh permutation an epoch."""
    p = _mlp_init(gen, X.shape[1], cfg.n_hidden, cfg.n_classes)
    n = X.shape[0]
    nb = max(1, n // cfg.batch_size)
    for _ in range(cfg.epochs):
        perm = torch.randperm(n, generator=gen, device=X.device)
        for b in range(nb):
            idx = perm[b * cfg.batch_size:(b + 1) * cfg.batch_size]
            p = _sgd_step(p, X[idx], y[idx], cfg.lr)
    return p


def samme_round(w: torch.Tensor, miss: torch.Tensor,
                n_classes: int) -> Tuple[Optional[float], torch.Tensor]:
    """One SAMME weight update from a learner's misses over the full data.
    ``w``: fp64 weights [n]; ``miss``: [n], true where the learner is
    wrong.  Returns (None, w) when the weighted error ``eps`` fails the
    multiclass condition (eps >= 1 - 1/K: the learner is dropped and
    boosting stops), else (alpha, mistakes up-weighted by exp(alpha) and the
    weights renormalized), eps clamped at 1e-10 first."""
    miss = miss.to(torch.float64)
    eps = float(torch.sum(w * miss) / torch.sum(w))
    if eps >= 1.0 - 1.0 / n_classes:
        return None, w
    eps = max(eps, 1e-10)
    alpha = math.log((1.0 - eps) / eps) + math.log(n_classes - 1.0)
    w = w * torch.exp(alpha * miss)
    return alpha, w / w.sum()


def fit(X, y, cfg: BoostConfig,
        gen: torch.Generator) -> Tuple[List[dict], List[float]]:
    """Returns (weak learners, vote weights alpha); X [n, d] and y [n]
    (numpy or torch) go to ``gen``'s device once."""
    dev = gen.device
    X = torch.as_tensor(X, dtype=torch.float32, device=dev)
    y = torch.as_tensor(y, dtype=torch.int64, device=dev)
    n = X.shape[0]
    w = torch.full((n,), 1.0 / n, dtype=torch.float64, device=dev)
    learners, alphas = [], []
    m = int(cfg.sample_frac * n)
    for _ in range(cfg.n_rounds):
        # weighted resample ("different parts of the training set")
        idx = torch.multinomial(w / w.sum(), m, replacement=True,
                                generator=gen)
        p = _train_weak(gen, X[idx], y[idx], cfg)
        with torch.no_grad():
            miss = torch.argmax(_mlp_logits(p, X), -1) != y
        alpha, w = samme_round(w, miss, cfg.n_classes)
        if alpha is None:
            break
        learners.append(p)
        alphas.append(alpha)
    return learners, alphas


@torch.no_grad()
def predict(learners: List[dict], alphas: List[float], X,
            n_classes: int = 10) -> np.ndarray:
    """The ensemble's class per row: each learner's argmax gets its alpha
    as an fp64 vote; on a tie the first class with the most votes wins."""
    dev = learners[0]["W1"].device if learners else torch.device("cpu")
    X = torch.as_tensor(X, dtype=torch.float32, device=dev)
    votes = torch.zeros((X.shape[0], n_classes), dtype=torch.float64,
                        device=dev)
    rows = torch.arange(X.shape[0], device=dev)
    for p, a in zip(learners, alphas):
        votes[rows, torch.argmax(_mlp_logits(p, X), -1)] += a
    return votes.argmax(-1).cpu().numpy()


def error_rate(learners, alphas, X, y, n_classes: int = 10) -> float:
    return float((predict(learners, alphas, X, n_classes)
                  != np.asarray(y)).mean())
