"""Supervised fine-tuning (paper §IV-B): the DBN stack + softmax head
trained with MapReduce back-propagation — the hand-written-digit recognizer
of Figs. 7/9/11.  The port of ``repro.core.finetune``."""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from ..models.params import tree_map
from .mapreduce import DPGroups, mapreduce_value_and_grad, value_and_grad


def classifier_init(stack_params: Sequence[dict], n_classes: int,
                    gen: torch.Generator) -> Dict:
    """Encoder layers initialized from the pre-trained RBM stack (the
    paper's 'well-initialized weights'), plus a fresh softmax head drawn
    from ``gen``."""
    Ws = [p["W"].clone() for p in stack_params]
    bs = [p["bh"].clone() for p in stack_params]
    head = 0.01 * torch.randn((Ws[-1].shape[1], n_classes), generator=gen,
                              dtype=torch.float32, device=gen.device)
    return {"W": Ws, "b": bs, "head_W": head,
            "head_b": torch.zeros((n_classes,), dtype=torch.float32,
                                  device=gen.device)}


def logits_fn(params, v):
    h = v
    for w, b in zip(params["W"], params["b"]):
        h = torch.sigmoid(h @ w + b)
    return h @ params["head_W"] + params["head_b"]


def ce_loss(params, batch):
    lg = logits_fn(params, batch["x"])
    lse = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, batch["y"].long()[:, None])[:, 0]
    loss = torch.mean(lse - gold)
    acc = torch.mean((torch.argmax(lg, -1) == batch["y"]).float())
    return loss, {"acc": acc}


def sgd_momentum(params, vel, grads, lr: float):
    """vel <- 0.9 vel - lr g; params <- params + vel (new trees)."""
    vel = tree_map(lambda v, g: 0.9 * v - lr * g, vel, grads)
    return tree_map(lambda p, v: p + v, params, vel), vel


def make_classifier_step(group: Optional[DPGroups] = None, lr: float = 0.1,
                         reduce_mode: str = "allreduce", n_micro: int = 1):
    """``step(params, vel, batch) -> (params, vel, loss, aux)``: plain
    back-propagation with no group, else through ``core.mapreduce``."""
    if group is None:
        @torch.no_grad()
        def step(params, vel, batch):
            loss, aux, grads = value_and_grad(ce_loss, params, batch)
            params, vel = sgd_momentum(params, vel, grads, lr)
            return params, vel, loss, aux
        return step

    mr = mapreduce_value_and_grad(ce_loss, group, reduce_mode=reduce_mode,
                                  n_micro=n_micro)

    @torch.no_grad()
    def step(params, vel, batch):
        loss, grads, _, aux = mr(params, batch, None)
        params, vel = sgd_momentum(params, vel, grads, lr)
        return params, vel, loss, aux

    return step


@torch.no_grad()
def error_rate(params, X, y, batch: int = 1000) -> float:
    """Misclassification rate (the paper's Fig. 7 metric); X [n, d] and y
    [n] numpy arrays or tensors (on the parameters' device, they stay
    there)."""
    dev = params["head_W"].device
    wrong, n = 0, 0
    for i in range(0, len(X), batch):
        v = torch.as_tensor(X[i:i + batch], dtype=torch.float32, device=dev)
        gold = torch.as_tensor(y[i:i + batch], device=dev)
        pred = torch.argmax(logits_fn(params, v), -1)
        wrong += int((pred != gold).sum())
        n += len(pred)
    return wrong / max(1, n)
