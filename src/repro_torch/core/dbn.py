"""Deep-belief-network driver — the paper's Algorithm 1
(``DeepLearningDriver``): the port of ``repro.core.dbn``.

Greedy layer-wise loop: for each layer, run ``max_epoch`` epochs of
MapReduce RBM jobs (Algorithms 2/3), then one forward-propagation MapReduce
job (Algorithm 4) whose output becomes the next layer's "data".  The
learned stack unrolls into a deep autoencoder (``core.autoencoder``) or a
classifier (``core.finetune``).  Every hidden and visible probability of
the CD steps and of the forward-propagation job is one call of kernel K8's
wrapper (a launch on a CUDA device): three a CD-1 step, one a layer's
propagation.  ``progressive_stack_lm`` carries the layer-wise idea to the
LM trainer.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import torch

from ..models.params import tree_map
from .mapreduce import DPGroups, map_reduce_job
from .rbm import RBMConfig, hidden_probs, make_rbm_step, rbm_init


@dataclasses.dataclass(frozen=True)
class DBNConfig:
    stack: Sequence[int]              # e.g. (784, 1000, 500, 250, 30)
    max_epoch: int = 10
    batch_size: int = 100
    lr: float = 0.1
    momentum: float = 0.5
    cd_k: int = 1
    weight_decay: float = 2e-4
    log_every: int = 0


def train_dbn(
    data,                             # [N, stack[0]] in [0, 1], numpy or torch
    cfg: DBNConfig,
    gen: torch.Generator,
    group: Optional[DPGroups] = None,
    callback: Optional[Callable] = None,
) -> List[dict]:
    """Algorithm 1 on ``gen``'s device (its draws: initial weights, epoch
    permutations, samples).  Returns the trained RBM stack (a list of
    {"W", "bv", "bh"} tensors)."""
    dev = gen.device
    layer_input = torch.as_tensor(data, dtype=torch.float32, device=dev)
    stack_params: List[dict] = []
    n = layer_input.shape[0]

    for layer in range(len(cfg.stack) - 1):
        rcfg = RBMConfig(n_vis=cfg.stack[layer], n_hid=cfg.stack[layer + 1],
                         lr=cfg.lr, momentum=cfg.momentum, cd_k=cfg.cd_k,
                         weight_decay=cfg.weight_decay)
        p = rbm_init(gen, rcfg)
        vel = {k: torch.zeros_like(v) for k, v in p.items()}
        step = make_rbm_step(rcfg, group)

        nb = n // cfg.batch_size
        for epoch in range(cfg.max_epoch):
            perm = torch.randperm(n, generator=gen, device=dev)
            perm = perm[: nb * cfg.batch_size]
            errs = []
            for b in range(nb):
                batch = layer_input[perm[b * cfg.batch_size:
                                         (b + 1) * cfg.batch_size]]
                p, vel, err = step(p, vel, batch, gen, epoch)
                errs.append(err)
            mean_err = float(torch.stack(errs).mean()) if errs else 0.0
            if callback:
                callback(layer=layer, epoch=epoch, recon_err=mean_err)
            if cfg.log_every and epoch % cfg.log_every == 0:
                print(f"[dbn] layer {layer} epoch {epoch} recon_err "
                      f"{mean_err:.5f}")
        stack_params.append(p)

        # Algorithm 4: forward-propagation job to produce the next layer's input
        prop = map_reduce_job(hidden_probs, group, reduce="concat")
        with torch.no_grad():
            layer_input = prop(stack_params[-1], layer_input)

    return stack_params


def forward_stack(stack_params: Sequence[dict], v: torch.Tensor):
    """Encode data through the trained stack (all sigmoid layers)."""
    h = v
    for p in stack_params:
        h = torch.sigmoid(h @ p["W"] + p["bh"])
    return h


def progressive_stack_lm(train_fn, grow_schedule: Sequence[int]):
    """Beyond-paper: the greedy layer-wise idea carried to LM pre-training
    (progressive stacking).  ``train_fn(n_layers, init_params) -> params`` is
    invoked per stage; each stage initializes the deeper model by duplicating
    the shallower stage's stacked layer params (``grow_stacked_params``).

    Returns the final params."""
    params = None
    for n_layers in grow_schedule:
        params = train_fn(n_layers, params)
    return params


def grow_stacked_params(params, n_new: int):
    """Duplicate stacked [L, ...] block params to depth ``n_new`` (cycled);
    0-d leaves pass through."""
    def grow(x):
        if x.dim() == 0:
            return x
        L = x.shape[0]
        return torch.stack([x[i % L] for i in range(n_new)])
    return tree_map(grow, params)
