"""Deep autoencoder: DBN unroll + MapReduce back-propagation fine-tuning —
the port of ``repro.core.autoencoder``.

This is the paper's unsupervised pipeline (Figs. 6/10/12): the RBM stack is
unrolled into encoder+decoder (decoder weights = transposed encoder weights
as *initialization*, then trained independently) and fine-tuned with the
MapReduce BP job minimizing the sigmoid cross-entropy reconstruction loss
(Hinton & Salakhutdinov 2006).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from .finetune import sgd_momentum
from .mapreduce import DPGroups, mapreduce_value_and_grad, value_and_grad


def unroll(stack_params: Sequence[dict]) -> Dict[str, list]:
    """RBM stack -> autoencoder params {enc_W, enc_b, dec_W, dec_b} lists
    (new contiguous tensors)."""
    return {"enc_W": [p["W"].clone() for p in stack_params],
            "enc_b": [p["bh"].clone() for p in stack_params],
            "dec_W": [p["W"].T.contiguous() for p in reversed(stack_params)],
            "dec_b": [p["bv"].clone() for p in reversed(stack_params)]}


def encode(params, v, linear_code: bool = True):
    h = v
    n = len(params["enc_W"])
    for i, (w, b) in enumerate(zip(params["enc_W"], params["enc_b"])):
        z = h @ w + b
        h = z if (linear_code and i == n - 1) else torch.sigmoid(z)
    return h


def decode(params, code):
    h = code
    for w, b in zip(params["dec_W"], params["dec_b"]):
        h = torch.sigmoid(h @ w + b)   # final layer sigmoid: pixels in [0,1]
    return h


def reconstruct(params, v):
    return decode(params, encode(params, v))


def recon_loss(params, batch):
    """Sigmoid cross-entropy reconstruction loss (per Hinton's
    fine-tuning)."""
    v = batch["x"]
    r = torch.clamp(reconstruct(params, v), 1e-6, 1 - 1e-6)
    ce = -torch.mean(torch.sum(v * torch.log(r) + (1 - v) * torch.log(1 - r),
                               dim=-1))
    mse = torch.mean(torch.sum(torch.square(v - r), dim=-1))
    return ce, {"mse": mse}


def make_finetune_step(group: Optional[DPGroups] = None, lr: float = 0.05,
                       reduce_mode: str = "allreduce", n_micro: int = 1):
    """MapReduce BP fine-tuning step with plain SGD-momentum:
    ``step(params, vel, batch) -> (params, vel, loss, aux)``."""
    if group is None:
        @torch.no_grad()
        def step(params, vel, batch):
            loss, aux, grads = value_and_grad(recon_loss, params, batch)
            params, vel = sgd_momentum(params, vel, grads, lr)
            return params, vel, loss, aux
        return step

    mr = mapreduce_value_and_grad(recon_loss, group, reduce_mode=reduce_mode,
                                  n_micro=n_micro)

    @torch.no_grad()
    def step(params, vel, batch):
        loss, grads, _, aux = mr(params, batch, None)
        params, vel = sgd_momentum(params, vel, grads, lr)
        return params, vel, loss, aux

    return step


@torch.no_grad()
def reconstruction_error(params, data, batch: int = 1000) -> float:
    """Mean per-image squared reconstruction error (the paper's Fig. 6
    metric); ``data`` a numpy array or a tensor (on the parameters' device,
    it stays there)."""
    dev = params["enc_W"][0].device
    tot, n = 0.0, 0
    for i in range(0, len(data), batch):
        v = torch.as_tensor(data[i:i + batch], dtype=torch.float32,
                            device=dev)
        tot += float(torch.sum(torch.square(v - reconstruct(params, v))))
        n += v.shape[0]
    return tot / max(1, n)
