"""Paper Fig. 7: train/test misclassification vs iteration (supervised),
including the paper's observed over-fitting signature (train error -> 0
while test error bottoms out / rises): the port of
``benchmarks/fig7_sup_error.py``.

Pre-training runs every RBM probability through kernel K8 on the card; the
digits live on the device and the batches are slices there.  Its CSV rows
are the JAX script's, letter for letter.

  PYTHONPATH=src python -m repro_torch.launch.figures --only fig7 [--device cpu]
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import resolve_device
from ..core import DBNConfig, finetune, train_dbn
from ..data import train_test
from ..models.params import tree_map


def run(n_train=2048, n_test=512, epochs=25, stack=(784, 256, 64),
        batch=128, seed=0, csv=True, device="cuda"):
    dev = resolve_device(device)
    Xtr, ytr, Xte, yte = train_test(n_train=n_train, n_test=n_test,
                                    seed=seed)
    xtr, xte = (torch.as_tensor(a, device=dev) for a in (Xtr, Xte))
    ytr, yte = (torch.as_tensor(a.astype(np.int64), device=dev)
                for a in (ytr, yte))
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    dbn_cfg = DBNConfig(stack=stack, max_epoch=3, batch_size=batch)
    rbm_stack = train_dbn(xtr, dbn_cfg, gen)
    params = finetune.classifier_init(rbm_stack, 10, gen)
    step = finetune.make_classifier_step(None, lr=1.0)
    vel = tree_map(torch.zeros_like, params)
    rows = []
    for epoch in range(epochs):
        for b in range(0, n_train - batch + 1, batch):
            params, vel, loss, aux = step(
                params, vel, {"x": xtr[b:b + batch], "y": ytr[b:b + batch]})
        tr = finetune.error_rate(params, xtr, ytr)
        te = finetune.error_rate(params, xte, yte)
        rows.append((epoch, tr, te))
        if csv:
            print(f"fig7_sup_error,epoch={epoch},train_err={tr:.4f},"
                  f"test_err={te:.4f}")
    dt = time.perf_counter() - t0
    if csv:
        print(f"fig7_sup_error,total_s={dt:.1f},final_train={rows[-1][1]:.4f},"
              f"final_test={rows[-1][2]:.4f}")
    return rows


if __name__ == "__main__":
    run()
