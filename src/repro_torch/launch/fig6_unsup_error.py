"""Paper Fig. 6: train/test reconstruction error vs iteration
(unsupervised): the port of ``benchmarks/fig6_unsup_error.py``.

DBN pre-training (Algorithm 1, every RBM probability through kernel K8 on
the card) + autoencoder unroll + MapReduce BP fine-tuning on synthetic
MNIST; reports the per-image squared reconstruction error curve.  The
digits live on the device and the batches are slices there.  Its CSV rows
are the JAX script's, letter for letter.

  PYTHONPATH=src python -m repro_torch.launch.figures --only fig6 [--device cpu]
"""
from __future__ import annotations

import time

import torch

from .. import resolve_device
from ..core import DBNConfig, autoencoder, train_dbn
from ..data import train_test
from ..models.params import tree_map


def run(n_train=2048, n_test=512, epochs=8, stack=(784, 256, 64, 30),
        batch=128, seed=0, csv=True, device="cuda"):
    dev = resolve_device(device)
    Xtr, _, Xte, _ = train_test(n_train=n_train, n_test=n_test, seed=seed)
    xtr, xte = (torch.as_tensor(a, device=dev) for a in (Xtr, Xte))
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    dbn_cfg = DBNConfig(stack=stack, max_epoch=3, batch_size=batch)
    rbm_stack = train_dbn(xtr, dbn_cfg, gen)
    params = autoencoder.unroll(rbm_stack)
    step = autoencoder.make_finetune_step(None, lr=0.02)
    vel = tree_map(torch.zeros_like, params)
    rows = []
    for epoch in range(epochs):
        for b in range(0, n_train - batch + 1, batch):
            params, vel, loss, aux = step(params, vel,
                                          {"x": xtr[b:b + batch]})
        tr = autoencoder.reconstruction_error(params, xtr[:n_test])
        te = autoencoder.reconstruction_error(params, xte)
        rows.append((epoch, tr, te))
        if csv:
            print(f"fig6_unsup_error,epoch={epoch},train_err={tr:.4f},"
                  f"test_err={te:.4f}")
    dt = time.perf_counter() - t0
    if csv:
        improved = rows[0][1] / max(rows[-1][1], 1e-9)
        print(f"fig6_unsup_error,total_s={dt:.1f},improvement_x={improved:.2f}")
    return rows


if __name__ == "__main__":
    run()
