"""Quickstart: the paper's pipeline end to end on PyTorch — the counterpart
of ``examples/quickstart.py``.

Trains a small deep-belief network on synthetic MNIST with MapReduce RBM
jobs, fine-tunes a digit classifier, and recognizes a few test digits (the
Fig. 9 demo, minus the Matlab GUI).  Runs on ``cuda``, where every RBM
probability goes through kernel K8, unless given ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import resolve_device
from ..core import DBNConfig, finetune, train_dbn
from ..data import dedup, train_test
from ..kernels.rbm_cd import gemm_sigmoid
from ..models.params import tree_map


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"

    # 1. data (+ the paper's diversity-based dedup, §III-A)
    Xtr, ytr, Xte, yte = train_test(n_train=2048, n_test=512,
                                    duplicate_frac=0.1)
    Xtr, ytr = dedup(Xtr, ytr)
    print(f"data: {len(Xtr)} train / {len(Xte)} test after dedup, on {dev}"
          f"{' (RBM probabilities through kernel K8)' if on_card else ''}")

    # 2. greedy layer-wise RBM pre-training (Algorithm 1)
    cfg = DBNConfig(stack=(784, 256, 64), max_epoch=3, batch_size=128,
                    log_every=1)
    gen = torch.Generator(device=dev).manual_seed(0)
    n0 = gemm_sigmoid.launches
    stack = train_dbn(Xtr, cfg, gen)

    # 3. supervised MapReduce back-propagation fine-tuning (§IV-B)
    params = finetune.classifier_init(stack, 10, gen)
    step = finetune.make_classifier_step(None, lr=1.0)
    vel = tree_map(torch.zeros_like, params)
    x_all = torch.as_tensor(Xtr, device=dev)
    y_all = torch.as_tensor(ytr.astype(np.int64), device=dev)
    for epoch in range(15):
        for b in range(0, len(Xtr) - 128, 128):
            params, vel, loss, aux = step(params, vel,
                                          {"x": x_all[b:b + 128],
                                           "y": y_all[b:b + 128]})
        if epoch % 3 == 0:
            print(f"epoch {epoch}: loss {float(loss):.3f} "
                  f"train_acc {float(aux['acc']):.2f}")

    # 4. recognize (the Fig. 9 demo step)
    err = finetune.error_rate(params, Xte, yte)
    with torch.no_grad():
        pred = torch.argmax(finetune.logits_fn(
            params, torch.as_tensor(Xte[:8], device=dev)), -1).tolist()
    print(f"test error rate: {err:.3f}")
    print(f"sample digits:   true={yte[:8].tolist()} pred={pred}")
    if on_card:
        print(f"K8 launches: {gemm_sigmoid.launches - n0}")
    return {"test_error": err, "k8_launches": gemm_sigmoid.launches - n0}


if __name__ == "__main__":
    main()
