"""The paper's supervised pipeline (Figs. 7/9/11) on PyTorch: DBN
pre-training + MapReduce BP fine-tuning + AdaBoost(SAMME) precision
refinement (§IV-C), reporting the train/test misclassification curve with
its over-fitting signature.  The counterpart of
``examples/train_classifier.py``; runs on ``cuda`` (every RBM probability
through kernel K8) unless given ``--device cpu``.

  PYTHONPATH=src python examples/train_classifier_torch.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import DBNConfig, adaboost, finetune, train_dbn
from repro_torch.data import dedup, train_test
from repro_torch.models.params import tree_map


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    Xtr, ytr, Xte, yte = train_test(n_train=2048, n_test=512, seed=0,
                                    duplicate_frac=0.1)
    Xtr, ytr = dedup(Xtr, ytr)
    xtr, xte = (torch.as_tensor(a, device=dev) for a in (Xtr, Xte))
    ytr_t, yte_t = (torch.as_tensor(a.astype(np.int64), device=dev)
                    for a in (ytr, yte))

    # pre-train (Algorithm 1)
    cfg = DBNConfig(stack=(784, 256, 64), max_epoch=3, batch_size=128)
    stack = train_dbn(xtr, cfg, torch.Generator(device=dev).manual_seed(0))

    # fine-tune (§IV-B) — note train error -> 0 while test error plateaus
    params = finetune.classifier_init(
        stack, 10, torch.Generator(device=dev).manual_seed(1))
    step = finetune.make_classifier_step(None, lr=1.0)
    vel = tree_map(torch.zeros_like, params)
    for epoch in range(15):
        for b in range(0, len(Xtr) - 128, 128):
            params, vel, loss, aux = step(
                params, vel, {"x": xtr[b:b + 128], "y": ytr_t[b:b + 128]})
        tr = finetune.error_rate(params, xtr, ytr_t)
        te = finetune.error_rate(params, xte, yte_t)
        print(f"epoch {epoch:2d}: train_err {tr:.3f}  test_err {te:.3f}")

    # precision refinement (§IV-C)
    learners, alphas = adaboost.fit(
        Xtr, ytr, adaboost.BoostConfig(n_rounds=5, epochs=3),
        torch.Generator(device=dev).manual_seed(2))
    err = adaboost.error_rate(learners, alphas, Xte, yte)
    print(f"adaboost ({len(learners)} weak learners): test_err {err:.3f}")
    return {"n_train": len(Xtr), "train_err": tr, "test_err": te,
            "n_learners": len(learners), "adaboost_test_err": err}


if __name__ == "__main__":
    main()
