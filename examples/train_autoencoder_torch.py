"""The paper's unsupervised demo (Figs. 10/12) on PyTorch: 784-1000-500-
250-30 deep autoencoder — RBM pre-training, unroll, MapReduce BP
fine-tuning, then encode/decode a digit through the 30-dim code (compress
rate 30/784 = 0.038, the paper quotes the same pipeline).  The counterpart
of ``examples/train_autoencoder.py``; runs on ``cuda`` (every RBM
probability through kernel K8) unless given ``--device cpu``.

  PYTHONPATH=src python examples/train_autoencoder_torch.py [--small] \\
      [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import DBNConfig, autoencoder, train_dbn
from repro_torch.data import train_test
from repro_torch.models.params import tree_map


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="reduced stack for a fast CPU run")
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    stack = (784, 256, 64, 30) if args.small else (784, 1000, 500, 250, 30)
    n_train = 2048 if args.small else 6000

    Xtr, _, Xte, _ = train_test(n_train=n_train, n_test=512)
    xtr, xte = (torch.as_tensor(a, device=dev) for a in (Xtr, Xte))
    cfg = DBNConfig(stack=stack, max_epoch=3, batch_size=128, log_every=1)
    rbm_stack = train_dbn(xtr, cfg, torch.Generator(device=dev).manual_seed(0))

    params = autoencoder.unroll(rbm_stack)
    pre = autoencoder.reconstruction_error(params, xte)
    print("pre-train recon err:", pre)

    step = autoencoder.make_finetune_step(None, lr=0.02)
    vel = tree_map(torch.zeros_like, params)
    err = pre
    for epoch in range(args.epochs):
        for b in range(0, n_train - 128, 128):
            params, vel, loss, aux = step(params, vel,
                                          {"x": xtr[b:b + 128]})
        err = autoencoder.reconstruction_error(params, xte)
        print(f"epoch {epoch}: finetune recon err {err:.3f}")

    # the Fig. 10 demo: encode -> 30 dims -> decode
    with torch.no_grad():
        x = xte[:1]
        code = autoencoder.encode(params, x)
        recon = autoencoder.decode(params, code)
        l2 = float(torch.sum((x - recon) ** 2))
    print(f"encode/decode demo: 784 pixels -> code{code.shape[-1]} -> 784")
    print("code:", np.round(code[0][:10].cpu().numpy(), 2), "...")
    print(f"recon L2: {l2:.2f}")
    return {"n_train": n_train, "stack": stack, "recon_err_pretrained": pre,
            "recon_err": err, "code_dim": code.shape[-1], "recon_l2": l2}


if __name__ == "__main__":
    main()
