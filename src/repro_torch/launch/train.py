"""End-to-end training CLI of the port: the counterpart of
``repro.launch.train``.

Trains any token-only architecture (reduced or full geometry) on the
synthetic token stream with either engine, with checkpoint/restart fault
tolerance; enc-dec and vlm archs, which also take frames or image
embeddings, raise a ``ValueError`` (their batches go to
``models.steps.make_train_step`` directly).  Runs on ``cuda`` unless
given ``--device cpu`` (without a card it raises instead of moving to the
CPU); ``--attn-backend auto`` is ``hopper`` on ``cuda``, which runs every
full-causal self-attention of the forward through kernel K9.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --reduced --steps 6 --global-batch 4 --seq-len 32 [--engine mapreduce]
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --steps 20 --global-batch 8 --seq-len 1024

``--engine mapreduce`` runs the paper's map/combine/reduce step over a
``torch.distributed`` group of this one process (NCCL on the card, gloo on
the CPU, meeting on the loopback interface): the reduce is a real
collective of world size 1.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import socket

import torch
import torch.distributed as dist

from .. import resolve_device
from ..configs import get_arch, reduced as make_reduced
from ..core.mapreduce import dp_groups
from ..data.pipeline import token_batches
from ..models.attn_backend import resolve_backend
from ..models.params import tree_leaves
from ..models.registry import init_params
from ..models.steps import make_train_step
from ..optim import OptConfig, init_opt_state
from ..runtime import LoopConfig, TrainLoop


def local_group(device: torch.device):
    """A process group of this process alone (NCCL on ``cuda``, gloo on the
    CPU) on a free loopback port, and its ``dp_groups(1)``.  The caller
    destroys it with ``dist.destroy_process_group()``."""
    if device.type == "cuda":
        backend = "nccl"
    else:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        backend = "gloo"
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    return dp_groups(1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0, help="override n_layers")
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--engine", default="pjit", choices=["pjit", "mapreduce"])
    ap.add_argument("--reduce-mode", default="allreduce")
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--opt", default="adamw")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--attn-backend", default="auto",
                    choices=["auto", "reference", "hopper"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    backend = resolve_backend(args.attn_backend, dev)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    over = {}
    if args.layers:
        over["n_layers"] = args.layers
    if args.d_model:
        over["d_model"] = args.d_model
    over["remat"] = "none"
    cfg = dataclasses.replace(cfg, **over)
    need = "frames" if cfg.enc_dec else \
        "image_embeds" if cfg.n_image_tokens else None
    if need:
        # as the JAX CLI, this CLI feeds the token stream alone
        raise ValueError(
            f"{cfg.name} trains on tokens and {need!r}, which this CLI does "
            "not feed: call models.steps.make_train_step with a batch of "
            f"{{'tokens', {need!r}}}")

    opt_cfg = OptConfig(name=args.opt, lr=args.lr,
                        schedule="linear_warmup_cosine",
                        warmup=max(1, args.steps // 10),
                        total_steps=args.steps)
    params = init_params(cfg, args.seed, dev)
    opt_state = init_opt_state(params, opt_cfg)
    n_params = sum(p.numel() for _, p in tree_leaves(params))
    print(f"[train] {cfg.name}: {n_params/1e6:.1f}M params, "
          f"engine={args.engine}, device={dev}, attn_backend={backend}, "
          f"batch={args.global_batch}x{args.seq_len}")

    groups = local_group(dev) if args.engine == "mapreduce" else None
    try:
        step_fn = make_train_step(cfg, opt_cfg, engine=args.engine,
                                  reduce_mode=args.reduce_mode,
                                  n_micro=args.n_micro, groups=groups,
                                  attn_backend=backend)

        def loop_step(state, batch):
            params, opt_state = state
            b = {"tokens": torch.as_tensor(batch["tokens"], device=dev)}
            params, opt_state, metrics = step_fn(params, opt_state, b)
            return (params, opt_state), metrics

        data = token_batches(cfg.vocab, args.global_batch, args.seq_len,
                             seed=args.seed)
        loop = TrainLoop(loop_step, (params, opt_state), data,
                         LoopConfig(ckpt_dir=args.ckpt_dir,
                                    ckpt_every=args.ckpt_every, log_every=5),
                         device=dev)
        out = loop.run(args.steps)
    finally:
        if groups is not None:
            dist.destroy_process_group()
    print(f"[train] done: final loss {out['final_loss']:.4f} "
          f"after {out['steps']} steps")
    return out


if __name__ == "__main__":
    main()
