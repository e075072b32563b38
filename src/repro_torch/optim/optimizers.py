"""Optimizers with mixed precision: the port of ``repro.optim.optimizers``.

AdamW and SGD with momentum against an fp32 master copy of every
parameter, with global-norm gradient clipping and the ``const`` /
``cosine`` / ``linear_warmup_cosine`` learning-rate schedules.  Gradients
may be bf16; the update runs in fp32 on the master and re-casts to the
parameter's dtype.  The state's defs keep the JAX package's ``zero``
logical axis (the optimizer shard of a mesh); on one device it is only a
name.

``apply_updates`` is out of place, as in JAX: it returns new tensors and
leaves ``params`` and ``opt_state`` untouched, so a caller that drops a
step (``runtime.TrainLoop``'s guard against a non-finite loss) still holds
the state from before it.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..models.params import ParamDef, tree_leaves, tree_map, tree_map_defs


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"          # adamw | sgdm
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    momentum: float = 0.9
    grad_clip: float = 1.0
    schedule: str = "const"      # const | cosine | linear_warmup_cosine
    warmup: int = 100
    total_steps: int = 10000


def _zero_logical(d: ParamDef) -> ParamDef:
    """fp32 state def: same shape; the first unsharded dim named 'zero'."""
    logical = list(d.logical)
    for i, ax in enumerate(logical):
        if ax is None or ax in ("embed", "layers", "conv", "head_dim", "lora",
                                "state"):
            if ax != "layers":
                logical[i] = "zero"
                break
    return ParamDef(d.shape, tuple(logical), torch.float32, "zeros")


def opt_state_defs(param_defs, cfg: OptConfig):
    """ParamDef tree of the optimizer state (for init and restore)."""
    def per(_, d: ParamDef):
        z = _zero_logical(d)
        master = ParamDef(d.shape, z.logical, torch.float32, "zeros")
        if cfg.name == "sgdm":
            return {"master": master, "mu": z}
        return {"master": master, "mu": z, "nu": z}
    return {"step": ParamDef((), (), torch.int32, "zeros"),
            "params": tree_map_defs(per, param_defs)}


def init_opt_state(params, cfg: OptConfig):
    def per(p):
        st = {"master": p.float().clone(),
              "mu": torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device)}
        if cfg.name != "sgdm":
            st["nu"] = torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
        return st
    device = next(tree_leaves(params))[1].device
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "params": tree_map(per, params)}


def lr_at(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an int32 tensor), as fp32."""
    lr = torch.tensor(cfg.lr, dtype=torch.float32, device=step.device)
    if cfg.schedule == "const":
        return lr
    warm = torch.clamp((step + 1) / max(1, cfg.warmup), max=1.0)
    if cfg.schedule in ("linear_warmup_cosine", "cosine"):
        t = torch.clamp((step - cfg.warmup)
                        / max(1, cfg.total_steps - cfg.warmup), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return lr * warm * cos
    return lr * warm


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(x.float().square().sum()
                          for _, x in tree_leaves(tree)))


def apply_updates(params, grads, opt_state, cfg: OptConfig):
    """Returns (new_params, new_opt_state, metrics), all new tensors.
    Grads may be bf16; the update runs in fp32 against the master copy and
    re-casts to the param dtype."""
    step = opt_state["step"]
    lr = lr_at(cfg, step)
    gnorm = global_norm(grads)
    if cfg.grad_clip:
        scale = torch.where(gnorm > cfg.grad_clip,
                            cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                            torch.ones_like(gnorm))
    else:
        scale = torch.ones_like(gnorm)

    def per(p, g, st):
        g = g.float() * scale
        m = st["master"]
        if cfg.name == "sgdm":
            mu = cfg.momentum * st["mu"] + g
            new_m = m - lr * mu
            new_st = {"master": new_m, "mu": mu}
        else:  # adamw
            mu = cfg.b1 * st["mu"] + (1 - cfg.b1) * g
            nu = cfg.b2 * st["nu"] + (1 - cfg.b2) * torch.square(g)
            t = (step + 1).float()
            mu_hat = mu / (1 - cfg.b1 ** t)
            nu_hat = nu / (1 - cfg.b2 ** t)
            upd = mu_hat / (torch.sqrt(nu_hat) + cfg.eps)
            if cfg.weight_decay:
                upd = upd + cfg.weight_decay * m
            new_m = m - lr * upd
            new_st = {"master": new_m, "mu": mu, "nu": nu}
        return new_m.to(p.dtype), new_st

    out = tree_map(per, params, grads, opt_state["params"])
    new_params = tree_map(lambda _, o: o[0], params, out)
    new_states = tree_map(lambda _, o: o[1], params, out)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_params, {"step": step + 1, "params": new_states}, metrics
