"""Shared neural layers: norms, activations, MLPs, RoPE, embeddings.

Each function keeps the rounding points of its ``repro.models.layers``
counterpart: norm statistics and RoPE in fp32 with one cast back to the
activation dtype, matmuls and elementwise MLP ops in the activation dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .params import ParamDef

# ----------------------------------------------------------------------- norms


def norm_defs(cfg: ArchConfig, d: int):
    if cfg.norm == "layernorm":
        return {"scale": ParamDef((d,), ("embed",), init="ones"),
                "bias": ParamDef((d,), ("embed",), init="zeros")}
    return {"scale": ParamDef((d,), ("embed",), init="ones")}


def apply_norm(cfg: ArchConfig, p, x, eps: float = 1e-5):
    if cfg.norm_fp32:
        xf = x.float()
        if cfg.norm == "layernorm":
            mu = xf.mean(-1, keepdim=True)
            var = xf.var(-1, keepdim=True, unbiased=False)
            y = (xf - mu) * torch.rsqrt(var + eps)
            y = y * p["scale"].float() + p["bias"].float()
        else:  # rmsnorm
            ms = xf.square().mean(-1, keepdim=True)
            y = xf * torch.rsqrt(ms + eps) * p["scale"].float()
        return y.to(x.dtype)
    # activation-dtype elementwise path: only the statistics are fp32
    if cfg.norm == "layernorm":
        mu = x.float().mean(-1, keepdim=True)
        var = x.float().var(-1, keepdim=True, unbiased=False)
        inv = torch.rsqrt(var + eps).to(x.dtype)
        return (x - mu.to(x.dtype)) * inv * p["scale"] + p["bias"]
    ms = x.float().square().mean(-1, keepdim=True)
    return x * torch.rsqrt(ms + eps).to(x.dtype) * p["scale"]


def rmsnorm(x, scale, eps: float = 1e-5):
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)

# ----------------------------------------------------------------- activations


def _silu(x):
    # jax.nn.silu's definition, op for op: x * sigmoid(x)
    return x * torch.sigmoid(x)


def act_fn(name: str):
    return {
        "silu": _silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu default
        "relu": F.relu,
        "relu2": lambda x: F.relu(x).square(),
    }[name]

# ------------------------------------------------------------------------ MLP


def mlp_defs(cfg: ArchConfig, d: int, ff: int):
    defs = {"down": ParamDef((ff, d), ("ff", "embed"))}
    if cfg.mlp_gated:
        defs["gate"] = ParamDef((d, ff), ("embed", "ff"))
        defs["up"] = ParamDef((d, ff), ("embed", "ff"))
    else:
        defs["up"] = ParamDef((d, ff), ("embed", "ff"))
        if cfg.qkv_bias:  # starcoder2-style biased MLP
            defs["up_b"] = ParamDef((ff,), ("ff",), init="zeros")
            defs["down_b"] = ParamDef((d,), ("embed",), init="zeros")
    return defs


def apply_mlp(cfg: ArchConfig, p, x):
    act = act_fn(cfg.act)
    if cfg.mlp_gated:
        h = act(x @ p["gate"]) * (x @ p["up"])
    else:
        h = x @ p["up"]
        if "up_b" in p:
            h = h + p["up_b"]
        h = act(h)
    y = h @ p["down"]
    if "down_b" in p:
        y = y + p["down_b"]
    return y

# ----------------------------------------------------------------------- RoPE


def rope_freqs(cfg: ArchConfig, head_dim: int, device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=device) / half
    return 1.0 / (cfg.rope_theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               freqs: torch.Tensor) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq] (broadcastable)."""
    angles = positions[..., :, None].float() * freqs          # [..., seq, half]
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    y = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return y.to(x.dtype)

# ------------------------------------------------------------------ embeddings


def embed_defs(cfg: ArchConfig):
    v, d = cfg.vocab_padded, cfg.d_model
    defs = {"tok": ParamDef((v, d), ("vocab", "embed"), init="embed")}
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, v), ("embed", "vocab"))
    return defs


def embed_tokens(p, tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"][tokens]


def lm_logits(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    w = p["tok"].T if cfg.tie_embeddings else p["lm_head"]
    return x @ w


def chunked_nll(cfg: ArchConfig, p, hidden: torch.Tensor,
                labels: torch.Tensor, mask: torch.Tensor, chunk: int = 0):
    """Summed next-token CE over hidden [B, S, d] in sequence chunks of
    ``chunk`` (default ``cfg.loss_chunk``) positions, so the [*, V] fp32
    logits of the whole sequence are never built at once; padded-vocab
    logits are -1e30 and positions where ``mask`` [B, S] is False add 0.
    Returns (sum of the nll fp32, count of the masked-in positions fp32)."""
    S = hidden.shape[1]
    chunk = min(chunk or cfg.loss_chunk, S)
    vocab_mask = torch.arange(cfg.vocab_padded,
                              device=hidden.device) >= cfg.vocab
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, S, chunk):
        logits = lm_logits(cfg, p, hidden[:, c0:c0 + chunk]).float()
        logits = logits.masked_fill(vocab_mask, -1e30)
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels[:, c0:c0 + chunk, None])[..., 0]
        m = mask[:, c0:c0 + chunk]
        tot = tot + torch.where(m, lse - gold, 0.0).sum()
        cnt = cnt + m.sum()
    return tot, cnt
