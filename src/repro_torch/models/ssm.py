"""Mamba-2 SSD (state-space duality) block — chunked, matmul-dominant form.

The port of ``repro.models.ssm``.  The chunked algorithm (Dao & Gu, 2024,
§6) splits the sequence into chunks of Q tokens: within-chunk terms are
batched matmuls, and the cross-chunk recurrence is a length-``S/Q`` loop
over the small ``[H, P, N]`` state, carried in fp32.  Decode is the exact
O(1) recurrence.

Rounding points are the JAX package's: its ``jnp.einsum`` promotes the
bf16 x fp32 operands of every SSD contraction to fp32, so each
contraction here casts its operands to fp32 and the scan's output rounds
once, at the cast back to the input dtype.  The four-operand within-chunk
einsum is contracted pairwise in one stated order, ``(C B^T) * L`` then
times x, so that at most one fp32 tensor of ``L``'s size ``[b, h, c, Q,
Q]`` lives beside ``L`` itself.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .layers import act_fn, rmsnorm
from .params import ParamDef

silu = act_fn("silu")


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``) op for op: ``max(x, 0) +
    log1p(exp(-|x|))``.  ``F.softplus`` returns ``x`` itself above its
    threshold instead."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


# ------------------------------------------------------------------ param defs

def ssm_defs(cfg: ArchConfig):
    d, di = cfg.d_model, cfg.d_inner
    n, g = cfg.ssm_state, cfg.ssm_n_groups
    h, w = cfg.ssm_n_heads, cfg.conv_width
    return {
        "wz": ParamDef((d, di), ("embed", "ff")),
        "wx": ParamDef((d, di), ("embed", "ff")),
        "wB": ParamDef((d, g * n), ("embed", None)),
        "wC": ParamDef((d, g * n), ("embed", None)),
        "wdt": ParamDef((d, h), ("embed", "heads")),
        "dt_bias": ParamDef((h,), ("heads",), init="zeros"),
        "A_log": ParamDef((h,), ("heads",), dtype=torch.float32,
                          init="zeros"),
        "D": ParamDef((h,), ("heads",), dtype=torch.float32, init="ones"),
        "conv_x": ParamDef((w, di), ("conv", "ff")),
        "conv_B": ParamDef((w, g * n), ("conv", None)),
        "conv_C": ParamDef((w, g * n), ("conv", None)),
        "norm": ParamDef((di,), ("ff",), init="ones"),
        "wo": ParamDef((di, d), ("ff", "embed")),
    }


def causal_depthwise_conv(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """u: [B, S, C]; w: [W, C] — causal depthwise conv via W shifted adds,
    each rounded in the activation dtype as the JAX package's are."""
    W, S = w.shape[0], u.shape[1]
    out = u * w[-1]
    for i in range(1, W):
        shifted = F.pad(u, (0, 0, i, 0))[:, :S]
        out = out + shifted * w[-1 - i]
    return out


def segsum(x: torch.Tensor) -> torch.Tensor:
    """x: [..., T] -> [..., T, T] lower-triangular segment sums (-inf above
    the diagonal)."""
    T = x.shape[-1]
    cs = torch.cumsum(x, -1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return seg.masked_fill(~mask, float("-inf"))


def ssd_chunked(xd, dtA, B, C, chunk: int, init_state=None):
    """SSD scan.

    xd:  [b, s, h, p]   (already dt-scaled inputs)
    dtA: [b, s, h]      (dt * A, negative, fp32)
    B,C: [b, s, n]      (single group)
    Returns (y [b, s, h, p] in xd's dtype, final_state [b, h, p, n] fp32).
    Zero padding to a whole chunk is a no-op for the state (``dtA = 0``:
    decay 1; ``xd = 0``: no input)."""
    b, s, h, p = xd.shape
    n = B.shape[-1]
    Q = min(chunk, s)
    pad = (-s) % Q
    if pad:
        xd = F.pad(xd, (0, 0, 0, 0, 0, pad))
        dtA = F.pad(dtA, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    c = (s + pad) // Q
    xf = xd.reshape(b, c, Q, h, p).float()
    dtA = dtA.reshape(b, c, Q, h).permute(0, 3, 1, 2)             # [b,h,c,q]
    Bc = B.reshape(b, c, Q, n).float()
    Cc = C.reshape(b, c, Q, n).float()

    A_cs = torch.cumsum(dtA, -1)                                   # [b,h,c,q]
    # within-chunk (diagonal) term: L <- L * (C B^T), then L x; out of
    # place, since exp saves its output for the backward
    L = torch.exp(segsum(dtA))                                   # [b,h,c,q,k]
    L = L * torch.einsum("bcqn,bckn->bcqk", Cc, Bc)[:, None]
    y = torch.einsum("bhcqk,bckhp->bcqhp", L, xf)
    del L

    # per-chunk input states
    decay_states = torch.exp(A_cs[..., -1:] - A_cs)                # [b,h,c,k]
    states = torch.einsum(
        "bckn,bckhp->bchpn", Bc,
        xf * decay_states.permute(0, 2, 3, 1)[..., None])

    # cross-chunk recurrence, in fp32; emits the state *before* each chunk
    chunk_decay = torch.exp(A_cs[..., -1])                         # [b,h,c]
    carry = (torch.zeros((b, h, p, n), dtype=torch.float32, device=xd.device)
             if init_state is None else init_state.float())
    prev = []
    for i in range(c):
        prev.append(carry)
        carry = carry * chunk_decay[:, :, i, None, None] + states[:, i]
    prev = torch.stack(prev, 1)                                  # [b,c,h,p,n]

    state_decay = torch.exp(A_cs).permute(0, 2, 3, 1)[..., None]  # b,c,q,h,1
    y = y + torch.einsum("bcqn,bchpn->bcqhp", Cc, prev) * state_decay
    y = y.to(xd.dtype).reshape(b, c * Q, h, p)
    return y[:, :s], carry


def ssm_inputs(cfg: ArchConfig, p, x):
    """The projections the block and its cache share: (z, x_in, B_in,
    C_in, dt fp32) before the convolutions."""
    dt = softplus((x @ p["wdt"]).float() + p["dt_bias"].float())
    return x @ p["wz"], x @ p["wx"], x @ p["wB"], x @ p["wC"], dt


def ssm_block(cfg: ArchConfig, p, x, *, init_state=None, length_mask=None,
              inputs=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence SSD block.  x: [B, S, d_model] -> ([B, S, d_model],
    final_state fp32).

    ``length_mask`` ([B, S] bool, optional) marks real positions; masked
    (padding) positions get ``dt = 0`` so they neither decay nor feed the
    state — ``final_state`` is then the state after each row's last real
    position (serving's right-padded prefill).  ``inputs`` reuses the
    projections of ``ssm_inputs`` where a caller also needs them."""
    h, pd = cfg.ssm_n_heads, cfg.ssm_head_dim
    z, x_in, B_in, C_in, dt = inputs or ssm_inputs(cfg, p, x)
    xs = silu(causal_depthwise_conv(x_in, p["conv_x"]))
    B = silu(causal_depthwise_conv(B_in, p["conv_B"]))
    C = silu(causal_depthwise_conv(C_in, p["conv_C"]))
    if length_mask is not None:
        dt = dt * length_mask[..., None]        # pads: decay 1, input 0
    A = -torch.exp(p["A_log"])                                     # [h]
    xh = xs.reshape(*xs.shape[:2], h, pd)
    xd = xh * dt[..., None].to(xh.dtype)
    y, final = ssd_chunked(xd, dt * A, B, C, cfg.ssm_chunk, init_state)
    y = y + p["D"].to(y.dtype)[:, None] * xh
    y = y.reshape(*x.shape[:2], cfg.d_inner)
    y = rmsnorm(y * silu(z), p["norm"])
    return y @ p["wo"], final


# --------------------------------------------------------------------- decode

def ssm_cache_defs(cfg: ArchConfig, batch: int):
    di, gn = cfg.d_inner, cfg.ssm_n_groups * cfg.ssm_state
    w = cfg.conv_width - 1
    return {
        "conv_x": ParamDef((batch, w, di), ("batch", None, "ff"),
                           init="zeros"),
        "conv_B": ParamDef((batch, w, gn), ("batch", None, None),
                           init="zeros"),
        "conv_C": ParamDef((batch, w, gn), ("batch", None, None),
                           init="zeros"),
        "state": ParamDef((batch, cfg.ssm_n_heads, cfg.ssm_head_dim,
                           cfg.ssm_state), ("batch", "heads", None, None),
                          dtype=torch.float32, init="zeros"),
    }


def conv_step(u, cache, w):
    """u: [B, C]; cache: [B, W-1, C] (written in place with the newest
    W-1 inputs); w: [W, C].  Returns y [B, C]: the window's products
    summed in fp32, one rounding (the JAX package's einsum)."""
    full = torch.cat([cache, u[:, None]], dim=1)                   # [B, W, C]
    y = (full.float() * w.float()).sum(1).to(u.dtype)
    cache.copy_(full[:, 1:])
    return y


def ssm_decode_block(cfg: ArchConfig, p, x, cache):
    """One-token decode.  x: [B, d_model]; cache: one layer's
    {conv_x, conv_B, conv_C, state}, written in place.  Returns [B,
    d_model]."""
    h, pd = cfg.ssm_n_heads, cfg.ssm_head_dim
    z, x_in, B_in, C_in, dt = ssm_inputs(cfg, p, x)
    xs = silu(conv_step(x_in, cache["conv_x"], p["conv_x"]))
    B = silu(conv_step(B_in, cache["conv_B"], p["conv_B"]))
    C = silu(conv_step(C_in, cache["conv_C"], p["conv_C"]))
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A)                                         # [B,h]
    xh = xs.reshape(-1, h, pd)
    st = cache["state"]
    upd = (xh.float() * dt[..., None])[..., None] * B.float()[:, None, None]
    st.mul_(dA[..., None, None]).add_(upd)
    y = torch.einsum("bhpn,bn->bhp", st, C.float()).to(x.dtype)
    y = y + p["D"].to(y.dtype)[:, None] * xh
    y = y.reshape(-1, cfg.d_inner)
    y = rmsnorm(y * silu(z), p["norm"])
    return y @ p["wo"]
