"""RG-LRU recurrent block (Griffin / RecurrentGemma).

The port of ``repro.models.rglru``.  The full-sequence block runs the
linear recurrence ``h_t = a_t h_{t-1} + b_t`` as ``associative_scan``, a
line-for-line port of ``jax.lax.associative_scan``'s odd/even recursion
(pairwise reduce, recursion on the odd elements, even fill, interleave), so
the same fp32 ``a``, ``b`` give bit-equal ``h``: a sequential loop or a
Hillis–Steele scan would sum in another order.  Decode is the exact O(1)
per-step recurrence.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..configs.base import ArchConfig
from .layers import act_fn
from .params import ParamDef
from .ssm import causal_depthwise_conv, conv_step, softplus

_C = 8.0  # RG-LRU temperature constant (Griffin §2.4)
gelu = act_fn("gelu")            # jax.nn.gelu's default: the tanh form


def rglru_defs(cfg: ArchConfig):
    d, dr, w = cfg.d_model, cfg.d_rnn or cfg.d_model, cfg.conv_width
    return {
        "w_in": ParamDef((d, dr), ("embed", "rnn")),
        "w_gate": ParamDef((d, dr), ("embed", "rnn")),
        "conv": ParamDef((w, dr), ("conv", "rnn")),
        "w_a": ParamDef((dr, dr), ("rnn", "embed_tp")),
        "b_a": ParamDef((dr,), ("rnn",), init="zeros"),
        "w_i": ParamDef((dr, dr), ("rnn", "embed_tp")),
        "b_i": ParamDef((dr,), ("rnn",), init="zeros"),
        "lam": ParamDef((dr,), ("rnn",), dtype=torch.float32,
                        init="const:2.0"),
        "w_out": ParamDef((dr, d), ("rnn", "embed")),
    }


def gates(p, u):
    """(a, b) of the recurrence, fp32: a = exp(-C softplus(lam) r), b =
    sqrt(1 - a^2) (i u)."""
    r = torch.sigmoid(u @ p["w_a"] + p["b_a"]).float()
    i = torch.sigmoid(u @ p["w_i"] + p["b_i"]).float()
    log_a = -_C * softplus(p["lam"]) * r                       # log a_t (<= 0)
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    b = beta * (i * u.float())
    return a, b


def _combine(left, right):
    al, bl = left
    ar, br = right
    return al * ar, ar * bl + br


def _interleave(even, odd):
    """Elements even[0], odd[0], even[1], odd[1], ... along axis 1."""
    n_e, n_o = even.shape[1], odd.shape[1]
    out = even.new_empty((even.shape[0], n_e + n_o) + even.shape[2:])
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def associative_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of the pairs ``(a_t, b_t)`` under ``_combine`` along
    axis 1: ``jax.lax.associative_scan``'s recursion, op for op."""
    n = a.shape[1]
    if n < 2:
        return a, b
    # combine adjacent pairs, then scan the half-length sequence
    ra, rb = _combine((a[:, 0:n - 1:2], b[:, 0:n - 1:2]),
                      (a[:, 1::2], b[:, 1::2]))
    oa, ob = associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine((oa[:, :-1], ob[:, :-1]), (a[:, 2::2], b[:, 2::2]))
    else:
        ea, eb = _combine((oa, ob), (a[:, 2::2], b[:, 2::2]))
    ea = torch.cat([a[:, :1], ea], 1)
    eb = torch.cat([b[:, :1], eb], 1)
    return _interleave(ea, oa), _interleave(eb, ob)


def rglru_block(cfg: ArchConfig, p, x, *, init_state=None, length_mask=None,
                u_raw=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence recurrent block.  x: [B, S, d] -> ([B, S, d],
    final_state [B, d_rnn] fp32).

    ``length_mask`` ([B, S] bool, optional) marks real positions; masked
    (padding) steps become identities (``a = 1, b = 0``), so the recurrence
    and ``final_state`` stop at each row's last real position.  ``u_raw``
    reuses ``x @ w_in`` where the caller also needs it."""
    u = causal_depthwise_conv(x @ p["w_in"] if u_raw is None else u_raw,
                              p["conv"])
    gate = gelu(x @ p["w_gate"])
    a, b = gates(p, u)                                         # [B, S, dr]
    if length_mask is not None:
        m = length_mask[..., None]
        a = torch.where(m, a, 1.0)
        b = torch.where(m, b, 0.0)
    if init_state is not None:
        # fold the initial state into the first step: h_1 = a_1 h_0 + b_1
        b = b.clone()
        b[:, 0] += a[:, 0] * init_state.float()
    _, h = associative_scan(a, b)
    y = (h.to(x.dtype) * gate) @ p["w_out"]
    return y, h[:, -1]


def rglru_cache_defs(cfg: ArchConfig, batch: int):
    dr = cfg.d_rnn or cfg.d_model
    return {
        "conv": ParamDef((batch, cfg.conv_width - 1, dr),
                         ("batch", None, "rnn"), init="zeros"),
        "state": ParamDef((batch, dr), ("batch", "rnn"), dtype=torch.float32,
                          init="zeros"),
    }


def rglru_decode_block(cfg: ArchConfig, p, x, cache):
    """One-token decode.  x: [B, d]; cache: one layer's {conv, state},
    written in place.  Returns [B, d]."""
    u = conv_step(x @ p["w_in"], cache["conv"], p["conv"])
    gate = gelu(x @ p["w_gate"])
    a, b = gates(p, u)
    h = cache["state"]
    h.mul_(a).add_(b)
    return (h.to(x.dtype) * gate) @ p["w_out"]
