"""Causal GQA flash attention, the attention of the LM training forward:
kernel K9.

``flash_attention`` replaces ``repro.kernels.flash_attention.ops.
flash_attention`` (Pallas ``kernel.py::flash_attention_fwd``) and takes the
model's layout, q [B, S, H, D] and k, v [B, S, K, D] with H % K == 0.  For
CUDA tensors it launches the hand-written kernel in
``csrc/flash_attention.cu`` (design and bound in its note): bf16 at head
dim 64 and 128 runs its tensor-core body (``wgmma``, p as two bf16
terms), fp32 and bf16 at head dim 32 its FFMA body.  For CPU tensors it
runs ``attention_plain``, the plain PyTorch version of the same function
(``repro.kernels.flash_attention.ref.attention_ref``: one fp32 softmax
over every key and one cast), which is also the kernel's oracle on the
card.

``flash_attention_train`` is the differentiable form: the forward is
``flash_attention``, the backward is written out in torch ops (the TPU
kernel is forward-only and JAX differentiates the XLA attention instead),
recomputed by query block from the saved q, k, v and output in fp32:
P = softmax(masked q k^T * scale), dV = P^T dO, dS = P * (dO V^T -
rowsum(dO * O)), dQ = dS K * scale, dK = dS^T Q * scale, with dK and dV
summed over each KV head's G query heads.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import check_launch, check_tensor, entry

HEAD_DIMS = (32, 64, 128)


def _causal_mask(n_q: int, q0: int, n_k: int, device) -> torch.Tensor:
    """[n_q, n_k] bool: key position <= query position (q0 + row)."""
    qpos = q0 + torch.arange(n_q, device=device)
    return torch.arange(n_k, device=device)[None, :] <= qpos[:, None]


def attention_plain(q, k, v, *, causal: bool = True, scale=None):
    """The plain version of K9: q [B, S, H, D], k, v [B, S, K, D]; fp32
    scores (q . k) * scale (default 1 / sqrt(D)), masked causally to -inf,
    one fp32 softmax over every key, fp32 PV, cast to q's dtype once.
    Returns [B, S, H, D]."""
    B, S, H, D = q.shape
    K = k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    qg = q.float().reshape(B, S, K, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    if causal:
        s = s.masked_fill(~_causal_mask(S, 0, S, q.device), float("-inf"))
    a = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", a, v.float())
    return o.reshape(B, S, H, D).to(q.dtype)


# q, k, v, out, then B, S, H, K, D, causal, scale, bf16, stream
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                           ctypes.c_int,
                                                           ctypes.c_void_p]


def flash_attention(q, k, v, *, causal: bool = True, scale=None):
    """Attention of q [B, S, H, D] over k, v [B, S, K, D] (H % K == 0),
    fp32 scores (q . k) * scale with ``scale`` 1 / sqrt(D) by default (the
    FFMA body, fp32 or head dim 32, takes (q * scale) . k), causal or
    full.  On a CUDA device every tensor is a contiguous fp32 or bf16
    tensor of one dtype with D in 32, 64 or 128; anything else raises.
    Returns [B, S, H, D] in q's dtype."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, scale=scale)
    dev = q.device
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention: q must be fp32 or bf16, got "
                         f"{q.dtype}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        check_tensor(t, name, q.dtype, 4, dev)
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte "
                             "aligned")
    B, S, H, D = q.shape
    K = k.shape[2]
    if tuple(k.shape) != (B, S, K, D) or v.shape != k.shape or H % K \
            or D not in HEAD_DIMS:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}: need k, v [B, S, K, D] with H % K == 0 and "
            f"D in {HEAD_DIMS}")
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    out = torch.empty_like(q)
    rc = entry("flash_attention", _ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H, K,
        D, int(causal), scale, int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, "flash_attention")
    flash_attention.launches += 1
    mode = ("causal" if causal else "full", D)
    flash_attention.mode_launches[mode] = \
        flash_attention.mode_launches.get(mode, 0) + 1
    return out


flash_attention.launches = 0
# launches by (causal | full, head dim), counted beside ``launches``
flash_attention.mode_launches = {}


class _FlashAttention(torch.autograd.Function):
    """K9 forward, backward recomputed in torch ops by query block."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_block):
        o = flash_attention(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o)
        ctx.causal, ctx.scale, ctx.q_block = causal, scale, q_block
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        B, S, H, D = q.shape
        K = k.shape[2]
        G = H // K
        scale, causal = ctx.scale, ctx.causal
        kf, vf = k.float(), v.float()
        dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
        for i0 in range(0, S, ctx.q_block):
            n = min(ctx.q_block, S - i0)
            # causal: query rows [i0, i0 + n) see keys [0, i0 + n) only
            nk = i0 + n if causal else S
            kb, vb = kf[:, :nk], vf[:, :nk]
            qb = q[:, i0:i0 + n].float().reshape(B, n, K, G, D)
            dob = do[:, i0:i0 + n].float().reshape(B, n, K, G, D)
            ob = o[:, i0:i0 + n].float().reshape(B, n, K, G, D)
            s = torch.einsum("bqkgd,bskd->bkgqs", qb, kb) * scale
            if causal:
                s = s.masked_fill(~_causal_mask(n, i0, nk, q.device),
                                  float("-inf"))
            p = torch.softmax(s, dim=-1)                  # [B, K, G, n, nk]
            dv[:, :nk] += torch.einsum("bkgqs,bqkgd->bskd", p, dob)
            dp = torch.einsum("bqkgd,bskd->bkgqs", dob, vb)
            rowsum = torch.einsum("bqkgd,bqkgd->bkgq", dob, ob)
            ds = p * (dp - rowsum[..., None])
            dq[:, i0:i0 + n] = (torch.einsum("bkgqs,bskd->bqkgd", ds, kb)
                                * scale).reshape(B, n, H, D)
            dk[:, :nk] += torch.einsum("bkgqs,bqkgd->bskd", ds, qb) * scale
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, \
            None


def flash_attention_train(q, k, v, *, causal: bool = True, scale=None,
                          q_block: int = 512):
    """``flash_attention`` with a gradient: the forward launches K9 on the
    card (the plain version on the CPU); the backward recomputes the
    probabilities by blocks of ``q_block`` query rows in fp32 torch ops and
    never calls the forward again.  Returns [B, S, H, D]."""
    D = q.shape[-1]
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    return _FlashAttention.apply(q, k, v, causal, scale, q_block)
