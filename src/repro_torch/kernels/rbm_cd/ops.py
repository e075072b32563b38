"""Fused GEMM + bias + sigmoid, the RBM contrastive-divergence hot loop:
kernel K8.

``gemm_sigmoid`` replaces ``repro.kernels.rbm_cd.ops.gemm_sigmoid`` (Pallas
``kernel.py::gemm_sigmoid_fwd``).  For CUDA tensors it launches the
hand-written kernel in ``csrc/gemm_sigmoid.cu`` (design and bound in its
note); for CPU tensors it runs ``gemm_sigmoid_plain``, the plain PyTorch
version of the same function (``repro.kernels.rbm_cd.ref``), which is also
the kernel's oracle on the card.
"""
from __future__ import annotations

import ctypes

import torch

from .. import check_launch, check_tensor, entry


def gemm_sigmoid_plain(x, w, b):
    """sigmoid(x @ w + b) with an fp32 product, bias and sigmoid, cast to
    ``x``'s dtype once.  x: [M, K]; w: [K, N]; b: [N]."""
    return torch.sigmoid(x.float() @ w.float() + b.float()).to(x.dtype)


# x, w, b, out, then M, N, K, w_sk, w_sn, bf16, stream
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def gemm_sigmoid(x, w, b):
    """sigmoid(x @ w + b); arguments as ``gemm_sigmoid_plain``.  On a CUDA
    device ``x`` is a contiguous fp32 or bf16 [M, K] tensor, ``b`` a
    contiguous [N] tensor of the same dtype and ``w`` a [K, N] tensor of
    that dtype with positive strides: row-major, or the transposed view
    ``W.T`` of a row-major [N, K] weight, which the kernel reads by index
    (the RBM's negative phase).  Anything else raises.  Returns [M, N] in
    ``x``'s dtype."""
    if x.device.type == "cpu":
        return gemm_sigmoid_plain(x, w, b)
    dev = x.device
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gemm_sigmoid: x must be fp32 or bf16, got "
                         f"{x.dtype}")
    check_tensor(x, "x", x.dtype, 2, dev)
    check_tensor(b, "b", x.dtype, 1, dev)
    M, K = x.shape
    if w.dtype != x.dtype or w.dim() != 2 or w.device != dev \
            or tuple(w.shape) != (K, b.shape[0]) \
            or min(w.stride()) < 1:
        raise ValueError(
            f"gemm_sigmoid: w must be a [{K}, {b.shape[0]}] {x.dtype} tensor "
            f"on {dev} with positive strides, got {tuple(w.shape)} "
            f"{w.dtype} strides {w.stride()} on {w.device}")
    N = w.shape[1]
    out = torch.empty((M, N), dtype=x.dtype, device=dev)
    rc = entry("gemm_sigmoid", _ARGTYPES)(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
        w.stride(0), w.stride(1), int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, "gemm_sigmoid")
    gemm_sigmoid.launches += 1
    return out


gemm_sigmoid.launches = 0
