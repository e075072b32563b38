"""Fused GEMM + bias + sigmoid, the RBM contrastive-divergence hot loop:
kernel K8.

``gemm_sigmoid`` replaces ``repro.kernels.rbm_cd.ops.gemm_sigmoid`` (Pallas
``kernel.py::gemm_sigmoid_fwd``).  For CUDA tensors it launches the
hand-written kernel in ``csrc/gemm_sigmoid.cu`` (design and bound in its
note); for CPU tensors it runs ``gemm_sigmoid_plain``, the plain PyTorch
version of the same function (``repro.kernels.rbm_cd.ref``), which is also
the kernel's oracle on the card.

The kernel sums K in splits of whole 32-wide slices (``split_plan``, a
function of N and K only, so a row computed alone sums in the order it
does in a batch).  Where the output tiles alone would leave the card
short of blocks, each split is a block of its own and the splits of a
tile a cluster of blocks, which add their partials in split order through
each other's shared memory.  Else, for N above one tile of features, a
first kernel of the same call writes w's TF32 planes to a workspace the
wrapper allocates (``workspace``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import check_launch, check_tensor, entry

TILE_N = 64          # output features a block: the tensor-core tile's rows
TILE_M = 128         # batch rows a block: the tensor-core tile's columns
SLICE = 32           # k of a staged slice
SMS = 132            # SMs of an H100 SXM: the blocks a split plan aims for
MAX_SPLITS = 16      # the blocks of a cluster (H100, non-portable)


def gemm_sigmoid_plain(x, w, b):
    """sigmoid(x @ w + b) with an fp32 product, bias and sigmoid, cast to
    ``x``'s dtype once.  x: [M, K]; w: [K, N]; b: [N]."""
    return torch.sigmoid(x.float() @ w.float() + b.float()).to(x.dtype)


def split_plan(N: int, K: int):
    """(slices a split, splits) of K: about ``SMS`` blocks over the N
    tiles of one batch tile, at most ``MAX_SPLITS`` splits, each of whole
    ``SLICE``-wide slices; split s sums k in [s * per * SLICE, (s + 1) *
    per * SLICE)."""
    slices = -(-K // SLICE)
    per = -(-slices // min(MAX_SPLITS, -(-SMS // -(-N // TILE_N))))
    return per, -(-slices // per)


def grid_splits(M: int, N: int, K: int) -> int:
    """Splits run as blocks of their own (a cluster a tile) when the
    output tiles alone give fewer than ``SMS`` blocks; else 1: each block
    sums its splits in order itself."""
    splits = split_plan(N, K)[1]
    tiles = -(-M // TILE_M) * -(-N // TILE_N)
    return splits if splits > 1 and tiles < SMS else 1


def workspace(M: int, N: int, K: int) -> int:
    """fp32 values of the kernel's workspace: w's two TF32 planes [N, K
    rounded up to 4] when the splits run in each block and N is above one
    tile of features; else none."""
    if grid_splits(M, N, K) > 1 or N <= TILE_N:
        return 0
    return 2 * N * (-(-K // 4) * 4)


@functools.lru_cache(maxsize=256)
def call_plan(M: int, N: int, K: int):
    """(slices a split, splits, splits as blocks, workspace values) of a
    call, worked out once a shape."""
    per, splits = split_plan(N, K)
    return per, splits, grid_splits(M, N, K), workspace(M, N, K)


# x, w, b, out, workspace, then M, N, K, w_sk, w_sn, bf16, slices a split,
# splits, splits as blocks, stream
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


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
    N = b.shape[0]
    w_sk, w_sn = w.stride() if w.dim() == 2 else (0, 0)
    if w.dtype != x.dtype or w.device != dev or w.shape != (K, N) \
            or w_sk < 1 or w_sn < 1:
        raise ValueError(
            f"gemm_sigmoid: w must be a [{K}, {N}] {x.dtype} tensor "
            f"on {dev} with positive strides, got {tuple(w.shape)} "
            f"{w.dtype} strides {w.stride()} on {w.device}")
    per, splits, grid, n_ws = call_plan(M, N, K)
    out = torch.empty((M, N), dtype=x.dtype, device=dev)
    ws = torch.empty(n_ws, dtype=torch.float32, device=dev) if n_ws \
        else None
    rc = entry("gemm_sigmoid", _ARGTYPES)(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), M, N, K, w_sk, w_sn,
        int(x.dtype == torch.bfloat16), per, splits, grid,
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, "gemm_sigmoid")
    gemm_sigmoid.launches += 1
    return out


gemm_sigmoid.launches = 0
