"""Hand-written Hopper kernels: build, load and launch checks.

Every kernel here replaces one Pallas TPU kernel of ``repro.kernels`` and
follows one shape: a CUDA C++ source in ``repro_torch/csrc/`` with a plain C
entry point, compiled by ``nvcc`` for ``sm_90a`` into its own shared library
and loaded with ``ctypes``; a wrapper module (``paged_attention``,
``ragged_prefill``, ``rbm_cd``, ``flash_attention``) that checks its tensors, allocates the
output, launches on PyTorch's current stream and counts its launches; and,
beside it, the plain PyTorch version of the same function.  A wrapper runs the plain
version only for tensors that lie on the CPU; for CUDA tensors it launches
the kernel or raises.

The build happens at the first CUDA launch (or ``build_all()``): one
``nvcc`` per source, all started together, each output keyed by a hash of
its source, the shared headers (``*.cuh``) and the flags, written under
``build/repro_torch/`` at the root of the checkout.  Nothing is imported or
compiled when this module loads.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_ENTRIES: Dict[str, Callable[..., int]] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (CUDA_HOME, PATH, /usr/local/cuda); "
                       "the Hopper kernels are built from source at first use")


def _target(src: Path) -> Path:
    """The library built from ``src``, keyed by the source, every shared
    header of ``csrc/`` and the flags."""
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Tuple[float, Dict[str, Path]]:
    """Compile every ``csrc/*.cu`` that has no up-to-date library yet, one
    ``nvcc`` process per source, all running at once.  Returns (seconds,
    {stem: library path}); raises with the compiler's output on failure.
    The compiler's output (``ptxas`` registers, spills and shared memory of
    every kernel) is kept beside each library as ``<library>.log``."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo, out = [], {}
    for src in sorted(CSRC.glob("*.cu")):
        so = _target(src)
        out[src.stem] = so
        if not so.exists():
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            todo.append((so, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    errors = []
    for so, tmp, proc in todo:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{so.name}: nvcc exit {proc.returncode}\n{log}")
        else:
            so.with_suffix(".log").write_text(log)
            os.replace(tmp, so)       # atomic: concurrent builders agree
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0, out


def entry(stem: str, argtypes) -> Callable[..., int]:
    """The C entry point ``stem`` of the library built from
    ``csrc/<stem>.cu``, loaded and given its signature (``argtypes``,
    ``int`` result) once; later calls return the bound function."""
    if stem not in _ENTRIES:
        _, paths = build_all()
        fn = getattr(ctypes.CDLL(str(paths[stem])), stem)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _ENTRIES[stem] = fn
    return _ENTRIES[stem]


def check_launch(rc: int, name: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error (its
    ``cudaGetLastError()`` after the launch, or a refused configuration)."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} "
                           f"({torch.cuda.get_device_name()})")


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                 ndim: int, device: torch.device) -> None:
    if t.dtype != dtype or t.dim() != ndim or t.device != device \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {ndim}-d {dtype} tensor on "
            f"{device}, got {tuple(t.shape)} {t.dtype} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def check_pool(name, dev, k_pages, v_pages, tables, k_scale, v_scale):
    """Device, dtype, layout and shape checks of a paged pool, its scale
    pages and its tables (shared by K1, K2, K3 and K4); returns (P, ps, K,
    D) of the pool."""
    payload = torch.bfloat16 if k_scale is None else torch.int8
    check_tensor(k_pages, "k_pages", payload, 4, dev)
    check_tensor(v_pages, "v_pages", payload, 4, dev)
    check_tensor(tables, "tables", torch.int32, 2, dev)
    if (k_scale is None) != (v_scale is None):
        raise ValueError(f"{name}: k_scale and v_scale come together")
    if k_scale is not None:
        check_tensor(k_scale, "k_scale", torch.bfloat16, 3, dev)
        check_tensor(v_scale, "v_scale", torch.bfloat16, 3, dev)
        if k_scale.shape != k_pages.shape[:3] \
                or v_scale.shape != k_pages.shape[:3]:
            raise ValueError(
                f"{name}: scale pages {tuple(k_scale.shape)}/"
                f"{tuple(v_scale.shape)} do not match the payload "
                f"{tuple(k_pages.shape)}")
    if v_pages.shape != k_pages.shape:
        raise ValueError(f"{name}: k_pages {tuple(k_pages.shape)} and "
                         f"v_pages {tuple(v_pages.shape)} differ")
    return k_pages.shape


def check_latent_pool(name, dev, ckv_pages, krope_pages, tables, ckv_scale,
                      krope_scale):
    """Device, dtype, layout and shape checks of an MLA latent pool (ckv
    [P, ps, L], krope [P, ps, R]; bf16, or int8 with contiguous bf16 scale
    pages [P, ps] for both), its scale pages and its tables (shared by K5,
    K6 and K7); returns (P, ps, L, R)."""
    payload = torch.bfloat16 if ckv_scale is None else torch.int8
    check_tensor(ckv_pages, "ckv_pages", payload, 3, dev)
    check_tensor(krope_pages, "krope_pages", payload, 3, dev)
    check_tensor(tables, "tables", torch.int32, 2, dev)
    if (ckv_scale is None) != (krope_scale is None):
        raise ValueError(f"{name}: ckv_scale and krope_scale come together")
    P, ps, L = ckv_pages.shape
    R = krope_pages.shape[2]
    if tuple(krope_pages.shape[:2]) != (P, ps):
        raise ValueError(f"{name}: ckv {tuple(ckv_pages.shape)} and krope "
                         f"{tuple(krope_pages.shape)} pages differ")
    if ckv_scale is not None:
        check_tensor(ckv_scale, "ckv_scale", torch.bfloat16, 2, dev)
        check_tensor(krope_scale, "krope_scale", torch.bfloat16, 2, dev)
        if tuple(ckv_scale.shape) != (P, ps) \
                or tuple(krope_scale.shape) != (P, ps):
            raise ValueError(
                f"{name}: scale pages {tuple(ckv_scale.shape)}/"
                f"{tuple(krope_scale.shape)} do not match the payload "
                f"{(P, ps)}")
    return P, ps, L, R


def ptr(t):
    """A tensor's device address for a C entry point; None (NULL) for an
    absent optional operand."""
    return None if t is None else t.data_ptr()
