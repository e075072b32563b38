"""Hand-written Hopper kernels: build, load and launch checks.

Every kernel here replaces one Pallas TPU kernel of ``repro.kernels`` and
follows one shape: a CUDA C++ source in ``repro_torch/csrc/`` with a plain C
entry point, compiled by ``nvcc`` for ``sm_90a`` into its own shared library
and loaded with ``ctypes``; a wrapper module (``paged_attention``,
``ragged_prefill``) that checks its tensors, allocates the output, launches
on PyTorch's current stream and counts its launches; and, beside it, the
plain PyTorch version of the same function.  A wrapper runs the plain
version only for tensors that lie on the CPU; for CUDA tensors it launches
the kernel or raises.

The build happens at the first CUDA launch (or ``build_all()``): one
``nvcc`` per source, all started together, each output keyed by a hash of
its source and the flags, written under ``build/repro_torch/`` at the root
of the checkout.  Nothing is imported or compiled when this module loads.
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
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_ENTRIES: Dict[str, Callable[..., int]] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (CUDA_HOME, PATH, /usr/local/cuda); "
                       "the Hopper kernels are built from source at first use")


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Tuple[float, Dict[str, Path]]:
    """Compile every ``csrc/*.cu`` that has no up-to-date library yet, one
    ``nvcc`` process per source, all running at once.  Returns (seconds,
    {stem: library path}); raises with the compiler's output on failure."""
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


def refuse_modes(name: str, window: int, softcap: float, scales) -> None:
    """The TPU kernels' modes this slice does not port raise, naming the
    ROADMAP item that brings each."""
    if window:
        raise NotImplementedError(
            f"{name}: the sliding-window mode arrives with ROADMAP queue 1 "
            "item 11")
    if softcap:
        raise NotImplementedError(
            f"{name}: the logit-softcap mode is not ported (no registered "
            "arch sets attn_logit_softcap)")
    if any(x is not None for x in scales):
        raise NotImplementedError(
            f"{name}: int8 scale operands arrive with ROADMAP queue 1 item 8")


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                 ndim: int, device: torch.device) -> None:
    if t.dtype != dtype or t.dim() != ndim or t.device != device \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {ndim}-d {dtype} tensor on "
            f"{device}, got {tuple(t.shape)} {t.dtype} on {t.device} "
            f"(contiguous={t.is_contiguous()})")
