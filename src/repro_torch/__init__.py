"""repro_torch — the PyTorch/CUDA port of ``repro``, run on an NVIDIA H100.

The package mirrors ``repro``'s layout module for module and imports
``torch``, never ``jax`` and nothing of ``repro`` (framework-free modules
are kept here as copies, held to their originals by a drift test).  Its
paged-attention hot loop runs through kernels written by hand for Hopper
(``kernels/``, CUDA sources in ``csrc/``).  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; asking for ``cuda`` on a machine
without a card raises instead of falling back.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``cuda`` without a visible card
    raises: a measurement or serving run never silently moves to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False (torch " + torch.__version__ + "); pass device='cpu' / "
            "--device cpu to run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
