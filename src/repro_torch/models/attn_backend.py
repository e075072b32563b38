"""Attention-backend registry: one dispatch point for every paged path.

The serving hot loop is paged attention — prefill writes K/V through
per-request page tables, decode reads every live token back per step.  How
that read happens is a *backend* choice:

* ``reference`` — plain PyTorch gather+attend (``pool[tables]``
  materializes the logical view, then dense masked attention): the plain
  versions of the kernels, and the parity oracle on every device.
* ``hopper`` — the kernels written by hand for Hopper:
  ``kernels.paged_attention`` (K1) for decode and ``kernels.ragged_prefill``
  (K2) for chunk prefill.  Both walk the page table inside the kernel, so
  the gather never materializes.

A backend implements the two *attend cores* of the dense decoder
(``decode_attend``, ``prefill_attend``); the family framing (QKV
projection, RoPE, page-table scatter, output projection) is shared code in
``models.attention``.  Model code routes through ``backend.paged_prefill``
/ ``backend.paged_decode``.

Selection follows ``ServeConfig.attn_backend`` (``auto`` | ``reference`` |
``hopper``).  ``auto`` resolves by the device the tensors live on: ``cuda``
gives ``hopper``, ``cpu`` gives ``reference``; ``hopper`` on the CPU raises.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..kernels.paged_attention import paged_decode, paged_decode_plain
from ..kernels.ragged_prefill import ragged_prefill, ragged_prefill_plain
from . import attention

# ---------------------------------------------------------------- registry

_REGISTRY: Dict[str, "AttentionBackend"] = {}


def register_backend(cls):
    """Class decorator: instantiate and register under ``cls.name``."""
    _REGISTRY[cls.name] = cls()
    return cls


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def resolve_backend(name: str, device) -> str:
    """Resolve a ``ServeConfig.attn_backend`` knob against the device the
    model runs on: ``auto`` is ``hopper`` for ``cuda`` and ``reference``
    for ``cpu``; an explicit ``hopper`` off the card raises."""
    dev = torch.device(device)
    if name == "auto":
        return "hopper" if dev.type == "cuda" else "reference"
    if name not in _REGISTRY:
        raise ValueError(f"unknown attention backend {name!r}; "
                         f"available: {available_backends()}")
    if name == "hopper" and dev.type != "cuda":
        raise ValueError("attn_backend='hopper' launches CUDA kernels; the "
                         f"model runs on {str(dev)!r}")
    return name


def get_backend(name: str) -> "AttentionBackend":
    """A registered backend by concrete name (resolve ``auto`` first)."""
    if name not in _REGISTRY:
        raise ValueError(f"unknown attention backend {name!r}; "
                         f"available: {available_backends()}")
    return _REGISTRY[name]


# ----------------------------------------------------- flat decode metadata

def decode_meta(cfg: ArchConfig, page_size: int, tables: np.ndarray,
                pos: np.ndarray):
    """Flat per-step decode metadata, computed once on the host instead of
    re-derived by every layer: the page-table rows, per-row absolute
    positions, and the physical (page, offset) write target of the step's
    new token.  numpy in, numpy out (int32)."""
    B = tables.shape[0]
    # live rows always have col < table width; the clamp covers idle rows
    col = np.minimum(pos // page_size, tables.shape[1] - 1)
    return {"tables": tables, "pos": pos,
            "write_page": tables[np.arange(B), col],
            "write_off": pos % page_size}


# ---------------------------------------------------- flat prefill metadata

def prefill_meta(cfg: ArchConfig, page_size: int, tables: np.ndarray,
                 slots: np.ndarray, start: np.ndarray, n_tail: np.ndarray,
                 T: int):
    """Flat per-step prefill metadata, the prefill twin of ``decode_meta``:
    page-table rows, decode-row indices of the rows, each row's chunk offset
    (``start``, absolute position of the chunk's first token) and live token
    count, and the physical (page, offset) write target of every chunk
    position — padding positions routed to the reserved null page.  ``T`` is
    the chunk width (the prefill bucket).  numpy in, numpy out."""
    B = tables.shape[0]
    positions = start[:, None] + np.arange(T)[None, :]            # [B, T]
    n_live = n_tail + cfg.n_image_tokens
    live = np.arange(T)[None, :] < n_live[:, None]
    col = np.minimum(positions // page_size, tables.shape[1] - 1)
    page = tables[np.arange(B)[:, None], col]
    return {"tables": tables, "slots": slots, "start": start,
            "n_tail": n_tail, "n_live": n_live,
            "write_page": np.where(live, page, 0).astype(np.int32),
            "write_off": (positions % page_size).astype(np.int32)}


def meta_to_device(meta, device) -> Dict[str, torch.Tensor]:
    """Move a host-built meta dict to the model's device as int32 tensors."""
    return {k: torch.as_tensor(np.ascontiguousarray(v, np.int32),
                               device=device)
            for k, v in meta.items()}


# ----------------------------------------------------------- backend classes

class AttentionBackend:
    """Family routing (shared) + attend cores (the extension point)."""

    name = "abstract"

    # -------- public entry points: the only paged-attention call sites

    def paged_prefill(self, cfg: ArchConfig, p, x, cache, meta, freqs, *,
                      q_block: int = 512):
        """Multi-token chunk prefill at an offset into the paged pool.
        ``meta`` is the flat per-step metadata from ``prefill_meta``;
        returns (out [B, T, d], cache)."""
        return attention.paged_prefill_attention_block(
            cfg, p, x, cache, meta, freqs, backend=self, q_block=q_block)

    def paged_decode(self, cfg: ArchConfig, p, x, cache, meta, freqs):
        """One-token decode against the paged pool.  ``meta`` is the flat
        per-step metadata from ``decode_meta``; returns (out [B, d],
        cache)."""
        return attention.paged_decode_attention_block(cfg, p, x, cache, meta,
                                                      freqs, backend=self)

    # -------- attend cores (override to fuse)

    def decode_attend(self, q, k_pages, v_pages, tables, pos, *,
                      scale: float):
        """q: [B, H, D]; pools [P, ps, K, D]; tables [B, n]; pos [B].
        Returns [B, H, D]."""
        raise NotImplementedError

    def prefill_attend(self, q, k_pages, v_pages, tables, start, *,
                       scale: float, q_block: int = 512):
        """Ragged multi-token prefill attend against the *post-write* paged
        pool: q [B, T, H, D] roped chunk queries at per-row offsets
        ``start``, scores times ``scale``.  ``q_block`` bounds the plain
        version's fp32 score memory; a kernel tiles its own queries and
        ignores it.  Returns [B, T, H, D]."""
        raise NotImplementedError


@register_backend
class ReferenceBackend(AttentionBackend):
    """Plain PyTorch gather+attend — the parity oracle, and the plain
    versions of the Hopper kernels."""

    name = "reference"

    def decode_attend(self, q, k_pages, v_pages, tables, pos, *,
                      scale: float):
        return paged_decode_plain(q, k_pages, v_pages, tables, pos,
                                  scale=scale)

    def prefill_attend(self, q, k_pages, v_pages, tables, start, *,
                       scale: float, q_block: int = 512):
        return ragged_prefill_plain(q, k_pages, v_pages, tables, start,
                                    scale=scale, q_block=q_block)


def _on_card(q: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError("the hopper backend launches CUDA kernels; got "
                         f"tensors on {str(q.device)!r}")


@register_backend
class HopperBackend(AttentionBackend):
    """The hand-written Hopper kernels: K1 (``paged_decode``) for decode and
    K2 (``ragged_prefill``) for chunk prefill."""

    name = "hopper"

    def decode_attend(self, q, k_pages, v_pages, tables, pos, *,
                      scale: float):
        _on_card(q)
        return paged_decode(q.contiguous(), k_pages, v_pages, tables, pos,
                            scale=scale)

    def prefill_attend(self, q, k_pages, v_pages, tables, start, *,
                       scale: float, q_block: int = 512):
        _on_card(q)
        return ragged_prefill(q.contiguous(), k_pages, v_pages, tables, start,
                              scale=scale)
