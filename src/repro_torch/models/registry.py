"""Model registry: ``build_model(cfg)``, parameter and cache init, and the
abstract input stand-ins of every (arch, shape) cell for the dry run
(``launch/dryrun.py``): ``meta`` tensors, as the JAX package's
``ShapeDtypeStruct`` trees."""
from __future__ import annotations

from typing import Dict

import torch

from ..configs.base import ArchConfig, ShapeConfig, supports
from .encdec import EncDecLM
from .params import ParamDef, abstract_tree, init_tree
from .transformer import DecoderLM

# where each arch that the port does not build yet arrives (ROADMAP queues)
_NOT_YET = (
    (lambda c: not c.enc_dec
     and c.family not in ("dense", "moe", "ssm", "hybrid", "vlm"),
     "only the dense, MoE, state-slot, vlm and enc-dec LM families are "
     "ported (ROADMAP queue 1)"),
)


def build_model(cfg: ArchConfig, attn_backend: str = "reference"):
    """Model for ``cfg``: ``EncDecLM`` for enc-dec archs, ``DecoderLM``
    otherwise; ``attn_backend`` is a concrete backend name
    (``models.attn_backend.resolve_backend`` turns ``auto`` into one)."""
    for test, why in _NOT_YET:
        if test(cfg):
            raise NotImplementedError(f"{cfg.name}: {why}")
    if cfg.enc_dec:
        return EncDecLM(cfg, attn_backend)
    return DecoderLM(cfg, attn_backend)


def input_defs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, ParamDef]:
    """ParamDef tree of every model input of this (arch, shape) cell, as
    the JAX function declares it: token ids, plus the stub frontend
    embeddings of the enc-dec (``frames``) and vlm (``image_embeds``)
    archs for training and prefill; one token a row for decode (the cache
    is ``abstract_cache``'s)."""
    ok, why = supports(cfg, shape)
    if not ok:
        raise ValueError(f"{cfg.name} x {shape.name}: {why}")
    B, S = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        if cfg.enc_dec:
            return {
                "frames": ParamDef((B, S, cfg.frontend_dim),
                                   ("batch", None, None), torch.bfloat16,
                                   "zeros"),
                "tokens": ParamDef((B, S), ("batch", None), torch.int32,
                                   "zeros"),
            }
        if cfg.n_image_tokens:
            return {
                "tokens": ParamDef((B, S - cfg.n_image_tokens),
                                   ("batch", None), torch.int32, "zeros"),
                "image_embeds": ParamDef(
                    (B, cfg.n_image_tokens, cfg.frontend_dim),
                    ("batch", None, None), torch.bfloat16, "zeros"),
            }
        return {"tokens": ParamDef((B, S), ("batch", None), torch.int32,
                                   "zeros")}
    # decode: one new token against a seq_len cache
    return {"tokens": ParamDef((B,), ("batch",), torch.int32, "zeros")}


def input_specs(cfg: ArchConfig, shape: ShapeConfig, mesh=None):
    """``meta`` stand-ins for every model input, at each device's local
    shape under ``mesh`` (no allocation)."""
    return abstract_tree(input_defs(cfg, shape), mesh)


def abstract_params(cfg: ArchConfig, mesh=None):
    return abstract_tree(build_model(cfg).param_defs(), mesh)


def cache_defs_with_pos(cfg: ArchConfig, batch: int, max_len: int):
    """The static decode cache's defs as the JAX package declares them:
    the model's ``cache_defs`` plus ``pos`` [batch] int32, which the
    port's decode step reads (``DecoderLM.decode``) but its
    ``cache_defs`` leaves to ``prefill``."""
    return {**build_model(cfg).cache_defs(batch, max_len),
            "pos": ParamDef((batch,), ("batch",), torch.int32, "zeros")}


def abstract_cache(cfg: ArchConfig, shape: ShapeConfig, mesh=None):
    return abstract_tree(cache_defs_with_pos(cfg, shape.global_batch,
                                             shape.seq_len), mesh)


def init_params(cfg: ArchConfig, seed: int, device):
    """Random parameters drawn from ``seed`` on ``device`` (see
    ``models.params`` for how the draw depends on the device)."""
    return init_tree(build_model(cfg).param_defs(), seed, device)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device, **kw):
    """A zeroed contiguous cache for the static path (``kw``: the enc-dec
    cache's ``enc_len``)."""
    return init_tree(build_model(cfg).cache_defs(batch, max_len, **kw), 0,
                     device)
