"""Train and serve step factories: plain functions over (params, state,
inputs).

Two engines build the same training step, both through
``core.mapreduce.mapreduce_value_and_grad`` (gradients by
``torch.autograd``, ``n_micro`` microbatches accumulated in fp32):
  * ``pjit``      — one process, no reduce (the JAX package's
    sharding-constraint step, on one device);
  * ``mapreduce`` — the paper's explicit map/combine/reduce over the
    ``torch.distributed`` groups given, with the selectable reduce mode
    (allreduce | hierarchical | compressed int8 + error feedback, whose
    residual rides in the optimizer state as ``comp_err``).

The JAX package jits these; here they run eagerly.  The serve steps write
the paged pool in place, returning it so call sites read as they do in
``repro``; the train steps return new parameters and optimizer state
(``optim.apply_updates`` is out of place).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ArchConfig
from ..core.mapreduce import DPGroups, mapreduce_value_and_grad
from ..optim import OptConfig, apply_updates, opt_state_defs
from .params import ParamDef, abstract_tree, tree_map_defs
from .registry import build_model, cache_defs_with_pos, input_defs
from .shardings import tree_specs


# ------------------------------------------------------------- train steps

def make_train_step(cfg: ArchConfig, opt_cfg: OptConfig, *,
                    engine: str = "pjit", reduce_mode: str = "allreduce",
                    n_micro: int = 1, groups: Optional[DPGroups] = None,
                    attn_backend: str = "reference"):
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``batch`` is {"tokens": [B, S] int} on the model's device,
    plus the frontend input of the archs that take one, as JAX
    ``registry.input_defs`` declares them: "frames" [B, S_enc,
    frontend_dim] for enc-dec, "image_embeds" [B, n_image_tokens,
    frontend_dim] for the vlm (every tensor is split on dim 0 into the
    ``n_micro`` microbatches); ``metrics`` {"loss", "grad_norm", "lr"} as
    0-d tensors.  ``groups`` is the mapreduce engine's process layout
    (None: local evaluation, as a mesh of one device); ``attn_backend`` a
    concrete backend name (``hopper`` runs the training attention through
    K9)."""
    if engine not in ("pjit", "mapreduce"):
        raise ValueError(f"unknown engine {engine!r} (pjit | mapreduce)")
    model = build_model(cfg, attn_backend)
    # on one process the pjit step is the mapper and combiner alone: the
    # same microbatch loop and fp32 accumulation, with no reduce
    mr = mapreduce_value_and_grad(
        model.loss, groups if engine == "mapreduce" else None,
        reduce_mode=reduce_mode, n_micro=n_micro)

    def step(params, opt_state, batch):
        loss, grads, new_err, _ = mr(params, batch,
                                     opt_state.get("comp_err"))
        inner = {k: v for k, v in opt_state.items() if k != "comp_err"}
        params, inner, om = apply_updates(params, grads, inner, opt_cfg)
        if new_err is not None:
            inner["comp_err"] = new_err
        return params, inner, {"loss": loss, **om}
    return step


def whole_state(odefs):
    """The optimizer state's defs as the port lays them out: the ``zero``
    axis dropped (no ZeRO: each process holds the whole state)."""
    return tree_map_defs(lambda _, d: ParamDef(
        d.shape, tuple(None if a == "zero" else a for a in d.logical),
        d.dtype, d.init), odefs)


def _train_defs(cfg: ArchConfig, shape, opt_cfg: OptConfig):
    pdefs = build_model(cfg).param_defs()
    return (pdefs, whole_state(opt_state_defs(pdefs, opt_cfg)),
            input_defs(cfg, shape))


def train_shardings(cfg: ArchConfig, shape, mesh, opt_cfg: OptConfig):
    """(params, opt_state, batch) spec trees of the train step's
    arguments on ``mesh``."""
    return tuple(tree_specs(d, mesh)
                 for d in _train_defs(cfg, shape, opt_cfg))


def abstract_train_args(cfg: ArchConfig, shape, mesh, opt_cfg: OptConfig):
    """(params, opt_state, batch) as ``meta`` tensors at one device's
    local shape on ``mesh``: no allocation."""
    return tuple(abstract_tree(d, mesh)
                 for d in _train_defs(cfg, shape, opt_cfg))


# ------------------------------------------------------------- serve steps

def make_serve_step(cfg: ArchConfig, kind: str,
                    attn_backend: str = "reference"):
    """kind='decode': step(params, cache, tokens) -> (next_tokens, cache)
       kind='prefill': step(params, batch) -> (logits, cache)
       kind='prefill_at': step(params, batch, last_idx) -> (logits, cache)
         (logits read at per-row position ``last_idx`` — bucketed prompts)
       kind='decode_paged': step(params, kv, state, meta, tokens)
         -> (next_tokens, ok, kv, state) — slot-indexed continuous-batching
         decode against the paged pool.  ``meta`` is the flat per-step
         metadata from ``attn_backend.decode_meta``.  ``ok`` is a per-row
         bool: True iff every logit in that row is finite — the engine's
         NaN/inf quarantine guard.
       kind='verify_paged': step(params, kv, state, meta, tokens)
         -> (next_tokens [B, Q], ok [B], kv, state) — small-q speculative
         verify: ``tokens`` is [B, Q] (last emitted token + draft per slot),
         ``meta`` from ``attn_backend.verify_meta``; row j of the output is
         the greedy next token after position pos + j.  ``ok`` reduces
         finiteness over both the Q and vocab axes.
       kind='prefill_paged': step(params, kv, state, meta, tokens, extras)
         -> (logits, kv, state) — batched chunk prefill straight into the
         pool; ``meta`` from ``attn_backend.prefill_meta``; ``extras`` the
         frontend inputs ({"frames"} for enc-dec, {"image_embeds"} for vlm,
         {} otherwise).
       kind='prefill_paged_cont': the same for enc-dec chunks after the
         first: no encoder, the cross K/V read from the state slots
         (``extras`` unused).

       ``attn_backend`` selects the backend the paged kinds route through
       (``reference`` gather+attend | ``hopper`` kernels)."""
    model = build_model(cfg, attn_backend)
    if kind == "decode":
        def step(params, cache, tokens):
            logits, cache = model.decode(params, cache, tokens)
            return logits.argmax(-1).to(torch.int32), cache
        return step
    if kind == "decode_paged":
        def step(params, kv, state, meta, tokens):
            logits, kv, state = model.decode_paged(params, kv, state, meta,
                                                   tokens)
            nxt = logits.argmax(-1).to(torch.int32)
            ok = torch.isfinite(logits).all(-1)
            return nxt, ok, kv, state
        return step
    if kind == "verify_paged":
        def step(params, kv, state, meta, tokens):
            logits, kv, state = model.verify_paged(params, kv, state, meta,
                                                   tokens)
            nxt = logits.argmax(-1).to(torch.int32)
            ok = torch.isfinite(logits).all(-1).all(-1)
            return nxt, ok, kv, state
        return step
    if kind == "prefill_paged":
        def step(params, kv, state, meta, tokens, extras):
            return model.prefill_paged(params, kv, state, meta, tokens,
                                       extras)
        return step
    if kind == "prefill_paged_cont":
        def step(params, kv, state, meta, tokens, extras):
            return model.prefill_paged(params, kv, state, meta, tokens,
                                       continuation=True)
        return step
    if kind == "prefill_at":
        def step(params, batch, last_idx):
            return model.prefill(params, batch, logits_idx=last_idx)
        return step
    if kind != "prefill":
        raise ValueError(f"unknown serve step kind {kind!r}")

    def step(params, batch):
        return model.prefill(params, batch)
    return step


def _serve_defs(cfg: ArchConfig, shape):
    pdefs = build_model(cfg).param_defs()
    bdefs = input_defs(cfg, shape)
    if shape.kind == "decode":
        return (pdefs, cache_defs_with_pos(cfg, shape.global_batch,
                                           shape.seq_len), bdefs["tokens"])
    return pdefs, bdefs


def abstract_serve_args(cfg: ArchConfig, shape, mesh):
    """The serve step's arguments as ``meta`` tensors at one device's
    local shape: (params, cache with ``pos``, tokens) for decode, (params,
    batch) for prefill."""
    return tuple(abstract_tree(d, mesh) for d in _serve_defs(cfg, shape))


def serve_shardings(cfg: ArchConfig, shape, mesh):
    return tuple(tree_specs(d, mesh) for d in _serve_defs(cfg, shape))
