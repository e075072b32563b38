"""The paper's contribution, MapReduce training, on ``torch.distributed``:
the port of ``repro.core.mapreduce``.

Roles (paper -> here):
  * **mapper**   — the per-microbatch update computation (gradients from
    ``torch.autograd``, or an explicit statistic such as the RBM's CD
    statistics) on each process's own shard of the batch.
  * **combiner** — the sum over the process's microbatches, before anything
    crosses the network (Hadoop's combiner).
  * **reducer**  — the cross-process per-weight sum: one collective is the
    shuffle and the reduce, and delivers the result to every mapper (the
    paper's distributed-cache broadcast folded into the same op).

Reduce modes (``REDUCE_MODES``, all equal up to quantization):
  * ``allreduce``    — one all-reduce over every process;
  * ``hierarchical`` — an all-reduce inside each pod (the ``data`` group),
    then one across pods (the ``pod`` group): only an already-reduced
    tensor takes the slow cross-pod hop;
  * ``compressed``   — full precision inside the pod, then int8 with error
    feedback across pods (``optim.compression``): each pod's quantized sum
    and block scales go round by ``all_gather`` and every process
    dequantizes and sums them itself.

Where the JAX package maps over the data axes of a device mesh with
``shard_map``, each process here runs the same step on its own shard and
the groups of ``DPGroups`` stand for the mesh's ``pod`` and ``data`` axes.
``group=None`` runs everything locally, as ``mesh=None`` does; a group of
one process still runs its collectives, as a one-device mesh does.

``reduce_plan`` lists, without a process group, the collectives one step
issues in each process: what the dry run (``launch/dryrun.py``) costs in
place of the collectives the JAX package parses from compiled HLO.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from ..optim import compression
from ..models.params import tree_leaves, tree_map, tree_unflatten

REDUCE_MODES = ("allreduce", "hierarchical", "compressed")


@dataclasses.dataclass
class DPGroups:
    """The data-parallel layout of the processes, the mesh's ``pod`` x
    ``data`` axes: rank ``r`` is process ``r % n_data`` of pod ``r //
    n_data``.  ``world`` spans every process, ``data`` this process's pod
    and ``pod`` the processes holding the same place in every pod (None
    where that axis has one process)."""
    n_pod: int
    n_data: int
    world: Optional[object]
    data: Optional[object]
    pod: Optional[object]

    @property
    def size(self) -> int:
        return self.n_pod * self.n_data


def dp_groups(n_pod: int = 1) -> DPGroups:
    """Build the groups over the initialized default process group, split
    into ``n_pod`` pods.  Every process must call this, in the same order
    (``new_group`` is collective)."""
    world = dist.get_world_size()
    if world % n_pod:
        raise ValueError(f"{world} processes do not split into {n_pod} pods")
    n_data = world // n_pod
    rank = dist.get_rank()
    data = pod = None
    if n_pod > 1:
        for p in range(n_pod):
            g = dist.new_group(list(range(p * n_data, (p + 1) * n_data)))
            if rank // n_data == p:
                data = g
        for d in range(n_data):
            g = dist.new_group(list(range(d, world, n_data)))
            if rank % n_data == d:
                pod = g
    else:
        data = dist.group.WORLD
    return DPGroups(n_pod, n_data, dist.group.WORLD, data, pod)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    t = t.clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


# ------------------------------------------------------------------ reducers

def reduce_tree(grads, groups: Optional[DPGroups], mode: str, err=None):
    """Cross-process sum of a gradient tree.  Returns (reduced grads, new
    error-feedback state); ``err`` is the ``compressed`` mode's state (a
    tree of fp32 tensors like ``grads``, or None for zeros)."""
    if groups is None:
        return grads, err
    if mode == "allreduce" or groups.n_pod == 1 or groups.n_data == 1:
        return tree_map(lambda g: _all_reduce(g, groups.world), grads), err
    if mode == "hierarchical":
        g = tree_map(lambda g: _all_reduce(g, groups.data), grads)
        return tree_map(lambda g: _all_reduce(g, groups.pod), g), err

    # compressed: full precision inside the pod, int8 + EF across pods
    assert mode == "compressed", mode
    local = tree_map(lambda g: _all_reduce(g, groups.data), grads)
    if err is None:
        err = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                             device=g.device), local)

    def xpod(g, e):
        corrected = g.float() + e
        q, scale = compression.quantize_int8(corrected)
        new_e = corrected - compression.dequantize_int8(q, scale, g.shape,
                                                        torch.float32)
        # the wire carries int8 values and fp32 block scales
        q_all = [torch.empty_like(q) for _ in range(groups.n_pod)]
        s_all = [torch.empty_like(scale) for _ in range(groups.n_pod)]
        dist.all_gather(q_all, q, group=groups.pod)
        dist.all_gather(s_all, scale, group=groups.pod)
        summed = torch.sum(torch.stack([a.float() * s for a, s in
                                        zip(q_all, s_all)]), dim=0)
        return (summed.reshape(-1)[:g.numel()].reshape(g.shape).to(g.dtype),
                new_e)

    outs = [xpod(g, e) for (_, g), (_, e) in zip(tree_leaves(local),
                                                 tree_leaves(err))]
    return (tree_unflatten(local, [o[0] for o in outs]),
            tree_unflatten(local, [o[1] for o in outs]))


# ------------------------------------------------------------- the plan

def reduce_plan(grad_defs, n_pod: int, n_data: int,
                reduce_mode: str = "allreduce") -> List[Dict]:
    """The collectives one MapReduce train step (``engine="mapreduce"``
    over ``dp_groups(n_pod)`` with ``n_pod * n_data`` processes) issues in
    each process, in order: ``{"op", "bytes", "groups"}``.  ``grad_defs``
    is the parameters' def tree (the gradients are reduced in fp32);
    ``bytes`` is the result's size (an all-gather's gathered tensors) and
    ``groups`` the ranks of every group that makes the call at once.
    ``reduce_tree``'s order: each leaf's reduce, per mode, then the loss's
    all-reduce.  What a call costs on the wire is the analysis's
    (``launch.analysis.collective_summary``)."""
    if reduce_mode not in REDUCE_MODES:
        raise ValueError(f"reduce_mode {reduce_mode!r} not in {REDUCE_MODES}")
    world = n_pod * n_data
    everyone = [list(range(world))]
    pods = [list(range(p * n_data, (p + 1) * n_data)) for p in range(n_pod)]
    across = [list(range(d, world, n_data)) for d in range(n_data)]
    numels = [math.prod(d.shape) for _, d in tree_leaves(grad_defs)]

    def call(op, nbytes, groups):
        return {"op": op, "bytes": nbytes, "groups": groups}

    if reduce_mode == "allreduce" or n_pod == 1 or n_data == 1:
        plan = [call("all_reduce", 4 * n, everyone) for n in numels]
    else:
        plan = [call("all_reduce", 4 * n, pods) for n in numels]
        if reduce_mode == "hierarchical":
            plan += [call("all_reduce", 4 * n, across) for n in numels]
        else:                    # int8 blocks and fp32 scales, gathered
            for n in numels:
                blocks = -(-n // compression.BLOCK)
                plan += [call("all_gather",
                              n_pod * blocks * compression.BLOCK, across),
                         call("all_gather", n_pod * blocks * 4, across)]
    return plan + [call("all_reduce", 4, everyone)]


# ----------------------------------------------------------- gradient mapper

def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, aux, grads) of ``loss_fn(params, batch) -> (loss, aux)`` by
    ``torch.autograd``; ``params`` is a tree of tensors, left untouched."""
    leaves = [p.detach().requires_grad_(True)
              for _, p in tree_leaves(params)]
    with torch.enable_grad():
        loss, aux = loss_fn(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
    return (loss.detach(), tree_map(lambda a: a.detach(), aux),
            tree_unflatten(params, list(grads)))


def mapreduce_value_and_grad(loss_fn: Callable,
                             groups: Optional[DPGroups], *,
                             reduce_mode: str = "allreduce",
                             n_micro: int = 1):
    """The paper's map/combine/reduce step for a differentiable loss
    ``loss_fn(params, microbatch) -> (loss, aux)``.

    Returns ``step(params, batch, err) -> (loss, grads, new_err, aux)``:
    ``batch`` is this process's shard (a dict of tensors split on dim 0
    into ``n_micro`` microbatches); grads come back summed over every
    process and divided by their number (the mean over the global batch),
    the loss averaged the same way, ``aux`` the last microbatch's."""
    if reduce_mode not in REDUCE_MODES:
        raise ValueError(f"reduce_mode {reduce_mode!r} not in {REDUCE_MODES}")

    def step(params, batch, err=None):
        # --- mapper + combiner over the local microbatches ---
        gsum, lsum, aux = None, None, None
        for i in range(n_micro):
            m = tree_map(lambda x: x.reshape((n_micro, x.shape[0] // n_micro)
                                             + tuple(x.shape[1:]))[i], batch)
            loss, aux, g = value_and_grad(loss_fn, params, m)
            g = tree_map(lambda t: t.float(), g)
            gsum = g if gsum is None else tree_map(torch.add, gsum, g)
            lsum = loss.float() if lsum is None else lsum + loss.float()
        grads = tree_map(lambda g: g / n_micro, gsum)
        loss = lsum / n_micro
        # --- reducer: cross-process per-weight mean ---
        grads, new_err = reduce_tree(grads, groups, reduce_mode, err)
        if groups is not None:
            grads = tree_map(lambda g: g / groups.size, grads)
            loss = _all_reduce(loss, groups.world) / groups.size
        return loss, grads, new_err, aux

    return step


# ------------------------------------------------------- generic M/R jobs

def map_reduce_job(map_fn: Callable, group: Optional[DPGroups] = None, *,
                   reduce: str = "mean"):
    """The paper's generic MapReduce job (the RBM's CD statistics, the
    forward-propagation job between DBN layers): ``job(params,
    local_batch)`` maps ``map_fn`` over this process's shard and reduces
    the resulting tree over every process by ``sum``, ``mean`` or
    ``concat`` (an identity reduce: each process keeps its own rows).  With
    no group it is plain local evaluation."""
    if reduce not in ("mean", "sum", "concat"):
        raise ValueError(f"reduce {reduce!r} not in (mean, sum, concat)")

    def run(params, batch):
        out = map_fn(params, batch)
        if group is None or reduce == "concat":
            return out
        out = tree_map(lambda x: _all_reduce(x, group.world), out)
        if reduce == "mean":
            out = tree_map(lambda x: x / group.size, out)
        return out

    return run
