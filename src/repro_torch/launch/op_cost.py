"""What one eager step costs, counted op by op on ``meta`` tensors: the
counterpart of ``repro.launch.hlo_cost``.

The JAX package walks the optimized HLO text of a compiled program; the
port compiles nothing, so ``step_cost(fn, *args)`` runs ``fn`` once under
a ``TorchDispatchMode`` that sees every aten op the step dispatches, on
``meta`` stand-ins (``models.steps.abstract_*_args``): shapes and dtypes
only, no storage, no device.  Eager dispatch visits every layer and every
microbatch in turn, so no loop awareness is needed: where ``hlo_cost``
parses each ``while`` loop's trip count and multiplies its body, here the
loop simply runs.

Costs per op (``Cost``):
  * ``flops``: the product ops (mm, bmm, addmm, baddbmm, convolution, the
    SDPA ops and their backwards) by ``torch.utils.flop_counter``'s
    formulas (2 x |result| x K); every other op 1 per output element, as
    ``hlo_cost`` charges elementwise and other ops; views and allocations
    0 (``product_flops`` keeps the products' part alone);
  * ``bytes``: ``hlo_cost``'s rule for materializing ops mapped to aten
    names: products, gathers, scatters, index writes, sorts and random
    draws their inputs + result; reductions, softmaxes, copies,
    concatenations and pads 2 x their result; elementwise ops nothing (a
    fused program keeps them in registers), views nothing;
  * ``eager_bytes``: every op's inputs + outputs, what the eager port
    really moves;
  * ``n_ops``: the ops that do device work (views and allocations
    excluded): what the host launches one by one;
  * ``peak_live_bytes``: the high-water mark of live storages: the
    arguments' and every tensor the step touches or makes, each freed when
    its last reference goes (``weakref.finalize`` on the storage), so
    tensors that autograd saves for the backward stay live, as they do on
    the card.

Collectives are not traced (there is no process group on ``meta``):
``core.mapreduce.reduce_plan`` lists the ones a MapReduce step issues.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

_aten = torch.ops.aten

# ops that read their inputs and write their result: hlo_cost's dot,
# convolution, gather, scatter, dynamic-(update-)slice, sort and rng
_IN_OUT = {
    _aten.index_select, _aten.gather, _aten.scatter, _aten.scatter_,
    _aten.scatter_add, _aten.scatter_add_, _aten.scatter_reduce,
    _aten.scatter_reduce_, _aten.index_add, _aten.index_add_,
    _aten.index_put, _aten.index_put_, _aten._index_put_impl_,
    _aten.index_copy, _aten.index_copy_, _aten.index, _aten.index_fill,
    _aten.index_fill_, _aten.embedding, _aten.embedding_dense_backward,
    _aten.sort, _aten.topk, _aten.masked_scatter, _aten.masked_select,
    _aten.nonzero, _aten.normal, _aten.normal_, _aten.uniform,
    _aten.uniform_, _aten.bernoulli, _aten.bernoulli_, _aten.randn,
    _aten.rand, _aten.randint, _aten.multinomial,
}
# ops that write a result they read once: hlo_cost's reduce, copy,
# transpose, concatenate, pad, slice, reverse, iota (2 x the result)
_COPY_LIKE = {
    _aten.sum, _aten.mean, _aten.amax, _aten.amin, _aten.max, _aten.min,
    _aten.argmax, _aten.argmin, _aten.prod, _aten.var, _aten.std,
    _aten.var_mean, _aten.std_mean, _aten.logsumexp, _aten.norm,
    _aten.linalg_vector_norm, _aten.any, _aten.all, _aten.cumsum,
    _aten.cumprod, _aten._softmax, _aten._log_softmax,
    _aten._softmax_backward_data, _aten._log_softmax_backward_data,
    _aten.copy_, _aten.clone, _aten.cat, _aten.stack,
    _aten.constant_pad_nd, _aten.slice_scatter, _aten.select_scatter,
    _aten.diagonal_scatter, _aten.flip, _aten.roll, _aten.repeat,
    _aten.arange, _aten.linspace,
}
# allocations: no device work
_ALLOC = {
    _aten.empty, _aten.empty_strided, _aten.empty_like, _aten.new_empty,
    _aten.new_empty_strided, _aten.lift_fresh,
}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    product_flops: float = 0.0
    bytes: float = 0.0
    eager_bytes: float = 0.0
    n_ops: int = 0
    peak_live_bytes: int = 0
    # the device type of every tensor but 0-d CPU ones (host scalars, such
    # as a ``torch.tensor(c)`` constant, that an op on any device reads as
    # a number)
    devices: set = dataclasses.field(default_factory=set)


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    """The bytes a kernel moves for ``t``: its elements, at most its
    storage's (a broadcast view reads its storage once)."""
    n = t.numel() * t.element_size()
    try:
        return min(n, t.untyped_storage().nbytes())
    except (RuntimeError, NotImplementedError):
        return n


def _is_view(func) -> bool:
    """Whether ``func`` returns an alias of an input it does not write."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _key(t: torch.Tensor):
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):
        return None


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.live = 0
        self.storages = {}           # storage key -> bytes, while alive

    def _track(self, t: torch.Tensor) -> None:
        if t.dim() or t.device.type != "cpu":
            self.cost.devices.add(t.device.type)
        k = _key(t)
        if k is None or k in self.storages:
            return
        st = t.untyped_storage()
        n = st.nbytes()
        self.storages[k] = n
        self.live += n
        self.cost.peak_live_bytes = max(self.cost.peak_live_bytes, self.live)
        weakref.finalize(st, self._free, k, n)

    def _free(self, k, n) -> None:
        if self.storages.pop(k, None) is not None:
            self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        for t in ins:                        # alive now, made before the op
            self._track(t)
        out = func(*args, **kwargs)
        outs = _tensors(out)
        packet = func.overloadpacket
        in_keys = {_key(t) for t in ins}
        aliasing = not func._schema.is_mutable and all(
            _key(t) in in_keys for t in outs)
        if _is_view(func) or aliasing or packet in _ALLOC or not outs:
            for t in outs:
                self._track(t)
            return out
        c = self.cost
        in_b = sum(_nbytes(t) for t in ins)
        out_b = sum(_nbytes(t) for t in outs)
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            c.product_flops += f
            c.bytes += in_b + out_b
        else:
            f = float(sum(t.numel() for t in outs))
            if packet in _IN_OUT:
                c.bytes += in_b + out_b
            elif packet in _COPY_LIKE:
                c.bytes += 2 * out_b
        c.flops += f
        c.eager_bytes += in_b + out_b
        c.n_ops += 1
        for t in outs:
            self._track(t)
        return out


def step_cost(fn: Callable, *args, **kwargs) -> Cost:
    """Run ``fn(*args, **kwargs)`` once and count what it dispatched.  The
    arguments should be ``meta`` tensors (``models.steps.abstract_*_args``):
    then nothing is allocated and no device is touched.  Returns the
    ``Cost``; ``fn``'s result is dropped."""
    mode = _Counter()
    with mode:
        for t in _tensors((args, kwargs)):
            mode._track(t)
        out = fn(*args, **kwargs)
        del out
    return mode.cost
