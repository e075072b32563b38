"""Cache-family taxonomy for the serving engine.

Every model reports *what kind of decode cache it keeps* through
``cache_spec()``; the serving stack (``repro.serving``) consumes the spec to
decide how requests are admitted, grown, preempted, and retired.  Five layer
families cover every registered arch:

``paged_kv``
    Token-addressable K/V pages (dense / GQA / MQA / MoE attention).  One
    page per ``page_size`` positions; pages are immutable once written, so
    full prompt pages can be shared through the radix prefix cache.

``paged_mla``
    MLA's absorbed latent cache (``ckv`` + roped ``krope``) in pages.  Same
    addressing and immutability as ``paged_kv`` — only the per-token payload
    differs (rank-``kv_lora`` latent instead of per-head K/V).

``windowed_kv``
    Sliding-window K/V in a *page ring*: a request holds at most
    ``window_pages(window, page_size)`` pages and the table entry for
    logical page ``a`` lives at ring slot ``a % horizon`` — once a position
    ages out of the window its page is overwritten in place (recycled), so
    allocation is O(window) regardless of generated length.  Recycling makes
    the pages mutable, which is why windowed families are not
    prefix-cacheable.

``state_slot``
    Fixed-size recurrent state (SSM conv taps + SSD state, RG-LRU conv +
    hidden state, and the hybrid family's bounded local-attention ring).
    One slot per live request, indexed by the decode row; preemption
    checkpoints the slot to host memory and re-admission restores it
    (alloc -> checkpoint-on-preempt -> restore -> free).

``cross_kv``
    Enc-dec cross-attention K/V: computed once at prefill from the encoder
    output and pinned (read-only) in a per-request state slot for the whole
    decode.  The decoder's *self*-attention KV still grows and is paged.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


def window_pages(window: int, page_size: int) -> int:
    """Ring horizon in pages for a sliding window.

    The ring must keep every position in ``(pos - window, pos]`` live while
    the page holding ``pos`` is being written, so it spans at least
    ``window + 1`` token slots rounded up to whole pages."""
    return window // page_size + (1 if window % page_size == 0 else 2)


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    """One layer-group's cache family."""
    kind: str            # paged_kv | paged_mla | windowed_kv | state_slot | cross_kv
    window: int = 0      # windowed_kv: sliding window in tokens


@dataclasses.dataclass(frozen=True)
class CacheFamilySpec:
    """A model's full decode-cache shape, as the serving stack sees it."""
    kinds: Tuple[CacheSpec, ...]
    paged: bool                  # has a token-addressable paged component
    window: int = 0              # >0: paged component is a ring of this window
    state_slots: bool = False    # has per-request fixed-size slot state
    prefix_cacheable: bool = False  # prompt pages immutable -> radix cache ok
    prefix_tokens: int = 0       # non-text positions before the prompt (vlm)
    checkpointable: bool = False  # preempt = checkpoint slot state, not replay

    def describe(self) -> str:
        return "+".join(
            f"{k.kind}(w={k.window})" if k.window else k.kind
            for k in self.kinds)
