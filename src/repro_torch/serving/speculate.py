"""Weight-free speculative decoding: n-gram prompt-lookup drafts.

The paper's thesis — batch the sequential bottleneck into one parallel
device launch — applied to the decode loop: instead of one q_len=1 step per
token, the engine drafts K candidate tokens per decode-ready slot from the
request's *own* token history (prompt + generation so far), verifies all of
them plus the usual next token in a single fixed-shape small-q step, and
keeps the longest draft prefix the verify argmax reproduces.  Greedy
acceptance makes the exactness contract absolute: the emitted stream is
token-for-token identical to non-speculative greedy decode, the only thing
speculation changes is how many device launches it takes.

The proposer is prompt-lookup decoding (Saxena, 2023; vLLM's ``ngram``
speculator): find the most recent earlier occurrence of the trailing
n-gram and propose the tokens that followed it.  It has no weights, costs
O(history) python per step, and wins exactly where decode is most wasteful
— repetitive continuations (code, extraction, structured output) — while
degrading to accept-rate ~0 (never to wrong tokens) on adversarial text.
"""
from __future__ import annotations

from typing import List, Sequence

from ..configs.base import ArchConfig, ServeConfig
from ..models.cache_spec import CacheFamilySpec


def speculation_k(cfg: ArchConfig, spec: CacheFamilySpec,
                  scfg: ServeConfig) -> int:
    """Effective draft length for this (arch, serving-config) pair.

    Speculation needs the paged small-q verify step, so state-slot families
    (ssm / hybrid) and enc-dec serve non-speculatively even when
    ``speculate_tokens`` is set — the gate lives here so the engine and the
    scheduler agree on one rule."""
    if scfg.speculate_tokens <= 0:
        return 0
    if not spec.paged or cfg.enc_dec:
        return 0
    return scfg.speculate_tokens


class NgramProposer:
    """Prompt-lookup draft proposer.

    Matches the longest trailing n-gram (``max_ngram`` down to
    ``min_ngram``) of the token history at its most recent earlier
    occurrence and proposes up to ``k`` tokens that followed that
    occurrence.  Returns ``[]`` when no n-gram recurs — the engine then
    runs a verify step that degenerates to a plain decode step."""

    def __init__(self, k: int, max_ngram: int = 3, min_ngram: int = 1):
        assert k > 0 and 1 <= min_ngram <= max_ngram
        self.k = k
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def propose(self, tokens: Sequence[int]) -> List[int]:
        toks = list(tokens)
        n = len(toks)
        for g in range(min(self.max_ngram, n - 1), self.min_ngram - 1, -1):
            suffix = toks[n - g:]
            # scan right-to-left: the most recent earlier occurrence is the
            # best predictor of the local continuation
            for s in range(n - g - 1, -1, -1):
                if toks[s:s + g] == suffix:
                    # the continuation may run into the suffix itself —
                    # that self-overlap is the periodic-text best case
                    return toks[s + g:s + g + self.k]
        return []


def accept_length(draft: Sequence[int], verified: Sequence[int]) -> int:
    """Greedy acceptance: the longest prefix of ``draft`` that the verify
    argmax ``verified`` reproduces (``verified[j]`` is the model's next
    token *after* draft position j - 1; ``draft[j]`` is accepted iff it
    equals ``verified[j]``).  The engine then emits ``verified[:a + 1]`` —
    the accepted drafts plus the bonus token — exactly the tokens a
    sequence of one-token decode steps would have produced."""
    a = 0
    for d, v in zip(draft, verified):
        if int(v) != int(d):
            break
        a += 1
    return a
