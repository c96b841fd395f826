"""Draft-free self-speculation for the paged serving engine: n-gram
prompt / generation lookup (the port's copy of
``deepspeed_tpu/inference/spec.py``, which is host numpy in both packages).

A proposer guesses the next ``k`` tokens of a request from its own prompt
and generated history; one fused verify step
(``models/transformer.py::forward_paged_verify``) computes the model's
logits at every window position, and greedy acceptance keeps the longest
candidate prefix the model agrees with plus the token at the first
mismatch: the same tokens as plain greedy decode, at (accepted + 1) tokens
a fused step instead of 1. Where no tail n-gram recurs the scheduler
decodes one token as usual.

``serving.speculative: {mode: "ngram", k, min_match, max_match}`` turns it
on (``inference/config.py``); the scheduler owns one proposer per serve
call and stashes the candidates on each request before a ``("verify",
reqs)`` action (``inference/scheduler.py``).
"""

from __future__ import annotations

import numpy as np


class NgramProposer:
    """Tail n-gram lookup over a request's token history.

    ``propose(seq, k)`` matches the LONGEST tail n-gram of ``seq`` (from
    ``max_match`` down to ``min_match`` tokens) against its most recent
    earlier occurrence in ``seq`` and returns up to ``k`` tokens that
    followed that occurrence. The tail's own occurrence is excluded;
    overlapping earlier occurrences count (they extend periodic text). A
    pure function of the sequence, so identical request streams speculate
    identically."""

    def __init__(self, min_match: int = 2, max_match: int = 4):
        if min_match < 1:
            raise ValueError(f"min_match={min_match} must be >= 1")
        if max_match < min_match:
            raise ValueError(f"max_match={max_match} must be >= min_match={min_match}")
        self.min_match = min_match
        self.max_match = max_match

    def propose(self, seq, k: int) -> np.ndarray:
        """Up to ``k`` candidate tokens (int32) for ``seq``, the request's
        prompt + generated history; empty when ``k`` < 1, the sequence is
        too short, or no tail n-gram recurs."""
        empty = np.zeros((0,), np.int32)
        if k < 1:
            return empty
        seq = np.asarray(seq, np.int32).reshape(-1)
        L = seq.size
        for n in range(min(self.max_match, L - 1), self.min_match - 1, -1):
            tail = seq[L - n:]
            # windows over seq[:-1] start at 0 .. L-1-n: the tail itself
            # (start L-n) is left out, overlapping earlier matches stay in
            windows = np.lib.stride_tricks.sliding_window_view(seq[:L - 1], n)
            hits = np.nonzero((windows == tail).all(axis=1))[0]
            if hits.size == 0:
                continue
            start = int(hits[-1]) + n          # the most recent occurrence's end
            cands = seq[start:start + k]
            if cands.size:
                return np.ascontiguousarray(cands, np.int32)
        return empty
