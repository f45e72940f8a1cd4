"""Model-free n-gram drafting for speculative decoding.

Counterpart of ``paddle_tpu/inference/drafting.py`` (a copy: the port
imports nothing of the JAX package).  A per-request suffix/n-gram table
over the tokens the stream has committed (prompt + generated) proposes
the continuation of the longest recently seen suffix ("prompt lookup"
drafting).  It costs a few dict probes on the host: no draft weights, no
draft pools, no draft prefill.  The proposal is deterministic, so the
proposal distribution is the point mass ``one_hot(d)``: the accept draw
reduces to ``u <= p(d)`` and the residual to ``p`` without ``d``'s mass
(``inference/speculative.py``).

Indexing is incremental: each request owns one :class:`NGramDraft`;
``propose(tokens, k)`` absorbs the tokens appended since the last call,
then walks the orders longest first.  For each order it keeps the LAST
and the PREVIOUS start of every n-gram, so the current suffix never
matches itself.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

__all__ = ["NGramDraft"]


class NGramDraft:
    """Per-request incremental suffix/n-gram proposal table.

    ``max_n`` bounds the longest suffix matched (higher = more
    precise matches, more index memory); ``min_n`` the shortest one
    consulted before giving up.  ``propose`` never fails: with no
    match it repeats the stream head — a wrong-but-cheap guess the
    verify forward simply rejects.
    """

    def __init__(self, max_n: int = 3, min_n: int = 1):
        if not 1 <= min_n <= max_n:
            raise ValueError(
                f"need 1 <= min_n <= max_n; got min_n={min_n} "
                f"max_n={max_n}")
        self.max_n = max_n
        self.min_n = min_n
        self._toks: List[int] = []    # owned history (propose_stream)
        self._len = 0             # tokens absorbed into the index
        # per order: n-gram -> start of its last occurrence, and the
        # occurrence before that (the suffix's own entry is its last
        # occurrence; PREV is what a lookup actually wants)
        self._last: Dict[int, Dict[Tuple[int, ...], int]] = {
            n: {} for n in range(min_n, max_n + 1)}
        self._prev: Dict[int, Dict[Tuple[int, ...], int]] = {
            n: {} for n in range(min_n, max_n + 1)}
        self.matched = 0          # proposals backed by a table hit
        self.fallbacks = 0        # ...and blind head-repeat proposals

    def _absorb(self, tokens: Sequence[int]) -> None:
        if len(tokens) < self._len:
            # a shorter history means the caller reused the drafter for
            # a different stream; start over rather than alias grams
            self._len = 0
            for n in self._last:
                self._last[n].clear()
                self._prev[n].clear()
        for i in range(self._len, len(tokens)):
            for n in self._last:
                if i + 1 < n:
                    continue
                start = i + 1 - n
                gram = tuple(tokens[start:i + 1])
                bucket = self._last[n]
                old = bucket.get(gram)
                if old is not None:
                    self._prev[n][gram] = old
                bucket[gram] = start
        self._len = len(tokens)

    def _match(self, tokens: Sequence[int]) -> int:
        """Start index of the most recent PRIOR occurrence of the
        longest indexed suffix, or -1."""
        L = len(tokens)
        for n in range(min(self.max_n, L), self.min_n - 1, -1):
            gram = tuple(tokens[L - n:])
            pos = self._last[n].get(gram)
            if pos == L - n:              # the suffix itself
                pos = self._prev[n].get(gram)
            if pos is not None:
                return pos + n            # continuation starts here
        return -1

    def propose_stream(self, prompt_ids: Sequence[int],
                       output_ids: Sequence[int], k: int) -> List[int]:
        """Draft ``k`` tokens continuing ``prompt_ids + output_ids``
        WITHOUT materializing that concatenation per call: the drafter
        owns a history list and appends only the output tokens that
        arrived since the previous call, so a tick costs O(new tokens
        + orders) however long the stream has grown.  The engine's
        per-tick entry point (`propose` is the direct/list form)."""
        t = self._toks
        want = len(prompt_ids) + len(output_ids)
        if len(t) > want:
            # shorter history = the drafter was handed a different
            # stream; start over (mirrors _absorb's reset)
            t.clear()
        if not t:
            t.extend(int(x) for x in prompt_ids)
        new = want - len(t)
        if new > 0:
            t.extend(int(x) for x in output_ids[len(output_ids) - new:])
        return self.propose(t, k)

    def propose(self, tokens: Sequence[int], k: int) -> List[int]:
        """Draft ``k`` tokens continuing ``tokens`` (the request's
        prompt + generated ids).  Tokens appended since the previous
        call are absorbed first, so call-per-tick is O(new + orders)."""
        self._absorb(tokens)
        cont = self._match(tokens)
        if cont < 0:
            self.fallbacks += 1
            head = int(tokens[-1]) if tokens else 0
            return [head] * k
        self.matched += 1
        out: List[int] = []
        p = cont                          # cont <= L-1: at least one
        for _ in range(k):                # real continuation token
            out.append(int(tokens[p]))
            p += 1
            if p >= len(tokens):
                # copying tokens[cont:] onto the end reproduces the
                # matched suffix, whose continuation is cont again —
                # exact for periodic streams, a guess otherwise
                p = cont
        return out
