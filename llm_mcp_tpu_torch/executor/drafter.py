"""Host-side n-gram drafter for self-speculative decoding (the port's
copy of `llm_mcp_tpu/executor/drafter.py`, which has no JAX in it).

Prompt-lookup drafting (PLD): each slot keeps an index of the n-grams seen
so far in its own token history (prompt + everything generated).  To draft,
the longest suffix of the history that matches an earlier n-gram is looked
up and the tokens that followed that earlier occurrence are proposed as the
draft continuation.  No second model, no device work: the draft is a pure
host-side dict probe, and the proposal is deterministic (the drafter puts
probability 1 on its proposal), which is what makes the engine's
rejection-sampling verify exact: accept draft `d` with probability
`p_target(d)`, resample rejections from the target with `d` zeroed out.

Dependency-free (no torch, no numpy): it runs on the engine thread
between device dispatches.
"""

from __future__ import annotations


class NGramDrafter:
    """Per-slot n-gram index with longest-suffix-match drafting.

    Tokens are appended one at a time (prompt first, then each emitted
    token).  When the token at position ``i`` arrives, every n-gram that
    *ends* at position ``i - 1`` gains a known continuation (position
    ``i``), so that is the moment it is registered — the index never maps a
    suffix to itself.  Last occurrence wins: repeated n-grams point at
    their most recent continuation, which tracks loops and recent phrasing
    better than the first occurrence.
    """

    __slots__ = ("ids", "min_n", "max_n", "_index")

    def __init__(self, min_n: int = 2, max_n: int = 3) -> None:
        if min_n < 1:
            raise ValueError(f"min_n must be >= 1, got {min_n}")
        if max_n < min_n:
            raise ValueError(f"max_n ({max_n}) must be >= min_n ({min_n})")
        self.ids: list[int] = []
        self.min_n = min_n
        self.max_n = max_n
        # _index[n][ngram-tuple] -> position of the token that followed it
        self._index: dict[int, dict[tuple[int, ...], int]] = {
            n: {} for n in range(min_n, max_n + 1)
        }

    def append(self, tok: int) -> None:
        """Append one token; register the n-grams it completes."""
        ids = self.ids
        i = len(ids)
        for n in range(self.min_n, self.max_n + 1):
            if i - n >= 0:
                self._index[n][tuple(ids[i - n : i])] = i
        ids.append(tok)

    def extend(self, toks) -> None:
        for t in toks:
            self.append(int(t))

    def _match(self, seq: list[int]) -> int | None:
        """Continuation position in ``ids`` for the longest indexed suffix
        of ``seq`` (an (max_n)-gram match is more specific — and empirically
        more accurate — than a shorter one, so n is probed from ``max_n``
        down to ``min_n``), or None when no suffix has been seen before."""
        for n in range(min(self.max_n, len(seq)), self.min_n - 1, -1):
            pos = self._index[n].get(tuple(seq[-n:]))
            if pos is not None:
                return pos
        return None

    def draft(self, k: int) -> list[int]:
        """Propose up to ``k`` tokens continuing the current history.

        When a continuation runs off the end of the real history before
        filling ``k`` (the match landed near the tail — the common case for
        tight loops, since last occurrence wins), the VIRTUAL history
        (ids + draft-so-far) is re-probed: its suffix is an interior n-gram
        of the real history, so loops of any period extend to the full k
        instead of truncating at the history edge.  Returns an empty list
        when no suffix of the history has been seen before (or ``k <= 0``).
        """
        ids = self.ids
        n_ids = len(ids)
        if k <= 0 or n_ids < self.min_n:
            return []
        out: list[int] = []
        cursor: int | None = None  # position in ids of the next draft token
        while len(out) < k:
            if cursor is None or cursor >= n_ids:
                cursor = self._match(ids + out if out else ids)
                if cursor is None or cursor >= n_ids:
                    break
            out.append(ids[cursor])
            cursor += 1
        return out

    def __len__(self) -> int:
        return len(self.ids)
