"""Grammar automata → packed token bitmasks over the model vocabulary (the
port's copy of `llm_mcp_tpu/constrain/masks.py`; rows bit-equal to the
reference's).

The byte automaton (grammar.py) knows which BYTES may come next; the
engine needs which TOKENS may come next, as a static-shape
``[ceil(V/32)] uint32`` bitmask the sampler can expand on-device
(ops/sampling.py `expand_mask`). This module owns that lift:

- ``TokenByteTable``: byte trie over the tokenizer's vocabulary. A
  token's byte string is ``tokenizer.decode([tid]).encode()`` — exact
  for the byte tokenizer, and the documented approximation for BPE
  vocabularies (byte-fallback merges decode to the replacement char and
  are conservatively dropped from masks; structure bytes like ``{":,``
  always decode cleanly, which is what schema grammars constrain).
- ``CompiledConstraint``: automaton + trie with two memos — per-state
  packed masks (built by one trie DFS per distinct automaton state) and
  ``(state, token) → state`` transitions. Agent loops re-visiting the
  same schema states pay the DFS once.
- ``SlotAutomaton``: the per-engine-slot cursor — current state, the
  consumed token ids (migration wire replays these on the destination
  host), draft filtering for the speculative composer, and the
  ``logit_bias`` arrays that ride the same mask-add path.
- ``ConstraintCompiler``: LRU over compiled constraints keyed by the
  sha256 of the canonical spec JSON (`TPU_CONSTRAIN_CACHE` entries).

numpy-only on purpose: everything here runs on the engine host thread;
the device only ever sees the packed words.
"""

from __future__ import annotations

import hashlib
import json
import time
from collections import OrderedDict

import numpy as np

from .grammar import ByteAutomaton, GrammarError
from .schema import build_grammar

__all__ = [
    "TokenByteTable",
    "CompiledConstraint",
    "SlotAutomaton",
    "ConstraintCompiler",
    "mask_words",
    "spec_key",
]


def mask_words(n_vocab: int) -> int:
    """W — packed words per mask row for a (padded) vocab size."""
    return (int(n_vocab) + 31) // 32


def spec_key(spec: dict) -> str:
    """Cache key: sha256 of the canonical (sorted, compact) spec JSON."""
    blob = json.dumps(spec, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


class TokenByteTable:
    """Byte trie over token ids. One per (tokenizer, n_vocab) pair —
    the engine builds it lazily on the first constrained request."""

    def __init__(self, tokenizer, n_vocab: int):
        self.n_vocab = int(n_vocab)
        self.eos_id = int(getattr(tokenizer, "eos_id", -1))
        specials = {
            int(getattr(tokenizer, "pad_id", -1)),
            int(getattr(tokenizer, "bos_id", -1)),
            self.eos_id,
        }
        # trie node = [ids_ending_here, {byte: child}]
        self.root: list = [[], {}]
        n = min(int(getattr(tokenizer, "vocab_size", n_vocab)), self.n_vocab)
        # the byte tokenizer's id→byte map is exact — use it directly so
        # continuation bytes (which decode to U+FFFD alone) stay maskable
        # and multi-byte UTF-8 output remains reachable under constraint
        offset = getattr(tokenizer, "OFFSET", None)
        self.n_tokens = 0
        for tid in range(n):
            if tid in specials:
                continue
            if offset is not None:
                if not (offset <= tid < offset + 256):
                    continue
                data = bytes((tid - offset,))
            else:
                text = tokenizer.decode([tid])
                if not text or "�" in text:
                    continue  # byte-fallback token: conservatively unmaskable
                data = text.encode("utf-8")
            node = self.root
            for b in data:
                node = node[1].setdefault(b, [[], {}])
            node[0].append(tid)
            self.n_tokens += 1


class CompiledConstraint:
    """One compiled (automaton, vocabulary) product with memoized masks
    and transitions. Shared across every slot serving the same spec."""

    def __init__(self, automaton: ByteAutomaton, table: TokenByteTable, stats=None):
        self.automaton = automaton
        self.table = table
        self.W = mask_words(table.n_vocab)
        self._masks: dict[int, np.ndarray] = {}
        self._adv: dict[tuple[int, int], int] = {}
        # shared counters (owned by the ConstraintCompiler)
        self._stats = stats if stats is not None else {}
        # dead-state mask: EOS only, so a desynced slot terminates fast
        self._dead = np.zeros(self.W, dtype=np.uint32)
        if 0 <= table.eos_id < table.n_vocab:
            self._dead[table.eos_id >> 5] |= np.uint32(1 << (table.eos_id & 31))

    def mask(self, sid: int) -> np.ndarray:
        """Packed [W] uint32 row of tokens legal in ``sid`` (read-only)."""
        if sid < 0:
            return self._dead
        row = self._masks.get(sid)
        if row is not None:
            self._stats["mask_hits"] = self._stats.get("mask_hits", 0) + 1
            return row
        t0 = time.perf_counter()
        row = np.zeros(self.W, dtype=np.uint32)
        auto = self.automaton
        # DFS the byte trie, carrying the automaton state alongside
        stack = [(self.table.root, sid)]
        while stack:
            node, st = stack.pop()
            for tid in node[0]:
                row[tid >> 5] |= np.uint32(1 << (tid & 31))
            children = node[1]
            if not children:
                continue
            live = auto.live_bytes(st)
            for b, child in children.items():
                if b in live:
                    nxt = auto.step(st, b)
                    if nxt >= 0:
                        stack.append((child, nxt))
        # the root frame's ending-ids were set unconditionally above;
        # correct: the root has none (no zero-byte tokens)
        if auto.accepting(sid) and 0 <= self.table.eos_id < self.table.n_vocab:
            row[self.table.eos_id >> 5] |= np.uint32(1 << (self.table.eos_id & 31))
        row.setflags(write=False)
        self._masks[sid] = row
        self._stats["mask_builds"] = self._stats.get("mask_builds", 0) + 1
        self._stats["mask_build_s"] = (
            self._stats.get("mask_build_s", 0.0) + (time.perf_counter() - t0)
        )
        return row

    def advance(self, sid: int, tid: int) -> int:
        """State after emitting token ``tid`` from ``sid`` (-1 = dead).
        EOS maps an accepting state to itself (terminal)."""
        if sid < 0:
            return -1
        if tid == self.table.eos_id:
            return sid if self.automaton.accepting(sid) else -1
        key = (sid, tid)
        nxt = self._adv.get(key)
        if nxt is None:
            nxt = self._advance_slow(sid, tid)
            self._adv[key] = nxt
        return nxt

    def _advance_slow(self, sid: int, tid: int) -> int:
        # locate the token's byte path; tokens absent from the trie
        # (specials, byte-fallback) are never legal
        path = self._token_bytes(tid)
        if path is None:
            return -1
        return self.automaton.step_bytes(sid, path)

    def _token_bytes(self, tid: int) -> bytes | None:
        cache = getattr(self, "_tok_bytes", None)
        if cache is None:
            cache = self._tok_bytes = {}
            stack = [(self.table.root, b"")]
            while stack:
                node, prefix = stack.pop()
                for t in node[0]:
                    cache[t] = prefix
                for b, child in node[1].items():
                    stack.append((child, prefix + bytes((b,))))
        return cache.get(tid)

    def allows(self, sid: int, tid: int) -> bool:
        row = self.mask(sid)
        if not (0 <= tid < self.table.n_vocab):
            return False
        return bool((int(row[tid >> 5]) >> (tid & 31)) & 1)

    def n_states(self) -> int:
        return self.automaton.n_states()


class SlotAutomaton:
    """Per-slot constraint cursor. ``cc=None`` means bias-only (a
    pass-through automaton: every token legal, only ``logit_bias``
    rides the mask-add path)."""

    __slots__ = ("cc", "spec", "state", "consumed", "illegal",
                 "bias_ids", "bias_vals", "_ones")

    def __init__(self, cc: CompiledConstraint | None, spec=None,
                 bias_ids=None, bias_vals=None, n_vocab: int = 0):
        self.cc = cc
        self.spec = spec  # the raw spec dict — migration re-compiles from it
        self.state = cc.automaton.start_state if cc is not None else 0
        self.consumed: list[int] = []
        self.illegal = 0
        self.bias_ids = list(bias_ids or [])
        self.bias_vals = list(bias_vals or [])
        W = mask_words(cc.table.n_vocab if cc is not None else n_vocab)
        ones = np.full(W, 0xFFFFFFFF, dtype=np.uint32)
        ones.setflags(write=False)
        self._ones = ones

    @property
    def constrained(self) -> bool:
        return self.cc is not None

    @property
    def accepting(self) -> bool:
        if self.cc is None:
            return True
        return self.cc.automaton.accepting(self.state)

    def mask_row(self) -> np.ndarray:
        if self.cc is None:
            return self._ones
        return self.cc.mask(self.state)

    def allows(self, tid: int) -> bool:
        if self.cc is None:
            return True
        if tid == self.cc.table.eos_id:
            return self.cc.automaton.accepting(self.state)
        return self.cc.allows(self.state, tid)

    def advance(self, tid: int) -> bool:
        """Consume an EMITTED token. Returns False (and counts it) if
        the token was automaton-illegal — which the mask makes
        impossible by construction; the counter is the proof."""
        tid = int(tid)
        self.consumed.append(tid)
        if self.cc is None:
            return True
        nxt = self.cc.advance(self.state, tid)
        if nxt < 0:
            self.illegal += 1
            self.state = -1
            return False
        if tid != self.cc.table.eos_id:
            self.state = nxt
        return True

    def replay(self, tids) -> None:
        """Migration restore: re-walk already-emitted ids on a fresh
        cursor so the destination host resumes mid-constraint."""
        for tid in tids:
            self.advance(tid)

    def filter_draft(self, draft: list[int]) -> list[int]:
        """Longest automaton-legal prefix of a speculative draft — the
        composition guarantee that drafts are constraint-legal by
        construction."""
        if self.cc is None:
            return draft
        sid = self.state
        out: list[int] = []
        for tid in draft:
            tid = int(tid)
            if tid == self.cc.table.eos_id:
                break  # the drafter never needs to propose EOS
            nxt = self.cc.advance(sid, tid)
            if nxt < 0:
                break
            out.append(tid)
            sid = nxt
        return out

    def masks_for_draft(self, draft: list[int]) -> np.ndarray:
        """[len(draft)+1, W] packed rows: row j constrains the token at
        draft position j (row 0 = current state). spec_verify applies
        these BEFORE accept/reject, keeping rejection resampling exact
        under the constraint."""
        n = len(draft) + 1
        if self.cc is None:
            return np.broadcast_to(self._ones, (n, self._ones.shape[0])).copy()
        rows = np.empty((n, self.cc.W), dtype=np.uint32)
        sid = self.state
        rows[0] = self.cc.mask(sid)
        for j, tid in enumerate(draft):
            sid = self.cc.advance(sid, int(tid))
            rows[j + 1] = self.cc.mask(sid)
            if sid < 0:
                break  # remaining rows stay EOS-only via mask(-1) next iter
        return rows


class ConstraintCompiler:
    """LRU compile cache keyed by schema hash + the slot-automaton
    factory. One per engine; stats surface at /v1/debug/constrain."""

    def __init__(self, tokenizer, n_vocab: int, cache_size: int = 64):
        self._tokenizer = tokenizer
        self.n_vocab = int(n_vocab)
        self.cache_size = max(1, int(cache_size))
        self._table: TokenByteTable | None = None
        self._cache: OrderedDict[str, CompiledConstraint] = OrderedDict()
        self.stats_d: dict = {
            "hits": 0, "misses": 0, "evictions": 0, "compile_s": 0.0,
            "mask_builds": 0, "mask_hits": 0, "mask_build_s": 0.0,
        }

    def table(self) -> TokenByteTable:
        if self._table is None:
            self._table = TokenByteTable(self._tokenizer, self.n_vocab)
        return self._table

    def compile(self, spec: dict) -> CompiledConstraint:
        key = spec_key(spec)
        cc = self._cache.get(key)
        if cc is not None:
            self._cache.move_to_end(key)
            self.stats_d["hits"] += 1
            return cc
        self.stats_d["misses"] += 1
        t0 = time.perf_counter()
        rules, start = build_grammar(spec)
        automaton = ByteAutomaton(rules, start)
        cc = CompiledConstraint(automaton, self.table(), stats=self.stats_d)
        self.stats_d["compile_s"] += time.perf_counter() - t0
        self._cache[key] = cc
        while len(self._cache) > self.cache_size:
            self._cache.popitem(last=False)
            self.stats_d["evictions"] += 1
        return cc

    def make(self, spec: dict | None, logit_bias=None) -> SlotAutomaton:
        """Slot automaton for a request: compiled constraint (cached),
        pass-through when only ``logit_bias`` is present."""
        bias_ids, bias_vals = [], []
        for pair in logit_bias or []:
            bias_ids.append(int(pair[0]))
            bias_vals.append(float(pair[1]))
        cc = self.compile(spec) if spec else None
        return SlotAutomaton(
            cc, spec=spec, bias_ids=bias_ids, bias_vals=bias_vals,
            n_vocab=self.n_vocab,
        )

    def stats(self) -> dict:
        d = dict(self.stats_d)
        d["entries"] = len(self._cache)
        d["cache_size"] = self.cache_size
        d["vocab_tokens"] = self._table.n_tokens if self._table else 0
        return d
