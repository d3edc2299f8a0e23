"""Continuous-batching generation engine (counterpart of
`llm_mcp_tpu/executor/engine.py:GenerationEngine`, local backend).

One engine thread owns the model, the KV cache and every slot. Each loop
iteration:

  1. stages a ragged prefill group under the token-budget scheduler
     (`scheduler.py`): up to `admit_batch` mid-prefill prompts' next
     chunks packed back to back into one [T] token buffer;
  2. runs one decode round (`decode_chunk` steps) for the active slots;
  3. runs the staged group (`llama_prefill_chunk_ragged`) and activates
     the prompts whose last chunk landed, sampling their first token;
  4. emits the round's tokens and finishes slots (EOS, `max_tokens`, end
     of the sequence);
  5. admits queued requests: prompts of at most `prefill_chunk` tokens
     prefill together (`llama_prefill`, batches of up to `admit_batch`),
     longer ones reserve a slot and join the chunk queue.

Decode rows and prefill rows are disjoint: a slot is decodable only once
its whole prompt is in the cache. Free and mid-prefill slots are parked at
`lengths = max_seq_len`, so the decode step's append writes nothing into
them. The packing rules are the JAX engine's (rowids sorted, pads carry
rowid R and position S, T on the pow2 ladder), so the two engines dispatch
the same work. Unlike the JAX loop, a round's tokens are fetched before the
next round starts (no pipelining yet).

Prompt-prefix cache and paged KV, as in the JAX engine
(`prompt_cache_mb`, default 256): every slot owns a block table in the
ledger (`paging.py`). At activation a prompt that shares at least
`PREFIX_MIN` tokens with a recent prompt stores that prefix (length
floored to a power of two). With physical paging (`physical.py`; block
size in {32, 64, 128, 256} dividing `max_seq_len`) the entry's blocks are
copied once into a device pool, and a later prompt that starts with it is
admitted by pinning those blocks into its table: no row copies, except
the boundary block of an unaligned entry, copied on write. Its suffix
prefills through ragged chunks and its decode steps read the shared blocks
from the pool through the paged kernels, chosen on the host whenever a
row of the step has a non-identity table. Without physical paging an
entry is a copy of the slot's rows, copied into every hit slot.

int8, as the JAX engine (`quant`, `kv_quant`, `decode_compact`): with
`quant="int8"` the weights are int8 (`models/quant.py`; made directly in
int8 when none are passed, quantized when bf16 ones are) in the fused
single-device layout (`wqkv`, `w13`), stored K-contiguous for the int8
GEMM (`gemm_layout`); with `kv_quant="int8"` the KV cache
is the fused int8 layout (`k = {"q", "s"}`, `v = {}`), and every path
that moves cache rows (admission, prefix entries, pool copies, copy on
write, recovery) moves the payload with all its heads and the plain
scales together. Slot compaction (`decode_compact`, on by default with the
int8 cache): a decode round runs only a pow2 bucket of the active rows
(floor 8), each reading its cache row through `slot_ids`.

MLA models (DeepSeek-V2-Lite, `models/mla.py`) keep a latent cache in the
same (k, v) pair: k = latents [L, B, 1, S, R], v = rope keys
[L, B, 1, S, dr], and at int8 each its own {"q", "s"} dict, not fused.
Every path above maps over those leaves unchanged; the int8 latents are
read by the MLA decode kernel through `slot_ids` when compacted.

Left out until later slices: host offload and preemption (`KVPool`),
migration, the fleet prefix tier, speculation, constraints, the model zoo,
tenants and the flight recorder.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
import uuid
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Iterator

import numpy as np
import torch

from ..models.configs import ModelConfig, get_config
from ..models.llama import (
    init_kv_cache,
    init_llama_params,
    llama_decode_step,
    llama_prefill,
    llama_prefill_chunk_ragged,
)
from ..models.quant import (
    fuse_layer_weights,
    gemm_layout,
    init_llama_params_quantized,
    quantize_params,
)
from ..ops.sampling import sample_tokens
from ..utils.device import resolve_device
from .common import fine_bucket, pow2_bucket
from .paging import PagedKVManager
from .physical import PhysicalPool, pool_like
from .scheduler import TokenBudgetScheduler
from .tokenizer import ByteTokenizer

log = logging.getLogger("executor")

_DONE = object()  # end-of-stream sentinel on a request's queue


def _map(fn, *trees):
    """fn over the leaves of KV trees of one structure: a tensor, or the
    fused int8 cache's dict ({"q", "s"}, or {} for its V side)."""
    if isinstance(trees[0], dict):
        return {k: fn(*(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(*trees) -> list[torch.Tensor]:
    out: list[torch.Tensor] = []
    for t in trees:
        out.extend(t.values() if isinstance(t, dict) else [t])
    return out


def _nbytes(*trees) -> int:
    return sum(x.numel() * x.element_size() for x in _leaves(*trees))


@dataclass
class GenRequest:
    prompt_ids: list[int]
    max_tokens: int = 256
    temperature: float = 0.7
    top_k: int = 0
    top_p: float = 1.0
    stop: list[str] = field(default_factory=list)
    request_id: str = field(default_factory=lambda: uuid.uuid4().hex)
    out: "queue.Queue[Any]" = field(default_factory=queue.Queue)
    created_at: float = field(default_factory=time.time)


@dataclass
class _Slot:
    req: GenRequest
    generated: int = 0
    text: str = ""
    pending: bytes = b""
    prompt_len: int = 0
    first_token_at: float = 0.0
    done: bool = False


@dataclass
class _PrefillState:
    """A slot whose prompt is mid-way through chunked prefill."""

    req: GenRequest
    ids: list[int]
    done: int = 0  # tokens already written into the cache
    shared_len: int = 0  # prefix-cache hit: tokens of the entry it starts with


@dataclass
class _PrefillGroup:
    """A staged ragged chunk group: metas row i ↔ descriptor row i."""

    metas: list  # [(slot, _PrefillState, n)]
    tokens: np.ndarray  # [T]
    rowids: np.ndarray  # [T] (pads = R)
    positions: np.ndarray  # [T] (pads = max_seq_len)
    slots: np.ndarray  # [R]
    starts: np.ndarray  # [R]
    last_idx: np.ndarray  # [R]
    n_tokens: int


class GenerationEngine:
    def __init__(
        self,
        model: str | ModelConfig = "tiny-llm",
        *,
        params: dict | None = None,
        tokenizer: ByteTokenizer | None = None,
        max_slots: int = 8,
        max_seq_len: int = 512,
        dtype: torch.dtype = torch.bfloat16,
        seed: int = 0,
        decode_chunk: int = 4,
        prefill_chunk: int = 512,
        admit_batch: int = 4,
        target_ttft_ms: float = 2000.0,
        prompt_cache_mb: int = 256,
        quant: str = "",
        kv_quant: str = "",
        decode_compact: str = "auto",
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.cfg = get_config(model) if isinstance(model, str) else model
        self.dtype = dtype
        # the JAX engine's options and warnings: int8 weights, int8 KV, and
        # slot compaction (auto = on with the int8 cache, on one device)
        self.quant = quant
        if self.quant and self.quant != "int8":
            log.warning("unknown quant mode %r (supported: int8); serving unquantized", quant)
            self.quant = ""
        self.kv_quant = kv_quant
        if self.kv_quant and self.kv_quant != "int8":
            log.warning("unknown kv_quant mode %r (supported: int8); using %s cache",
                        kv_quant, dtype)
            self.kv_quant = ""
        dc = (decode_compact or "auto").lower()
        if dc not in ("auto", "on", "off"):
            log.warning("unknown decode_compact mode %r (auto|on|off); using auto", dc)
            dc = "auto"
        self.decode_compact = dc == "on" or (dc == "auto" and self.kv_quant == "int8")
        self.max_slots = max_slots
        self.max_seq_len = max_seq_len
        self.decode_chunk = decode_chunk
        self.prefill_chunk = max(0, prefill_chunk)
        self.admit_batch = max(1, admit_batch)
        self.tokenizer = tokenizer or ByteTokenizer()
        self._sched = TokenBudgetScheduler(
            target_ttft_ms=target_ttft_ms,
            min_budget=min(64, self.prefill_chunk) if self.prefill_chunk else 1,
        )
        # packed-buffer capacity: the pow2 floor of a full group's tokens
        cap = max(self.admit_batch * self.prefill_chunk, 1)
        self._ragged_cap = 1 << (cap.bit_length() - 1)

        if params is None:
            g = torch.Generator(device=self.device).manual_seed(seed)
            init = init_llama_params_quantized if self.quant else init_llama_params
            params = init(self.cfg, g, dtype, device=self.device)
        if self.quant:
            # a no-op on an int8 tree; then the single-device fused layout,
            # stored K-contiguous for the int8 GEMM
            params = gemm_layout(fuse_layer_weights(quantize_params(params)))
        self.params = params
        cache = init_kv_cache(self.cfg, max_slots, max_seq_len, dtype=dtype, device=self.device,
                              quantized=self.kv_quant == "int8")
        self._ck, self._cv = cache["k"], cache["v"]
        self._init_prefix_cache(prompt_cache_mb)

        # Host mirrors of per-slot state. Only active (decoding) slots hold
        # an in-range length; free and mid-prefill slots park at
        # max_seq_len so the decode step's append writes nothing there.
        self._lengths = np.full(max_slots, max_seq_len, dtype=np.int32)
        self._last_tok = np.zeros(max_slots, dtype=np.int32)
        self._temp = np.zeros(max_slots, dtype=np.float32)
        self._topk = np.zeros(max_slots, dtype=np.int32)
        self._topp = np.ones(max_slots, dtype=np.float32)
        self._slots: list[_Slot | None] = [None] * max_slots
        self._prefills: dict[int, _PrefillState] = {}
        self._prefill_q: deque[int] = deque()
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.compact_rounds = 0  # decode rounds that ran compacted

        # Only real text ids and eos may be sampled: the model vocab may be
        # larger than the tokenizer's, and pad/bos are control ids.
        allowed = np.ones(self.cfg.vocab_size, dtype=bool)
        allowed[self.tokenizer.vocab_size:] = False
        for bad in (self.tokenizer.pad_id, self.tokenizer.bos_id):
            if bad != self.tokenizer.eos_id and 0 <= bad < self.cfg.vocab_size:
                allowed[bad] = False
        self._allowed = None if allowed.all() else torch.from_numpy(allowed).to(self.device)

        self._admit: "queue.Queue[GenRequest]" = queue.Queue()
        self._wake = threading.Event()
        self._stop_evt = threading.Event()
        self._thread: threading.Thread | None = None

    # -- public surface ----------------------------------------------------

    def start(self) -> "GenerationEngine":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, name="gen-engine", daemon=True)
            self._thread.start()
        return self

    def shutdown(self) -> None:
        self._stop_evt.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        self._abort_all("engine shutdown")

    def submit(self, req: GenRequest) -> GenRequest:
        if self._stop_evt.is_set():
            req.out.put({"type": "error", "error": "engine shutdown"})
            req.out.put(_DONE)
            return req
        self._admit.put(req)
        self._wake.set()
        return req

    def generate_stream(
        self,
        prompt: str,
        *,
        max_tokens: int = 256,
        temperature: float = 0.7,
        top_k: int = 0,
        top_p: float = 1.0,
        stop: list[str] | None = None,
    ) -> Iterator[dict[str, Any]]:
        """Yield {"type":"token","text":...} events then a final
        {"type":"done", "usage":..., "finish_reason":..., "ttft_ms":...}."""
        req = GenRequest(
            prompt_ids=self.tokenizer.encode(prompt),
            max_tokens=max_tokens,
            temperature=temperature,
            top_k=top_k,
            top_p=top_p,
            stop=stop or [],
        )
        self.submit(req)
        while True:
            evt = req.out.get()
            if evt is _DONE:
                return
            yield evt
            if evt.get("type") == "done":
                return

    def generate(self, prompt: str, **kw: Any) -> dict[str, Any]:
        """Non-streaming: returns {"text", "usage", "finish_reason"}."""
        parts: list[str] = []
        final: dict[str, Any] = {}
        for evt in self.generate_stream(prompt, **kw):
            if evt["type"] == "token":
                parts.append(evt["text"])
            elif evt["type"] == "done":
                final = evt
            elif evt["type"] == "error":
                raise RuntimeError(evt.get("error", "generation failed"))
        return {
            "text": "".join(parts),
            "usage": final.get("usage", {}),
            "finish_reason": final.get("finish_reason", "stop"),
        }

    def slots_in_use(self) -> int:
        return sum(1 for s in self._slots if s is not None) + len(self._prefills)

    def queue_depth(self) -> int:
        return self._admit.qsize()

    def prefix_cache_stats(self) -> dict[str, int]:
        """Snapshot of the prompt-prefix cache (the cache itself belongs to
        the engine thread)."""
        return {
            "entries": len(self._prefix_cache),
            "bytes": self._prefix_cache_bytes,
            "hits": self.prefix_cache_hits,
            "misses": self.prefix_cache_misses,
        }

    def paging_stats(self) -> dict[str, float]:
        """The block ledger's economy and audit (`leaks` is 0 when every
        refcount is owed), plus the physical pool's counters when it is
        on."""
        out = self._paging.stats()
        out["enabled"] = 1.0
        out["leaks"] = float(self._paging.leak_count())
        if self._phys is not None:
            out.update(self._phys.stats())
        out["physical"] = 1.0 if self._phys is not None else 0.0
        return out

    # -- prompt-prefix cache and paged KV ----------------------------------

    PREFIX_MIN = 32  # shortest prefix worth caching (tokens)

    def _init_prefix_cache(self, prompt_cache_mb: int) -> None:
        """The ledger, and with physical paging the block tables and the
        prefix pool: the JAX engine's construction and gate."""
        self._prefix_cache: OrderedDict[tuple, dict] = OrderedDict()
        # stored length -> {key: entry}: stored lengths are pow2-floored,
        # so a lookup probes O(log S) buckets
        self._prefix_by_len: dict[int, dict[tuple, dict]] = {}
        self._prefix_cache_bytes = 0
        self._prefix_budget = int(prompt_cache_mb) * (1 << 20) if self.prefill_chunk > 0 else 0
        self._recent_prompts: deque[tuple] = deque(maxlen=16)
        self.prefix_cache_hits = 0
        self.prefix_cache_misses = 0
        # the pytree byte count, as JAX's: the same budget gives the same
        # prefix partition and pool rows
        cache_bytes = _nbytes(self._ck, self._cv)
        self._paging = PagedKVManager(
            max_slots=self.max_slots,
            max_seq_len=self.max_seq_len,
            bytes_per_token=cache_bytes // max(1, self.max_slots * self.max_seq_len),
            prefix_budget_bytes=self._prefix_budget,
        )
        self._phys: PhysicalPool | None = None
        self._pool_k = None  # like the cache: a tensor or the fused dict
        self._pool_v = None
        bt = self._paging.block_tokens
        if (
            os.environ.get("TPU_PAGED_PHYSICAL", "1") not in ("", "0", "false", "no", "off")
            and self._prefix_budget > 0
            and self._paging.prefix_partition >= 1
            and self.max_seq_len % bt == 0
            and bt in (32, 64, 128, 256)
        ):
            rows = self._paging.prefix_partition
            self._phys = PhysicalPool(
                n_slots=self.max_slots, seq_len=self.max_seq_len, block_tokens=bt,
                pool_rows=rows,
            )
            self._pool_k = pool_like(self._ck, rows, bt)
            self._pool_v = pool_like(self._cv, rows, bt)
        log.info(
            "paged KV: %d-token blocks, %d arena + %d prefix blocks, physical %s",
            bt, self._paging.slot_partition, self._paging.prefix_partition,
            self._phys is not None,
        )

    def _paged_operand(self, slots) -> dict | None:
        """The model's `paged` operand when any of `slots` reads a block
        through the pool (decided on the host from the tables), else None:
        the unpaged kernels then run."""
        if self._phys is None or not self._phys.paged(slots):
            return None
        return {"tbl": self._phys.device_table(self.device), "k": self._pool_k, "v": self._pool_v}

    @staticmethod
    def _common_len(a: tuple, b: tuple) -> int:
        n = min(len(a), len(b))
        i = 0
        while i < n and a[i] == b[i]:
            i += 1
        return i

    def _match_prefix(self, ids: list[int]) -> dict | None:
        """Longest cached entry that is a STRICT prefix of `ids` (at least
        one suffix token remains: the suffix chunk gives the first logits)."""
        if not self._prefix_budget or not self._prefix_cache:
            return None
        t = tuple(ids)
        best_key, best = None, None
        for P in sorted(self._prefix_by_len, reverse=True):
            if P >= len(t):
                continue
            e = self._prefix_by_len[P].get(t[:P])
            if e is not None:
                best_key, best = t[:P], e
                break
        if best is not None:
            self._prefix_cache.move_to_end(best_key)  # LRU touch
            self.prefix_cache_hits += 1
        else:
            self.prefix_cache_misses += 1
        return best

    def _start_cached(self, ent: dict, group: list) -> None:
        """Admit a group of hits on one entry: the suffixes join the ragged
        chunk queue at start = P. Physical entries are pinned into each
        slot's table (only an unaligned boundary block is copied);
        contiguous entries copy their rows into every slot."""
        P = ent["P"]
        if "k" in ent:
            for slot, _, _ in group:
                _map(lambda c, e: c[:, slot, :, :P].copy_(e[:, 0]), self._ck, ent["k"])
                _map(lambda c, e: c[:, slot, :, :P].copy_(e[:, 0]), self._cv, ent["v"])
        for slot, req, ids in group:
            self._prefills[slot] = _PrefillState(req=req, ids=list(ids), done=P, shared_len=P)
            self._prefill_q.append(slot)
            ops = self._paging.admit_shared(slot, ent["key"], len(ids))
            if "k" not in ent:
                self._phys_admit(slot, ent, ops)

    def _maybe_store_prefix(self, slot: int, ids: list[int]) -> None:
        """At activation: if this prompt shares a long prefix with recent
        traffic, store that prefix from the slot's rows [0, P0), which hold
        exactly the prompt's KV whatever the admission path."""
        if not self._prefix_budget:
            return
        t = tuple(ids)
        best = 0
        for other in self._recent_prompts:
            if other is not t:
                best = max(best, self._common_len(t, other))
        p0 = min(best, len(t) - 1)  # a hit keeps >= 1 suffix token
        if p0 < self.PREFIX_MIN:
            return
        p0 = 1 << (p0.bit_length() - 1)  # pow2 floor, as the JAX engine stores
        key = t[:p0]
        if key in self._prefix_cache:
            return
        # one ledger: the entry claims blocks from the prefix partition
        # first, evicting LRU entries until it fits
        while not self._paging.prefix_can_fit(p0) and self._prefix_cache:
            self._evict_lru_prefix()
        if self._paging.prefix_register(key, p0) is None:
            return
        # the entry's bytes: every leaf's per-(row, token) bytes times p0
        nbytes = sum(x.numel() // (x.shape[1] * x.shape[3]) * p0 * x.element_size()
                     for x in _leaves(self._ck, self._cv))
        if self._phys is not None:
            if not self._store_prefix_physical(slot, key):
                self._paging.prefix_release(key)
                self._phys.sweep(self._paging.alive)
                return
            ent = {"P": p0, "bytes": nbytes, "key": key}
        else:
            ent = {
                "P": p0, "bytes": nbytes, "key": key,
                "k": _map(lambda c: c[:, slot: slot + 1, :, :p0].clone(), self._ck),
                "v": _map(lambda c: c[:, slot: slot + 1, :, :p0].clone(), self._cv),
            }
        self._prefix_cache[key] = ent
        self._prefix_by_len.setdefault(p0, {})[key] = ent
        self._prefix_cache_bytes += nbytes
        while self._prefix_cache_bytes > self._prefix_budget and self._prefix_cache:
            self._evict_lru_prefix()
        log.info("prefix cache: stored a %d-token prefix (%d entries)", p0, len(self._prefix_cache))

    def _evict_lru_prefix(self) -> None:
        """Evict the least recently used entry. Its pool rows are reclaimed
        only once no table pins its blocks any more."""
        old_key, old = self._prefix_cache.popitem(last=False)
        self._prefix_cache_bytes -= old["bytes"]
        self._paging.prefix_release(old["key"])
        if self._phys is not None:
            self._phys.sweep(self._paging.alive)
        bucket = self._prefix_by_len.get(old["P"])
        if bucket is not None:
            bucket.pop(old_key, None)
            if not bucket:
                del self._prefix_by_len[old["P"]]

    def _store_prefix_physical(self, slot: int, key: tuple) -> bool:
        """Copy a freshly registered entry's blocks into the pool, read
        through the storing slot's own table (a sharer storing a longer
        prefix copies its shared blocks pool to pool). False when the pool
        has no rows; the caller releases the registration."""
        ids = self._paging.prefix_ids(key)
        if ids is None:
            return False
        rows = self._phys.register_prefix(ids)
        if rows is None:
            return False
        for (in_arena, src, off), prow in zip(self._phys.row_sources(slot, len(ids)), rows):
            if in_arena:
                self._pool_put_arena(src, off, prow)
            else:
                self._pool_put_pool(src, prow)
        return True

    def _phys_admit(self, slot: int, ent: dict, ops: list[tuple]) -> None:
        """Physical side of a hit: carry out the ledger's copy-on-write of
        the boundary block (one whole block from the entry's pool row),
        then re-key the slot's table row."""
        for op in ops:
            if op[0] != "cow":
                continue
            phys = self._phys.phys_of(op[2])
            if phys is None:  # tripwire: unmapped entry block (audited)
                self._phys.missing_pins += 1
                continue
            self._cow_block(slot, ent["P"] // self._paging.block_tokens, phys - self._phys.pool_base)
            self._phys.cow_copies_total += 1
        self._phys_rebuild(slot)

    def _phys_rebuild(self, slot: int) -> None:
        if self._phys is not None:
            ids, shared_n = self._paging.table_view(slot)
            self._phys.rebuild(slot, ids, shared_n)

    def _phys_reset(self, slot: int) -> None:
        """Slot released: its table row back to identity, then reclaim the
        pool rows whose ledger ids just died."""
        if self._phys is not None:
            self._phys.reset(slot)
            self._phys.sweep(self._paging.alive)

    # Device block copies, in place on the engine's stream (the JAX
    # engine's `_cow_block_raw`, `_pool_put_arena_raw`, `_pool_put_pool_raw`),
    # over every leaf: a fused int8 block moves all its payload heads (the
    # packed pseudo-head too) and its plain scales together.

    def _cow_block(self, slot: int, blk: int, prow: int) -> None:
        """Pool row `prow` into block `blk` of the slot's arena row."""
        bt = self._paging.block_tokens
        for c, p in ((self._ck, self._pool_k), (self._cv, self._pool_v)):
            _map(lambda a, b: a[:, slot, :, blk * bt: (blk + 1) * bt].copy_(b[:, prow]), c, p)

    def _pool_put_arena(self, row: int, off: int, prow: int) -> None:
        """One block of arena row `row` at token offset `off` into pool row `prow`."""
        bt = self._paging.block_tokens
        for c, p in ((self._ck, self._pool_k), (self._cv, self._pool_v)):
            _map(lambda a, b: b[:, prow].copy_(a[:, row, :, off: off + bt]), c, p)

    def _pool_put_pool(self, src: int, dst: int) -> None:
        for p in _leaves(self._pool_k, self._pool_v):
            p[:, dst] = p[:, src]

    def kv_scale_audit(self) -> int:
        """Positions (layer, row, head, token) of the arena and the pool
        where the fused int8 cache's packed pseudo-head and its plain
        scales "s" disagree in any bit. Every write and copy path keeps
        them equal, so 0 is sound; a bf16 cache, one without the
        pseudo-head and the MLA latent cache (whose planes carry their
        scales in "s" alone) have nothing to audit."""
        bad = 0
        for c in (self._ck, self._pool_k):
            if not isinstance(c, dict) or c["q"].shape[2] == c["s"].shape[2]:
                continue
            Hs = c["s"].shape[2]
            nb = Hs * c["s"].element_size()
            packed = c["q"][:, :, Hs, :, :nb].reshape(*c["q"].shape[:2], -1, Hs, nb // Hs)
            plain = c["s"].transpose(2, 3).contiguous().view(torch.int8)
            plain = plain.reshape(packed.shape)
            bad += int((packed != plain).any(dim=-1).sum().item())
        return bad

    def _reset_kv(self) -> None:
        """After a failed step: the caches may hold partial writes, and a
        prefix entry pointing at them would give wrong answers. Zero the
        cache, drop every prefix entry, reset every table and zero the pool
        (as the JAX engine's `_recover_cache`); `_abort_all` follows and
        frees every slot's table, which returns the last pool rows."""
        for x in _leaves(self._ck, self._cv):
            x.zero_()
        while self._prefix_cache:
            self._evict_lru_prefix()
        if self._phys is not None:
            for x in _leaves(self._pool_k, self._pool_v):
                x.zero_()
            self._phys.reset_all()

    # -- engine loop -------------------------------------------------------

    def _run(self) -> None:
        with torch.inference_mode():
            while not self._stop_evt.is_set():
                try:
                    busy = self._step()
                except Exception as e:  # a failed dispatch must not hang waiters
                    log.exception("engine step failed")
                    self._reset_kv()
                    self._abort_all(f"engine step failed: {e}")
                    busy = False
                if not busy:
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()

    def _step(self) -> bool:
        K, S = self.decode_chunk, self.max_seq_len
        active = [
            i for i, s in enumerate(self._slots) if s is not None and self._lengths[i] + K <= S
        ]
        group = self._stage_ragged_group(len(active))
        round_out = None
        if active:
            round_out = self._decode_round(active)
        if group is not None:
            self._run_prefill_group(group)
        if round_out is not None:
            self._emit_round(*round_out)
        admitted = self._admit_pending()
        return bool(active or group is not None or admitted)

    def _t(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _sample(self, logits, temps, topks, topps, active=None) -> torch.Tensor:
        if self._allowed is not None:
            logits = logits.masked_fill(~self._allowed, float("-inf"))
        return sample_tokens(
            logits, self._gen, self._t(temps), self._t(topks), self._t(topps), active=active
        )

    def _decode_round(self, active: list[int]):
        """`decode_chunk` decode steps. Uncompacted, the whole batch runs
        (parked rows ride along and write nothing); compacted, a pow2
        bucket Ba of the active rows (floor min(8, B)), each reading its
        cache row through `slot_ids`, and at Ba == B the uncompacted step.
        Returns the fetched tokens [K, B]."""
        t0 = time.perf_counter()
        B, S, K = self.max_slots, self.max_seq_len, self.decode_chunk
        nact = len(active)
        Ba = pow2_bucket(nact, B, floor=min(8, B)) if self.decode_compact else B
        if Ba < B:
            # pad rows are parked (w = S: the append writes nothing) and aim
            # at a row that is neither active nor mid-prefill, as in JAX
            in_round = set(active)
            free = next(
                (i for i in range(B) if self._slots[i] is None and i not in self._prefills),
                next((i for i in range(B) if self._slots[i] is None),
                     next(i for i in range(B) if i not in in_round)),
            )
            rows = np.full(Ba, free, dtype=np.int32)
            rows[:nact] = active
            lens_in = np.full(Ba, S, dtype=np.int32)
            lens_in[:nact] = self._lengths[active]
            slot_ids = self._t(rows)
        else:
            rows, lens_in, slot_ids = np.arange(B), self._lengths, None
        lens = self._t(lens_in)
        toks = self._t(self._last_tok[rows])
        temps, topks, topps = self._temp[rows], self._topk[rows], self._topp[rows]
        paged = self._paged_operand(active)  # the tables do not change in a round
        outs = []
        for _ in range(K):
            logits, self._ck, self._cv = llama_decode_step(
                self.cfg, self.params, self._ck, self._cv, toks, lens, slot_ids=slot_ids,
                paged=paged,
            )
            toks = self._sample(logits, temps, topks, topps, active=lens < S)
            outs.append(toks)
            lens = torch.where(lens < S, lens + 1, lens)
        got = torch.stack(outs).cpu().numpy()  # the round's one host sync
        self._sched.observe_decode(time.perf_counter() - t0)
        self.compact_rounds += int(Ba < B)
        n = nact if Ba < B else B  # the rows of `got` that are slots' own
        out = np.zeros((K, B), dtype=got.dtype)
        out[:, rows[:n]] = got[:, :n]
        base = self._lengths.copy()
        for b in active:
            self._lengths[b] = min(int(base[b]) + K, S)
            self._last_tok[b] = out[-1, b]
        # ledger: grow the tables to cover the advanced lengths
        self._paging.extend_many({b: int(self._lengths[b]) for b in active})
        return out, active, base

    def _emit_round(self, out: np.ndarray, active: list[int], base: np.ndarray) -> None:
        for b in active:
            s = self._slots[b]
            if s is None or s.done:
                continue
            parts: list[str] = []
            finish = None
            for k in range(out.shape[0]):
                emit, finish = self._process_token(s, int(out[k, b]), int(base[b]) + k)
                if emit:
                    parts.append(emit)
                if finish is not None:
                    break
            if parts:
                s.req.out.put({"type": "token", "text": "".join(parts)})
            if finish is not None:
                self._finish_slot(b, s, finish)

    # -- admission ---------------------------------------------------------

    def _free_slot(self, reserved: set[int]) -> int | None:
        for i, s in enumerate(self._slots):
            if s is None and i not in self._prefills and i not in reserved:
                return i
        return None

    def _admit_pending(self) -> bool:
        admitted = False
        while True:
            batch: list[tuple[int, GenRequest, list[int]]] = []
            # prefix-cache hits grouped by entry
            hits: dict[int, tuple[dict, list]] = {}
            reserved: set[int] = set()
            while len(batch) < self.admit_batch:
                slot = self._free_slot(reserved)
                if slot is None:
                    break
                try:
                    req = self._admit.get_nowait()
                except queue.Empty:
                    break
                ids = req.prompt_ids
                # leave room for at least one decode chunk after the prompt
                max_prompt = self.max_seq_len - self.decode_chunk
                if len(ids) > max_prompt:  # keep the tail
                    ids = ids[-max_prompt:]
                if req.max_tokens <= 0:
                    req.out.put({
                        "type": "done",
                        "finish_reason": "length",
                        "usage": {
                            "prompt_tokens": len(ids),
                            "completion_tokens": 0,
                            "total_tokens": len(ids),
                        },
                        "ttft_ms": 0.0,
                    })
                    req.out.put(_DONE)
                    continue
                admitted = True
                ent = self._match_prefix(ids)
                if ent is not None:
                    # cached prefix: only the suffix prefills, in ragged chunks
                    reserved.add(slot)
                    hits.setdefault(id(ent), (ent, []))[1].append((slot, req, list(ids)))
                    continue
                if self.prefill_chunk and len(ids) > self.prefill_chunk:
                    # long prompt: reserve the slot, prefill chunk by chunk;
                    # the ledger commits the prompt's blocks now
                    self._prefills[slot] = _PrefillState(req=req, ids=list(ids))
                    self._prefill_q.append(slot)
                    self._paging.admit_slot(slot, len(ids))
                    continue
                reserved.add(slot)
                batch.append((slot, req, list(ids)))
            for ent, group in hits.values():
                try:
                    self._start_cached(ent, group)
                except Exception as e:
                    log.exception("prefix-cache admission failed")
                    for slot, req, _ in group:
                        if self._prefills.pop(slot, None) is not None:
                            self._prefill_q.remove(slot)
                        self._paging.free_slot(slot)
                        self._phys_reset(slot)
                        self._error(req, str(e))
            if not batch:
                if hits:
                    continue  # hit slots consumed; more of the queue may admit
                break
            try:
                self._start_batch(batch)
            except Exception as e:
                log.exception("prefill failed")
                for slot, req, _ in batch:
                    s = self._slots[slot]
                    if s is not None and s.req is req:
                        self._free_now(slot)
                    self._error(req, str(e))
            if len(batch) < self.admit_batch:
                break
        return admitted

    def _start_batch(self, batch: list[tuple[int, GenRequest, list[int]]]) -> None:
        """Prefill up to admit_batch short prompts in one batch, insert
        their K/V into their slots and sample their first tokens."""
        A = len(batch)
        Ab = 1 << (A - 1).bit_length()  # pow2 rows: pad rows are 1 harmless token
        bucket = fine_bucket(max(len(ids) for _, _, ids in batch), self.max_seq_len)
        tokens = np.zeros((Ab, bucket), dtype=np.int32)
        lengths = np.ones((Ab,), dtype=np.int32)
        for i, (_, _, ids) in enumerate(batch):
            tokens[i, : len(ids)] = ids
            lengths[i] = len(ids)
        logits, ks, vs = llama_prefill(self.cfg, self.params, self._t(tokens), self._t(lengths),
                                       quant_kv=self.kv_quant == "int8")
        for i, (slot, _, _) in enumerate(batch):
            _map(lambda c, k: c[:, slot, :, :bucket].copy_(k[:, i]), self._ck, ks)
            _map(lambda c, v: c[:, slot, :, :bucket].copy_(v[:, i]), self._cv, vs)
        reqs = [req for _, req, _ in batch]
        toks0 = self._sample(
            logits[:A],
            np.asarray([r.temperature for r in reqs], np.float32),
            np.asarray([r.top_k for r in reqs], np.int32),
            np.asarray([r.top_p for r in reqs], np.float32),
        ).cpu().numpy()
        for i, (slot, req, ids) in enumerate(batch):
            self._activate_state(slot, req, ids, int(toks0[i]))

    def _activate_state(
        self, slot: int, req: GenRequest, ids: list[int], tok0: int, shared_len: int = 0
    ) -> None:
        P = len(ids)
        # the slot's rows [0, P) now hold exactly this prompt's KV: the
        # moment to learn a shared prefix for later admissions
        self._maybe_store_prefix(slot, ids)
        self._recent_prompts.append(tuple(ids))
        # ledger: batch admissions get their table here; the chunked and
        # hit paths reserved one already (ensure extends it)
        mgr = self._paging
        mgr.ensure_slot(slot, P)
        want = min(P + max(0, req.max_tokens) + self.decode_chunk, self.max_seq_len)
        mgr.note_admit_cost(mgr.blocks_for(want) - shared_len // mgr.block_tokens)
        s = _Slot(req=req, prompt_len=P, first_token_at=time.time())
        self._slots[slot] = s
        self._lengths[slot] = P
        self._last_tok[slot] = tok0
        self._temp[slot] = req.temperature
        self._topk[slot] = req.top_k
        self._topp[slot] = req.top_p
        # tok0's K/V is written at position P by the first decode round
        emit, finish = self._process_token(s, tok0, P - 1)
        if emit:
            req.out.put({"type": "token", "text": emit})
        if finish is not None:
            self._finish_slot(slot, s, finish)

    # -- chunked (ragged) prefill ------------------------------------------

    def _prefill_backlog(self) -> int:
        return sum(len(st.ids) - st.done for st in self._prefills.values())

    def _stage_ragged_group(self, n_active: int) -> _PrefillGroup | None:
        """Pack up to admit_batch mid-prefill slots' next chunks back to
        back into one [T] buffer under the scheduler's budget."""
        if not self._prefill_q:
            return None
        oldest = min(self._prefills[s].req.created_at for s in self._prefill_q)
        budget = self._sched.decide(self._prefill_backlog(), n_active, time.time() - oldest)
        if budget <= 0:
            return None
        R = self.admit_batch
        S = self.max_seq_len
        cap = min(budget, self._ragged_cap)
        picked: list[tuple[int, _PrefillState, int, int]] = []
        used = 0
        for slot in list(self._prefill_q):
            if len(picked) >= R or used >= cap:
                break
            st = self._prefills[slot]
            n = min(self.prefill_chunk, len(st.ids) - st.done, cap - used)
            if n <= 0:
                continue
            picked.append((slot, st, st.done, n))
            used += n
        if not picked:
            return None
        T = pow2_bucket(used, self._ragged_cap, floor=min(32, self._ragged_cap))
        tokens = np.zeros((T,), dtype=np.int32)
        rowids = np.full((T,), R, dtype=np.int32)  # pads: row R
        positions = np.full((T,), S, dtype=np.int32)  # pads: position S
        slots = np.zeros((R,), dtype=np.int32)
        starts = np.zeros((R,), dtype=np.int32)
        last_idx = np.zeros((R,), dtype=np.int32)
        metas = []
        off = 0
        for i, (slot, st, start, n) in enumerate(picked):
            tokens[off: off + n] = st.ids[start: start + n]
            rowids[off: off + n] = i
            positions[off: off + n] = np.arange(start, start + n)
            slots[i] = slot
            starts[i] = start
            last_idx[i] = off + n - 1
            metas.append((slot, st, n))
            off += n
        return _PrefillGroup(
            metas=metas, tokens=tokens, rowids=rowids, positions=positions,
            slots=slots, starts=starts, last_idx=last_idx, n_tokens=used,
        )

    def _run_prefill_group(self, group: _PrefillGroup) -> None:
        """Run one staged group, advance chunk progress and activate the
        prompts whose last chunk landed."""
        t0 = time.perf_counter()
        try:
            logits, self._ck, self._cv = llama_prefill_chunk_ragged(
                self.cfg, self.params, self._ck, self._cv,
                self._t(group.tokens), self._t(group.rowids), self._t(group.positions),
                self._t(group.slots), self._t(group.starts), self._t(group.last_idx),
                paged=self._paged_operand([slot for slot, _, _ in group.metas]),
            )
            fin = []
            for i, (slot, st, n) in enumerate(group.metas):
                st.done += n
                if st.done >= len(st.ids):
                    fin.append((i, slot, st))
            toks0 = None
            if fin:
                reqs = [st.req for _, _, st in fin]
                toks0 = self._sample(
                    logits[[i for i, _, _ in fin]],
                    np.asarray([r.temperature for r in reqs], np.float32),
                    np.asarray([r.top_k for r in reqs], np.int32),
                    np.asarray([r.top_p for r in reqs], np.float32),
                ).cpu().numpy()
            else:
                self._sync()
            self._sched.observe_prefill(
                group.n_tokens, time.perf_counter() - t0, padded_tokens=len(group.tokens)
            )
            for k, (_, slot, st) in enumerate(fin):
                self._prefill_q.remove(slot)
                del self._prefills[slot]
                self._activate_state(slot, st.req, st.ids, int(toks0[k]), st.shared_len)
        except Exception as e:
            log.exception("chunked prefill failed")
            for slot, st, _ in group.metas:
                if self._prefills.pop(slot, None) is not None:
                    self._prefill_q.remove(slot)
                    self._paging.free_slot(slot)  # reserved, not activated
                    self._phys_reset(slot)
                    self._error(st.req, str(e))

    # -- emission ----------------------------------------------------------

    def _process_token(self, s: _Slot, tok: int, pos: int) -> tuple[str, str | None]:
        """Advance one slot by one token: (text to emit, finish_reason | None).
        `pos` is the cache position the token's K/V occupies."""
        req = s.req
        finish = None
        emit = ""
        cut = -1
        if tok == self.tokenizer.eos_id:
            finish = "stop"
        else:
            s.generated += 1
            text, s.pending = self.tokenizer.decode_stream(s.pending, [tok])
            # stop sequences trim before emission; scan the window where a
            # stop could straddle the old/new text boundary
            prev_len = len(s.text)
            total = s.text + text
            for stop_s in req.stop:
                if not stop_s:
                    continue
                i = total.find(stop_s, max(0, prev_len - len(stop_s) + 1))
                if i != -1 and (cut == -1 or i < cut):
                    cut = i
            if cut != -1:
                emit = total[prev_len:cut]
                s.text = total[:cut]
                finish = "stop"
            else:
                emit = text
                s.text = total
            if finish is None and s.generated >= req.max_tokens:
                finish = "length"
            if finish is None and pos + 1 + self.decode_chunk > self.max_seq_len:
                finish = "length"
        if finish is not None and s.pending:
            if cut == -1:
                emit += self.tokenizer.decode_flush(s.pending)
            s.pending = b""
        return emit, finish

    def _finish_slot(self, slot: int, s: _Slot, finish: str) -> None:
        req = s.req
        s.done = True
        req.out.put({
            "type": "done",
            "finish_reason": finish,
            "usage": {
                "prompt_tokens": s.prompt_len,
                "completion_tokens": s.generated,
                "total_tokens": s.prompt_len + s.generated,
            },
            "ttft_ms": (s.first_token_at - req.created_at) * 1000.0,
        })
        req.out.put(_DONE)
        if self._slots[slot] is s:
            self._free_now(slot)

    def _free_now(self, b: int) -> None:
        self._slots[b] = None
        self._lengths[b] = self.max_seq_len  # park
        # ledger: drop the table (idempotent); its device row back to identity
        self._paging.free_slot(b)
        self._phys_reset(b)

    def _error(self, req: GenRequest, msg: str) -> None:
        req.out.put({"type": "error", "error": msg})
        req.out.put(_DONE)

    def _abort_all(self, msg: str) -> None:
        """Error every live, mid-prefill and queued request. Every slot and
        ledger table is released before the first error goes out, so a
        caller that sees the error sees the engine's state settled."""
        failed = []
        for b, s in enumerate(self._slots):
            if s is not None and not s.done:
                s.done = True
                failed.append(s.req)
            self._free_now(b)
        for slot in list(self._prefills):
            self._paging.free_slot(slot)
            self._phys_reset(slot)
            failed.append(self._prefills.pop(slot).req)
        self._prefill_q.clear()
        while True:
            try:
                failed.append(self._admit.get_nowait())
            except queue.Empty:
                break
        for req in failed:
            self._error(req, msg)
