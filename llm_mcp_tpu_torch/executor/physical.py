"""Physical half of the paged KV ledger: per-slot device block tables plus
a prefix block pool (counterpart of `llm_mcp_tpu/executor/physical.py`;
vLLM PagedAttention, Kwon et al. 2023).

``paging.PagedKVManager`` holds refcounted ids and no bytes. This module
makes those ids physical with one twist, the **identity home**: a slot's
private block at logical index ``j`` always lives at physical id
``slot * blocks_per_slot + j``, exactly where the contiguous layout puts
it. Only shared (prefix-pinned) blocks resolve elsewhere, to rows of a
separate device pool sized by the prefix partition. So:

- every KV write path (the decode append, the ragged-prefill scatter,
  admission) is untouched: writes target private positions, and private
  positions are identity;
- a table row that references no shared block is the identity, so the
  engine can tell on the host that a step needs no paged kernel;
- positions past a slot's ledger table keep the identity home, a value
  that is always safe to dereference.

Physical ids are ``[0, n_slots * blocks_per_slot)`` for arena homes and
``[pool_base, pool_base + pool_rows)`` for pool rows, with
``pool_base = n_slots * blocks_per_slot``; the kernels and
`kernels.attention.paged_gather` split on ``phys < pool_base``.

Pool rows are owned by ledger ids, not prefix keys: ``register_prefix``
maps a prefix entry's ledger ids to pool rows, and ``sweep`` reclaims a row
only once ``PagedKVManager.alive()`` says the ledger id died, so an evicted
entry's rows stay readable while sharer pins keep the id alive.

Host bookkeeping is numpy; ``device_table()`` uploads the table only after
a mutation, never once per step. A small lock guards the table, since free
paths may race the engine loop.
"""

from __future__ import annotations

import threading
from typing import Callable, Iterable

import numpy as np
import torch


def pool_like(cache, pool_rows: int, block_tokens: int):
    """Zeroed prefix pool for a KV cache ``[L, B, Hkv, S, hd]``: the slot
    axis becomes ``pool_rows`` and the S axis ``block_tokens``, giving
    ``[L, pool_rows, Hkv, block_tokens, hd]`` on the cache's device. One
    pool row holds one block's tokens across all layers. A fused int8
    cache maps leaf by leaf, as JAX maps its pytree:
    ``{"q": [L, rows, 2*Hkv+p, bt, hd], "s": [L, rows, 2*Hkv, bt]}``, and
    its empty V side ``{}`` stays ``{}``."""
    if isinstance(cache, dict):
        return {k: pool_like(v, pool_rows, block_tokens) for k, v in cache.items()}
    shape = (cache.shape[0], pool_rows, cache.shape[2], block_tokens) + tuple(cache.shape[4:])
    return torch.zeros(shape, dtype=cache.dtype, device=cache.device)


class PhysicalPool:
    """Device block tables + pool-row allocator over the ledger's ids."""

    def __init__(self, *, n_slots: int, seq_len: int, block_tokens: int, pool_rows: int):
        if seq_len % block_tokens:
            raise ValueError("seq_len must be a multiple of block_tokens")
        self.n_slots = int(n_slots)
        self.block_tokens = int(block_tokens)
        self.nbs = seq_len // self.block_tokens  # blocks per slot
        self.pool_rows = int(pool_rows)
        self.pool_base = self.n_slots * self.nbs

        self._identity = np.arange(self.pool_base, dtype=np.int32).reshape(self.n_slots, self.nbs)
        self.table = self._identity.copy()
        self._lock = threading.Lock()
        self._dirty = True
        self._dev: torch.Tensor | None = None

        self._phys: dict[int, int] = {}  # ledger block id -> pool row
        self._free: list[int] = list(range(self.pool_rows - 1, -1, -1))

        self.rebuilds_total = 0
        self.uploads_total = 0
        self.cow_copies_total = 0
        self.missing_pins = 0  # shared pin with no pool mapping (bug tripwire)
        self.pool_rows_peak = 0

    # -- pool-row ownership --------------------------------------------------

    def register_prefix(self, ledger_ids: Iterable[int]) -> list[int] | None:
        """Map a prefix entry's ledger ids to fresh pool rows; None when the
        pool is out of rows (the caller releases the ledger entry and skips
        the store)."""
        ids = list(ledger_ids)
        with self._lock:
            if len(self._free) < len(ids):
                return None
            rows = [self._free.pop() for _ in ids]
            for bid, row in zip(ids, rows):
                self._phys[bid] = row
            used = self.pool_rows - len(self._free)
            if used > self.pool_rows_peak:
                self.pool_rows_peak = used
            return rows

    def phys_of(self, ledger_id: int) -> int | None:
        """Physical id (pool_base + row) for a prefix-mapped ledger id."""
        with self._lock:
            row = self._phys.get(ledger_id)
            return None if row is None else self.pool_base + row

    def sweep(self, alive: Callable[[int], bool]) -> int:
        """Reclaim pool rows whose ledger id died."""
        with self._lock:
            dead = [bid for bid in self._phys if not alive(bid)]
            for bid in dead:
                self._free.append(self._phys.pop(bid))
            return len(dead)

    # -- table maintenance ---------------------------------------------------

    def rebuild(self, slot: int, ids: list[int], shared_n: int) -> bool:
        """Re-key one slot's table row from its ledger ``table_view``. Shared
        pins resolve through the pool map; private blocks, copy-on-write
        destinations and padding past the ledger table stay at the identity
        home. Returns True when the row changed."""
        row = self._identity[slot].copy()
        with self._lock:
            for j in range(min(shared_n, len(ids), self.nbs)):
                prow = self._phys.get(ids[j])
                if prow is None:
                    self.missing_pins += 1  # identity home = stale bytes; audited
                else:
                    row[j] = self.pool_base + prow
            if np.array_equal(row, self.table[slot]):
                return False
            self.table[slot] = row
            self._dirty = True
            self.rebuilds_total += 1
            return True

    def reset(self, slot: int) -> bool:
        """Back to identity (slot freed). Returns True when the row changed."""
        with self._lock:
            if np.array_equal(self.table[slot], self._identity[slot]):
                return False
            self.table[slot] = self._identity[slot]
            self._dirty = True
            return True

    def reset_all(self) -> None:
        with self._lock:
            self.table[:] = self._identity
            self._dirty = True

    def paged(self, slots: Iterable[int]) -> bool:
        """True when any of `slots` reads a block through the pool, i.e.
        its table row is not the identity (decided on the host, no device
        sync)."""
        idx = list(slots)
        with self._lock:
            return bool(idx) and not np.array_equal(self.table[idx], self._identity[idx])

    def device_table(self, device: torch.device | str) -> torch.Tensor:
        """Device copy of the int32 ``[n_slots, nbs]`` table, uploaded again
        only after a mutation. On the card the upload is a pinned copy sent
        non-blocking: it waits for no earlier work on the stream."""
        with self._lock:
            if self._dirty or self._dev is None or self._dev.device != torch.device(device):
                host = torch.from_numpy(self.table.copy())
                if torch.device(device).type == "cuda":
                    host = host.pin_memory()
                self._dev = host.to(device, non_blocking=True)
                self._dirty = False
                self.uploads_total += 1
            return self._dev

    # -- read-side helpers ---------------------------------------------------

    def row_sources(self, slot: int, nblocks: int) -> list[tuple[bool, int, int]]:
        """Host-side decode of one slot's first ``nblocks`` table entries:
        ``(in_arena, arena_row_or_pool_row, token_offset)`` per block."""
        out: list[tuple[bool, int, int]] = []
        with self._lock:
            row = self.table[slot, : max(0, min(nblocks, self.nbs))].tolist()
        for phys in row:
            if phys < self.pool_base:
                out.append((True, phys // self.nbs, (phys % self.nbs) * self.block_tokens))
            else:
                out.append((False, phys - self.pool_base, 0))
        return out

    def stats(self) -> dict[str, float]:
        with self._lock:
            return {
                "physical_pool_rows": float(self.pool_rows),
                "physical_pool_rows_used": float(self.pool_rows - len(self._free)),
                "physical_pool_rows_peak": float(self.pool_rows_peak),
                "physical_rebuilds_total": float(self.rebuilds_total),
                "physical_table_uploads_total": float(self.uploads_total),
                "physical_cow_copies_total": float(self.cow_copies_total),
                "physical_missing_pins": float(self.missing_pins),
            }
