"""KV pool: admission accounting, preemption policy, host offload
(counterpart of `llm_mcp_tpu/executor/memory.py`).

The engine owns a static `[layers, max_slots, heads, max_seq_len,
head_dim]` KV cache (the fused int8 dict and the MLA latent planes too),
sized at construction. This module is the memory manager over it:

  - **Accounting**: bytes per slot are measured from the live cache tree
    (`pytree_nbytes`), so every layout is covered without layout code.
  - **Admission**: `admit_ok(offered)` compares the offered load (in
    slot-equivalents, from the ledger's unique-block accounting) with
    `watermark × max_slots`. Above it the API sheds (429 + Retry-After).
  - **Preemption**: `pick_victim` orders candidates by policy:
    "priority" (lowest priority, then longest idle, then most tokens
    remaining), "idle", "tokens", "slo_debt". Every policy first prefers
    a larger `slo_surplus`; the port has no tenants, so every surplus
    reads 0.0 and the order is the policy's own.

The engine copies the victim's committed KV rows to pinned host memory,
frees the slot, and later writes the rows back into the same cache
storage. Greedy output is token-identical across the cycle. Where JAX
copies the pow2 `bucket_len` of the committed length (XLA compiles one
slice shape per bucket), the port copies exactly the committed rows
`[start, length)`: rows past `length` are dead, and the first decode
round after the restore writes position `length` before anything reads
it. So `offload_bytes_total` is smaller than the JAX engine's for the
same traffic, by design.

The pool is host bookkeeping only (no torch): the engine keeps every
device interaction, and with `TPU_KV_HOST_OFFLOAD` off no pool exists.
Every mutating entry point takes the pool's lock: the engine thread
mutates while API threads read `stats()` and the admission state.
Migration's snapshot fields (`shared_key`, `migrated`, `shared_pool_rows`)
come with migration, in a later slice.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

from ..utils.locks import OrderedLock

__all__ = ["KVPool", "KVSnapshot", "pytree_nbytes", "bucket_len"]

POLICIES = ("priority", "idle", "tokens", "slo_debt")

# Thrash guards: at most one preemption per interval, and restores age
# past fairness after this many multiples of the TTFT target (a
# low-priority snapshot cannot starve forever behind high-priority
# arrivals, and the other way round).
PREEMPT_MIN_INTERVAL_S = 1.0
RESTORE_AGING_TTFT_MULT = 2.0


def pytree_nbytes(tree: Any) -> int:
    """Total bytes of every array leaf of a nested dict/list/tuple tree:
    torch tensors (`numel() * element_size()`) and numpy arrays (`size *
    dtype.itemsize`); other leaves count 0."""
    if isinstance(tree, dict):
        return sum(pytree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(pytree_nbytes(v) for v in tree)
    numel = getattr(tree, "numel", None)
    if callable(numel) and hasattr(tree, "element_size"):
        return int(numel()) * int(tree.element_size())
    size = getattr(tree, "size", None)
    dtype = getattr(tree, "dtype", None)
    if size is None or dtype is None:
        return 0
    return int(size) * int(dtype.itemsize)


def bucket_len(length: int, max_seq_len: int) -> int:
    """Power-of-two bucket >= length, capped at max_seq_len (JAX's
    snapshot length)."""
    b = 1
    while b < length:
        b *= 2
    return max(1, min(b, max_seq_len))


@dataclass
class KVSnapshot:
    """A preempted slot's host-side state. `k_rows`/`v_rows` hold the
    committed rows `[shared_len, length)` of every cache leaf (a dict for
    the int8 layouts; `{}` for the fused int8 cache's empty V side), in
    pinned host memory on the card."""

    req_id: str
    priority: int
    length: int
    bucket: int  # the end of the copied rows: `length` in the port (JAX: its pow2 bucket)
    last_tok: int
    temperature: float
    top_k: int
    top_p: float
    k_rows: Any
    v_rows: Any
    nbytes: int
    preempted_at: float
    slot_obj: Any = None  # the engine's live slot record, reinstalled on restore
    # the paging ledger's key for the parked shared pins
    snap_id: int = -1
    # admitted off a prefix hit: the rows hold only the private part
    # [shared_len, length); the shared blocks stay pinned in the ledger and
    # come back from `shared_entry` (contiguous entries: its device rows;
    # physical ones: a re-pin). 0 = whole snapshot.
    shared_len: int = 0
    shared_entry: Any = None


class KVPool:
    def __init__(
        self,
        *,
        max_slots: int,
        max_seq_len: int,
        bytes_per_slot: int,
        watermark: float = 1.5,
        policy: str = "priority",
        max_preempted: int | None = None,
    ):
        if policy not in POLICIES:
            raise ValueError(f"unknown preempt policy {policy!r}; expected one of {POLICIES}")
        self.max_slots = int(max_slots)
        self.max_seq_len = int(max_seq_len)
        self.bytes_per_slot = int(bytes_per_slot)
        self.watermark = max(1.0, float(watermark))
        self.policy = policy
        # bound host memory: never hold more snapshots than slots
        self.max_preempted = int(max_preempted) if max_preempted else self.max_slots
        self._lock = OrderedLock("kvpool", rank=20)
        self._snaps: list[KVSnapshot] = []
        self._last_preempt_at = 0.0
        self.preempted_total = 0
        self.restored_total = 0
        self.shed_total = 0
        self.offload_bytes_total = 0
        self.offload_seconds_total = 0.0
        self.restore_seconds_total = 0.0

    # -- accounting --------------------------------------------------------

    def hbm_bytes(self) -> int:
        return self.max_slots * self.bytes_per_slot

    def admit_ok(self, offered: float) -> bool:
        """True while the offered load (slot-equivalents) is under the
        watermark. Side-effect free: a caller that sheds records it with
        `note_shed()`."""
        return offered < self.watermark * self.max_slots

    def headroom(self, offered: float) -> float:
        """Fraction of shed-free capacity left, in [0, 1]."""
        cap = self.watermark * self.max_slots
        if cap <= 0:
            return 0.0
        return max(0.0, min(1.0, 1.0 - offered / cap))

    # -- preemption policy -------------------------------------------------

    def may_preempt(self, now: float | None = None) -> bool:
        """Rate limit and host-memory bound; side-effect free."""
        now = time.time() if now is None else now
        with self._lock:
            if len(self._snaps) >= self.max_preempted:
                return False
            return now - self._last_preempt_at >= PREEMPT_MIN_INTERVAL_S

    def pick_victim(self, candidates: list[dict]) -> dict | None:
        """The candidate to evict, or None when there is none. Each carries
        `priority`, `last_activity`, `tokens_remaining`, optionally
        `slo_surplus`, and the engine's own keys (`slot`)."""
        if not candidates:
            return None
        if self.policy == "idle":
            base = lambda c: (c["last_activity"], c["priority"], -c["tokens_remaining"])
        elif self.policy == "tokens":
            base = lambda c: (-c["tokens_remaining"], c["priority"], c["last_activity"])
        else:  # "priority"/"slo_debt": lowest priority, longest idle, most remaining
            base = lambda c: (c["priority"], c["last_activity"], -c["tokens_remaining"])
        key = lambda c: (-float(c.get("slo_surplus", 0.0)), *base(c))
        return min(candidates, key=key)

    # -- offload / restore bookkeeping --------------------------------------

    def offload(self, snap: KVSnapshot, seconds: float = 0.0) -> None:
        with self._lock:
            self._snaps.append(snap)
            self._last_preempt_at = max(self._last_preempt_at, snap.preempted_at)
            self.preempted_total += 1
            self.offload_bytes_total += int(snap.nbytes)
            self.offload_seconds_total += max(0.0, float(seconds))

    def preempted_count(self) -> int:
        with self._lock:
            return len(self._snaps)

    def has_preempted(self) -> bool:
        return self.preempted_count() > 0

    def peek_restore(self) -> KVSnapshot | None:
        """The next snapshot to restore (highest priority, then longest
        preempted), left in place."""
        with self._lock:
            if not self._snaps:
                return None
            return min(self._snaps, key=lambda s: (-s.priority, s.preempted_at))

    def pop_restore(self) -> KVSnapshot | None:
        with self._lock:
            if not self._snaps:
                return None
            snap = min(self._snaps, key=lambda s: (-s.priority, s.preempted_at))
            self._snaps.remove(snap)
            return snap

    def requeue(self, snap: KVSnapshot) -> None:
        """Put back a popped snapshot whose restore was deferred; no counter
        moves."""
        with self._lock:
            self._snaps.append(snap)

    def discard(self, snap: KVSnapshot) -> None:
        """Drop a snapshot without restoring it."""
        with self._lock:
            try:
                self._snaps.remove(snap)
            except ValueError:
                pass

    def note_restored(self, snap: KVSnapshot, seconds: float = 0.0) -> None:
        with self._lock:
            self.restored_total += 1
            self.restore_seconds_total += max(0.0, float(seconds))

    def note_shed(self, n: int = 1) -> None:
        with self._lock:
            self.shed_total += int(n)

    def drain(self) -> list[KVSnapshot]:
        """Remove and return every held snapshot (abort and shutdown: the
        engine errors each one's waiter)."""
        with self._lock:
            snaps, self._snaps = self._snaps, []
            return snaps

    # -- telemetry -----------------------------------------------------------

    def stats(self) -> dict[str, float]:
        with self._lock:
            held = len(self._snaps)
            held_bytes = sum(int(s.nbytes) for s in self._snaps)
            return {
                "policy_" + self.policy: 1.0,
                "watermark": float(self.watermark),
                "hbm_bytes": float(self.hbm_bytes()),
                "bytes_per_slot": float(self.bytes_per_slot),
                "preempted_held": float(held),
                "preempted_held_bytes": float(held_bytes),
                "preempted_total": float(self.preempted_total),
                "restored_total": float(self.restored_total),
                "shed_total": float(self.shed_total),
                "offload_bytes_total": float(self.offload_bytes_total),
                "offload_seconds_total": self.offload_seconds_total,
                "restore_seconds_total": self.restore_seconds_total,
            }
