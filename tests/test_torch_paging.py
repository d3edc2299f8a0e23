"""The port's block ledger and physical pool against the JAX package's.

Both sides are host code: `llm_mcp_tpu.executor.paging.PagedKVManager` and
`physical.PhysicalPool` on one side, the port's copies on the other. One
seeded random sequence of admissions (fresh and shared), extensions, prefix
registrations and releases, preemptions, restores and frees drives both;
every returned op list, every `table_view`, `stats()` and `audit()` must be
identical after every call, and so must the pools' tables, row mappings
and `row_sources`. Replaying the op streams into mirror managers
(`apply_ops`) must give the same tables on both sides too.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llm_mcp_tpu.executor import paging as JP
from llm_mcp_tpu.executor import physical as JPh
from llm_mcp_tpu_torch.executor import paging as TP
from llm_mcp_tpu_torch.executor import physical as TPh
from llm_mcp_tpu_torch.utils.locks import LockOrderError, OrderedLock

N_SLOTS = 4
# the calls whose returned op stream the mirrors replay
MUTATORS = {"admit_slot", "admit_shared", "ensure_slot", "extend_many", "free_slot",
            "prefix_register", "prefix_release", "preempt_slot", "restore_slot", "drop_snap"}


class _Pair:
    """The JAX and port ledgers (plus mirrors and pools), called alike."""

    def __init__(self, seq_len: int, bt: int, budget_blocks: int):
        kw = dict(
            max_slots=N_SLOTS, max_seq_len=seq_len, block_tokens=bt,
            bytes_per_token=16, prefix_budget_bytes=16 * bt * budget_blocks,
        )
        self.mgr = (JP.PagedKVManager(**kw), TP.PagedKVManager(**kw))
        self.mirror = (JP.PagedKVManager(**kw), TP.PagedKVManager(**kw))
        pk = dict(n_slots=N_SLOTS, seq_len=seq_len, block_tokens=bt,
                  pool_rows=self.mgr[0].prefix_partition)
        self.pool = (JPh.PhysicalPool(**pk), TPh.PhysicalPool(**pk))

    def call(self, name: str, *args):
        outs = [getattr(m, name)(*args) for m in self.mgr]
        assert outs[0] == outs[1], (name, args, outs)
        if name in MUTATORS and outs[0]:  # an op stream: replay into the mirrors
            for m, ops in zip(self.mirror, outs):
                m.apply_ops(ops)
        return outs[0]

    def pools(self, name: str, *args):
        outs = [getattr(p, name)(*args) for p in self.pool]
        assert outs[0] == outs[1], (name, args, outs)
        return outs[0]

    def check(self):
        j, t = self.mgr
        assert j.stats() == t.stats()
        assert j.audit() == t.audit()
        assert j.leak_count() == t.leak_count()
        for slot in range(N_SLOTS):
            view = j.table_view(slot)
            assert view == t.table_view(slot)
            assert self.mirror[0].table_view(slot) == self.mirror[1].table_view(slot)
            assert self.mirror[1].table_view(slot)[0] == view[0]
        jp, tp = self.pool
        np.testing.assert_array_equal(jp.table, tp.table)
        assert jp._phys == tp._phys and jp._free == tp._free
        jst, tst = jp.stats(), tp.stats()
        assert jst == {k: tst[k] for k in jst}
        for slot in range(N_SLOTS):
            assert jp.row_sources(slot, jp.nbs) == tp.row_sources(slot, tp.nbs)


def _sweep(pair: _Pair) -> None:
    """Reclaim the pool rows of dead ids after every call that may drop
    one, as the engine does (a row whose id died and was reused unswept
    would never come back)."""
    assert pair.pool[0].sweep(pair.mgr[0].alive) == pair.pool[1].sweep(pair.mgr[1].alive)


def _rebuild(pair: _Pair, slot: int) -> None:
    _sweep(pair)  # an admission frees a stale table first
    ids, sn = pair.mgr[1].table_view(slot)
    pair.pools("rebuild", slot, ids, sn)


def _release(pair: _Pair, slot: int) -> None:
    pair.pools("reset", slot)
    _sweep(pair)


@pytest.mark.parametrize("seed,bt", [(0, 32), (1, 64), (2, 32), (3, 128)])
def test_ledger_and_pool_match_jax_op_for_op(seed, bt):
    rng = np.random.default_rng(seed)
    S = 512
    pair = _Pair(S, bt, budget_blocks=24)
    keys: list[tuple] = []
    snaps: list[int] = []
    snap_ctr = 0
    for _ in range(300):
        slot = int(rng.integers(N_SLOTS))
        n = int(rng.integers(1, S))
        kind = rng.choice(
            ["admit", "shared", "ensure", "extend", "free", "register", "release",
             "preempt", "restore", "drop"],
            p=[0.14, 0.16, 0.1, 0.1, 0.14, 0.12, 0.08, 0.06, 0.05, 0.05],
        )
        if kind == "admit":
            pair.call("admit_slot", slot, n)
            _rebuild(pair, slot)
        elif kind == "shared":
            # a known entry (pins + copy-on-write) or a raced eviction
            key = keys[int(rng.integers(len(keys)))] if keys and rng.random() < 0.85 else ("gone",)
            ops = pair.call("admit_shared", slot, key, n)
            for op in ops:
                if op[0] == "cow":
                    assert pair.pools("phys_of", op[2]) is not None
            _rebuild(pair, slot)
        elif kind == "ensure":
            pair.call("ensure_slot", slot, n)
        elif kind == "extend":
            pair.call("extend_many", {slot: n, (slot + 1) % N_SLOTS: n // 2})
        elif kind == "free":
            pair.call("free_slot", slot)
            _release(pair, slot)
        elif kind == "register":
            key = tuple(int(x) for x in rng.integers(0, 50, 3))
            p0 = int(rng.integers(32, S // 2))
            fits = pair.call("prefix_can_fit", p0)
            ops = pair.call("prefix_register", key, p0)
            assert (ops is not None) == (fits or key in keys)
            if ops:
                ids = pair.call("prefix_ids", key)
                rows = pair.pools("register_prefix", ids)
                if rows is None:
                    pair.call("prefix_release", key)
                else:
                    keys.append(key)
        elif kind == "release" and keys:
            pair.call("prefix_release", keys.pop(int(rng.integers(len(keys)))))
            _sweep(pair)
        elif kind == "preempt":
            snap_ctr += 1
            if pair.call("preempt_slot", slot, snap_ctr):
                snaps.append(snap_ctr)
            _release(pair, slot)
        elif kind == "restore" and snaps:
            pair.call("restore_slot", slot, snaps.pop(0), n)
            _rebuild(pair, slot)
        elif kind == "drop" and snaps:
            pair.call("drop_snap", snaps.pop())
            _sweep(pair)
        pair.check()
    # quiesce: everything released leaves no table, no leak, no pool row
    for slot in range(N_SLOTS):
        pair.call("free_slot", slot)
        _release(pair, slot)
    for snap in snaps:
        pair.call("drop_snap", snap)
    for key in keys:
        pair.call("prefix_release", key)
    _sweep(pair)
    pair.check()
    st = pair.mgr[1].stats()
    assert st["slot_tables"] == 0 and st["blocks_used"] == 0
    assert pair.mgr[1].leak_count() == 0
    assert pair.pool[1].stats()["physical_pool_rows_used"] == 0


def test_device_table_uploads_only_after_a_change():
    jp = JPh.PhysicalPool(n_slots=2, seq_len=128, block_tokens=32, pool_rows=3)
    tp = TPh.PhysicalPool(n_slots=2, seq_len=128, block_tokens=32, pool_rows=3)
    for p in (jp, tp):
        rows = p.register_prefix([7, 8])
        p.rebuild(1, [7, 8, 40], 2)
        assert rows == [0, 1]
    first = tp.device_table("cpu")
    np.testing.assert_array_equal(first.numpy(), np.asarray(jp.device_table()))
    assert first.dtype == torch.int32 and tuple(first.shape) == (2, 4)
    assert tp.device_table("cpu") is first  # no mutation: no upload
    assert tp.paged([1]) and not tp.paged([0]) and not tp.paged([])
    tp.reset(1)
    assert tp.device_table("cpu") is not first and not tp.paged([0, 1])
    assert tp.stats()["physical_table_uploads_total"] == 2


def test_pool_like_matches_jax_shape():
    ck = torch.zeros((2, 3, 2, 128, 16), dtype=torch.bfloat16)
    want = JPh.pool_like(jnp.zeros((2, 3, 2, 128, 16), jnp.bfloat16), 5, 32)
    got = TPh.pool_like(ck, 5, 32)
    assert tuple(got.shape) == tuple(want.shape) == (2, 5, 2, 32, 16)
    assert got.dtype == ck.dtype and not got.any()


def test_pool_like_maps_the_fused_int8_cache_as_jax():
    fused = {"q": torch.zeros((2, 3, 5, 128, 16), dtype=torch.int8),
             "s": torch.zeros((2, 3, 4, 128), dtype=torch.bfloat16)}
    want = JPh.pool_like({"q": jnp.zeros((2, 3, 5, 128, 16), jnp.int8),
                          "s": jnp.zeros((2, 3, 4, 128), jnp.bfloat16)}, 5, 32)
    got = TPh.pool_like(fused, 5, 32)
    assert set(got) == set(want) == {"q", "s"}
    for k in ("q", "s"):
        assert tuple(got[k].shape) == tuple(want[k].shape) and got[k].dtype == fused[k].dtype
    assert tuple(got["q"].shape) == (2, 5, 5, 32, 16) and tuple(got["s"].shape) == (2, 5, 4, 32)
    assert TPh.pool_like({}, 5, 32) == JPh.pool_like({}, 5, 32) == {}


def test_block_tokens_from_env(monkeypatch):
    monkeypatch.setenv("TPU_KV_BLOCK_TOKENS", "32")
    assert TP.block_tokens_from_env() == JP.block_tokens_from_env() == 32
    monkeypatch.setenv("TPU_KV_BLOCK_TOKENS", "junk")
    assert TP.block_tokens_from_env() == JP.block_tokens_from_env() == 64


def test_ordered_lock_refuses_out_of_rank_order():
    lo, hi = OrderedLock("lo", 10), OrderedLock("hi", 20)
    with lo, hi:
        pass
    with hi:
        with pytest.raises(LockOrderError):
            lo.acquire()
    with lo:  # re-entry is refused the same way
        with pytest.raises(LockOrderError):
            lo.acquire()
