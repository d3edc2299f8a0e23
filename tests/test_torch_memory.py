"""The port's KV memory layer against the JAX package's.

  - `KVPool`, `pytree_nbytes`, `bucket_len` and the scheduler's
    `drain_estimate_s` (`llm_mcp_tpu_torch/executor/memory.py`,
    `scheduler.py`) give the reference's results on the same seeded
    inputs: victim order under all four policies, restore order,
    `requeue`, `discard`, `drain`, the thrash guards, the counters and the
    `stats()` keys;
  - preempt -> host offload -> restore on the port's engine, driven by
    hand (`_step`, so the cycle is the same on every run): greedy tokens
    identical to the uncontended run on the same engine and the texts equal
    to the JAX engine's under the same contention (its Pallas bodies in
    interpret mode), for `tiny-llm` f32, `tiny-llm` int8 (the fused cache,
    compacted rounds), `tiny-mla` and `tiny-mla` int8 latents, at pipeline
    depth 1 and 2; every cache, pool and round-state buffer keeps its
    storage (`data_ptr`) across the cycle;
  - victims admitted off a prefix hit: physical and block-aligned (a
    private-only snapshot, the shared blocks parked in the ledger),
    physical and unaligned (a whole snapshot), and a contiguous entry
    (private-only, the entry's rows written back), ledger leak-free
    afterwards; a snapshot whose range overlaps shared blocks reads them
    from the prefix pool;
  - `TPU_KV_HOST_OFFLOAD` unset is a no-op; shedding at watermark 1.0; a
    threaded soak (no deadlock, no slot object installed twice);
  - the HBM-ratio keys of `paging_stats()` equal the JAX engine's;
  - the chat API: 429 with Retry-After and the shed counted, and the
    body's `priority` parsed and passed to the engine.
"""

from __future__ import annotations

import contextlib
import json
import queue
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_mcp_tpu.executor import memory as jmem
from llm_mcp_tpu.executor.scheduler import TokenBudgetScheduler as JaxScheduler
from llm_mcp_tpu_torch.api.inference import serve
from llm_mcp_tpu_torch.executor import GenerationEngine, GenRequest
from llm_mcp_tpu_torch.executor import memory as tmem
from llm_mcp_tpu_torch.executor.scheduler import TokenBudgetScheduler
from llm_mcp_tpu_torch.models.configs import get_config
from llm_mcp_tpu_torch.models.weights import params_from_numpy

# -- the pool, against the reference ------------------------------------------


def test_constants_and_policies_match_jax():
    assert tmem.POLICIES == jmem.POLICIES
    assert tmem.PREEMPT_MIN_INTERVAL_S == jmem.PREEMPT_MIN_INTERVAL_S
    assert tmem.RESTORE_AGING_TTFT_MULT == jmem.RESTORE_AGING_TTFT_MULT
    for mod in (tmem, jmem):
        with pytest.raises(ValueError):
            mod.KVPool(max_slots=2, max_seq_len=64, bytes_per_slot=1, policy="lru")


def test_pytree_nbytes_and_bucket_len_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(20):
        a = np.zeros(tuple(rng.integers(1, 6, size=3)), np.float32)
        q = np.zeros(tuple(rng.integers(1, 9, size=2)), np.int8)
        s = np.zeros(tuple(rng.integers(1, 4, size=1)), np.float16)
        tree = {"k": {"q": q, "s": s}, "v": [a, (a,)], "none": None, "empty": {}}
        want = jmem.pytree_nbytes(tree)
        assert tmem.pytree_nbytes(tree) == want
        # the same tree as torch tensors counts the same bytes
        tt = {"k": {"q": torch.from_numpy(q), "s": torch.from_numpy(s)},
              "v": [torch.from_numpy(a), (torch.from_numpy(a),)], "none": None, "empty": {}}
        assert tmem.pytree_nbytes(tt) == want
    for S in (1, 64, 100, 4096):
        for n in range(0, 2 * S + 3):
            assert tmem.bucket_len(n, S) == jmem.bucket_len(n, S)


def _cands(rng, n, surplus):
    out = []
    for i in range(n):
        c = {"slot": i, "priority": int(rng.integers(0, 3)),
             "last_activity": float(rng.integers(0, 4)),
             "tokens_remaining": int(rng.integers(0, 5))}
        if surplus:
            c["slo_surplus"] = float(rng.integers(0, 3)) / 2
        out.append(c)
    return out


@pytest.mark.parametrize("policy", ["priority", "idle", "tokens", "slo_debt"])
def test_pick_victim_matches_jax(policy):
    """Seeded candidate lists full of ties, with and without the
    `slo_surplus` key: the same victim under every policy."""
    rng = np.random.default_rng(1)
    kw = dict(max_slots=8, max_seq_len=64, bytes_per_slot=1, policy=policy)
    t, j = tmem.KVPool(**kw), jmem.KVPool(**kw)
    assert t.pick_victim([]) is None and j.pick_victim([]) is None
    for trial in range(200):
        cands = _cands(rng, int(rng.integers(1, 8)), surplus=trial % 2 == 1)
        assert t.pick_victim(cands) is j.pick_victim(cands)


def _pair_snaps(rng, n):
    """The same snapshots for both pools: (port, JAX) pairs."""
    out = []
    for i in range(n):
        kw = dict(req_id=f"r{i}", priority=int(rng.integers(0, 3)), length=4, bucket=4,
                  last_tok=1, temperature=0.0, top_k=0, top_p=1.0, k_rows=None, v_rows=None,
                  nbytes=int(rng.integers(0, 100)), preempted_at=float(rng.integers(0, 5)))
        out.append((tmem.KVSnapshot(**kw), jmem.KVSnapshot(**kw)))
    return out


def test_restore_order_counters_and_stats_match_jax():
    """One seeded sequence of offload, peek, pop, requeue, discard,
    note_restored, note_shed and drain on both pools: the same snapshot at
    every step and equal `stats()` (keys and values) after each."""
    rng = np.random.default_rng(2)
    kw = dict(max_slots=6, max_seq_len=64, bytes_per_slot=1000, watermark=1.25)
    t, j = tmem.KVPool(**kw), jmem.KVPool(**kw)
    pairs = _pair_snaps(rng, 40)
    index = {id(a): k for k, (a, _) in enumerate(pairs)}
    jindex = {id(b): k for k, (_, b) in enumerate(pairs)}
    popped: list[int] = []
    nxt = 0
    for step in range(300):
        op = int(rng.integers(0, 7))
        if op == 0 and nxt < len(pairs):
            sec = float(rng.uniform(0, 0.2))
            t.offload(pairs[nxt][0], seconds=sec)
            j.offload(pairs[nxt][1], seconds=sec)
            nxt += 1
        elif op == 1:
            a, b = t.peek_restore(), j.peek_restore()
            assert (a is None and b is None) or index[id(a)] == jindex[id(b)]
        elif op == 2:
            a, b = t.pop_restore(), j.pop_restore()
            assert (a is None and b is None) or index[id(a)] == jindex[id(b)]
            if a is not None:
                popped.append(index[id(a)])
        elif op == 3 and popped:
            k = popped.pop(int(rng.integers(0, len(popped))))
            if rng.integers(0, 2):
                t.requeue(pairs[k][0])
                j.requeue(pairs[k][1])
            else:
                sec = float(rng.uniform(0, 0.2))
                t.note_restored(pairs[k][0], seconds=sec)
                j.note_restored(pairs[k][1], seconds=sec)
        elif op == 4 and nxt:
            k = int(rng.integers(0, nxt))  # may be absent already: a no-op
            t.discard(pairs[k][0])
            j.discard(pairs[k][1])
        elif op == 5:
            n = int(rng.integers(1, 3))
            t.note_shed(n)
            j.note_shed(n)
        elif op == 6 and step % 50 == 49:
            a, b = t.drain(), j.drain()
            assert [index[id(x)] for x in a] == [jindex[id(x)] for x in b]
        assert t.preempted_count() == j.preempted_count()
        assert t.has_preempted() == j.has_preempted()
        assert t.stats() == j.stats()
    assert t.preempted_total > 0 and t.restored_total > 0 and t.shed_total > 0


def test_thrash_guards_and_watermark_match_jax():
    """`may_preempt` (the host-memory bound and the rate limit), `admit_ok`
    and `headroom` across offered loads and watermarks, the clamp of a
    watermark below 1 included."""
    for max_pre in (None, 1, 3):
        kw = dict(max_slots=4, max_seq_len=64, bytes_per_slot=1, max_preempted=max_pre)
        t, j = tmem.KVPool(**kw), jmem.KVPool(**kw)
        pairs = _pair_snaps(np.random.default_rng(3), 6)
        for k, (a, b) in enumerate(pairs):
            at = 100.0 + 0.4 * k
            a.preempted_at = b.preempted_at = at
            for now in (at - 0.5, at, at + 0.5, at + 1.0, at + 3.0):
                assert t.may_preempt(now=now) == j.may_preempt(now=now)
            t.offload(a)
            j.offload(b)
            if k % 2:
                t.pop_restore()
                j.pop_restore()
    for wm in (0.25, 1.0, 1.5, 2.0):
        kw = dict(max_slots=4, max_seq_len=64, bytes_per_slot=1000, watermark=wm)
        t, j = tmem.KVPool(**kw), jmem.KVPool(**kw)
        assert t.hbm_bytes() == j.hbm_bytes()
        for offered in np.linspace(0.0, 10.0, 41):
            assert t.admit_ok(offered) == j.admit_ok(offered)
            assert t.headroom(offered) == j.headroom(offered)


def test_drain_estimate_matches_jax():
    rng = np.random.default_rng(4)
    t, j = TokenBudgetScheduler(), JaxScheduler()
    for _ in range(60):
        dt = float(rng.uniform(0.001, 0.2))
        t.observe_decode(dt)
        j.observe_decode(dt)
        args = (int(rng.integers(0, 50)), float(rng.uniform(0, 500)), int(rng.integers(1, 9)),
                int(rng.integers(1, 17)))
        assert t.drain_estimate_s(*args) == j.drain_estimate_s(*args)


# -- the engine: preempt -> offload -> restore --------------------------------

# short prompts: every low stream is admitted in the first step
LOW_PROMPTS = ["low stream zero, the victim", "low stream one", "low stream two is here",
               "low three", "low stream four", "low five", "low stream six", "seven"]
HI_PROMPT = "urgent request"
SHARED = "system: You are a careful assistant. Answer in one short line, please. user: "


def _params(model: str, quant: bool):
    """One JAX tree (f32, or int8 with f32 scales) and its port copy."""
    from llm_mcp_tpu.models.configs import get_config as jax_get_config
    from llm_mcp_tpu.models.llama import init_llama_params
    from llm_mcp_tpu.models.quant import init_llama_params_quantized

    if quant:
        jparams = init_llama_params_quantized(jax_get_config(model), jax.random.PRNGKey(0),
                                              scale_dtype=jnp.float32)
    else:
        jparams = init_llama_params(jax_get_config(model), jax.random.PRNGKey(0),
                                    dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), get_config(model), "cpu",
                                torch.float32)
    return jparams, tparams


def _jax_env(monkeypatch, depth: int) -> None:
    monkeypatch.setenv("TPU_KV_HOST_OFFLOAD", "1")
    monkeypatch.setenv("LLM_MCP_TPU_ATTN", "pallas")
    monkeypatch.setenv("LLM_MCP_TPU_RAGGED_IMPL", "kernel")
    monkeypatch.setenv("TPU_PIPELINE_DEPTH", str(depth))


def _buffers(eng) -> dict[str, int]:
    """Storage address of every buffer a captured round reads."""
    out = {}
    for name in ("_ck", "_cv", "_pool_k", "_pool_v"):
        t = getattr(eng, name)
        if t is None:
            continue
        for k, x in (t.items() if isinstance(t, dict) else [("", t)]):
            out[f"{name}{k}"] = x.data_ptr()
    for name in ("_d_last", "_d_temp", "_d_topk", "_d_topp"):
        out[name] = getattr(eng, name).data_ptr()
    return out


def _hand_drive(eng, lows, hi=None, fill=None, limit=4000):
    """Drive the engine loop by hand (`_step`, as its thread would): submit
    `lows`, step until `fill` slots decode, then submit `hi` and step until
    every request ended. Returns each request's emitted token ids, its text
    and its final event, in submission order."""
    seen: dict[str, list[int]] = {}
    process = eng._process_token

    def rec(s, tok, pos):
        seen.setdefault(s.req.request_id, []).append(int(tok))
        return process(s, tok, pos)

    eng._process_token = rec
    reqs = list(lows)
    final: dict[str, dict] = {}
    texts: dict[str, str] = {}

    def collect():
        for r in reqs:
            while True:
                try:
                    evt = r.out.get_nowait()
                except queue.Empty:
                    break
                if not isinstance(evt, dict):
                    continue
                if evt["type"] == "token":
                    texts[r.request_id] = texts.get(r.request_id, "") + evt["text"]
                elif evt["type"] in ("done", "error"):
                    final[r.request_id] = evt
    try:
        with torch.inference_mode():
            for r in lows:
                eng.submit(r)
            if hi is not None:
                for _ in range(limit):
                    eng._step()
                    if sum(s is not None for s in eng._slots) >= fill:
                        break
                assert sum(s is not None for s in eng._slots) >= fill, "slots never filled"
                eng._step()  # a round or two in flight when hi arrives
                eng.submit(hi)
                reqs.append(hi)
            for _ in range(limit):
                collect()
                if len(final) == len(reqs):
                    break
                eng._step()
            eng._drain()
            collect()
    finally:
        eng._process_token = process
    assert len(final) == len(reqs), "requests did not finish"
    return ([seen.get(r.request_id, []) for r in reqs], [texts.get(r.request_id, "") for r in reqs],
            [final[r.request_id] for r in reqs])


def _jax_requests(jeng, cases):
    from llm_mcp_tpu.executor.engine import GenRequest as JaxRequest

    return [JaxRequest(prompt_ids=jeng.tokenizer.encode(p), max_tokens=n, temperature=0.0,
                       priority=pri) for p, n, pri in cases]


def _jax_texts(reqs):
    texts = []
    for r in reqs:
        parts = []
        while True:
            evt = r.out.get(timeout=300)
            if not isinstance(evt, dict) or evt["type"] in ("done", "error"):
                break
            parts.append(evt["text"])
        texts.append("".join(parts))
    return texts


@contextlib.contextmanager
def _admission_held(jeng):
    """A running JAX loop parks at its next admission until the block
    ends: requests submitted inside the block are admitted by one call,
    as if they had been queued before the loop started."""
    gate, parked = threading.Event(), threading.Event()
    admit = jeng._admit_pending

    def held():
        parked.set()
        gate.wait(timeout=120)
        return admit()

    jeng._admit_pending = held
    try:
        assert parked.wait(timeout=120), "the JAX loop never reached its admission"
        yield
    finally:
        jeng._admit_pending = admit
        gate.set()


def _jax_contended(jeng, lows, hi, fill):
    """The same contention on the JAX engine, driven from its own loop
    (it has no step of its own to drive by hand). The low streams are
    queued where the loop cannot admit them one by one: before `start()`,
    or, on a running engine, while its admission is held. The loop thread
    itself submits the high-priority request, from the activation that
    fills `fill` slots, so the next iteration preempts whatever the
    thread's timing: no stream can finish before it arrives. Texts in
    submission order, and its `memory_stats()`."""
    reqs = _jax_requests(jeng, lows)
    (h,) = _jax_requests(jeng, [hi])
    sent: list = []
    activate = jeng._activate_state

    def activate_then_contend(*args, **kw):
        out = activate(*args, **kw)
        if not sent and sum(s is not None for s in jeng._slots) >= fill:
            sent.append(h)
            jeng.submit(h)
        return out

    jeng._activate_state = activate_then_contend
    try:
        if jeng._thread is None:
            for r in reqs:
                jeng.submit(r)
            jeng.start()
        else:
            with _admission_held(jeng):
                for r in reqs:
                    jeng.submit(r)
        texts = _jax_texts(reqs)
        assert sent, "slots never filled"
        texts += _jax_texts(sent)
    finally:
        jeng._activate_state = activate
    st = jeng.memory_stats()
    assert st["preempted_total"] >= 1 and st["restored_total"] >= 1
    return texts, st


def _jax_uncontended(jeng, lows):
    """The low streams alone on the JAX engine, queued before its loop
    starts: texts."""
    reqs = _jax_requests(jeng, lows)
    for r in reqs:
        jeng.submit(r)
    jeng.start()
    return _jax_texts(reqs)


LAYOUTS = {
    # name: (model, int8 weights, engine kwargs, slots filled)
    "llm-f32": ("tiny-llm", False, dict(max_slots=2), 2),
    # the fused int8 cache; 16 slots so that rounds run compacted once
    # half of the streams have ended
    "llm-int8": ("tiny-llm", True, dict(max_slots=16, quant="int8", kv_quant="int8",
                                        decode_compact="on", admit_batch=8), 16),
    "mla-f32": ("tiny-mla", False, dict(max_slots=2), 2),
    "mla-int8": ("tiny-mla", False, dict(max_slots=2, kv_quant="int8"), 2),
}


def _cases(fill: int):
    """(prompt, max_tokens, priority) of the low streams: stream 0, the
    longest, at priority 0 (the victim), the others at 1 and ending at
    different rounds; and the high-priority request."""
    lows = [(LOW_PROMPTS[i % len(LOW_PROMPTS)] + f" #{i}", 48 if i == 0 else 16 + 4 * (i % 5),
             0 if i == 0 else 1) for i in range(fill)]
    return lows, (HI_PROMPT, 6, 5)


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_preempt_restore_token_identical(monkeypatch, layout, depth):
    """The acceptance bar: the victim goes to the host and comes back, and
    every stream's greedy tokens equal the uncontended run's on the same
    engine and its text the JAX engine's under the same contention.

    With an int8 cache both engines run with `TPU_SPEC=0`. A verify round
    attends its own chunk's K/V exact, where later decode steps read those
    positions quantized, so with speculation on the greedy texts depend
    on where the verify rounds fall: on the schedule and the pipeline
    depth, and they differ between a contended and an uncontended run.
    With speculation off every stream equals the JAX engine's text (f32
    keeps speculation on: there a verify round and the decode steps it
    replaces agree)."""
    _jax_env(monkeypatch, depth)
    from llm_mcp_tpu.executor.engine import GenerationEngine as JaxEngine

    model, quant, kw, fill = LAYOUTS[layout]
    if kw.get("kv_quant"):
        monkeypatch.setenv("TPU_SPEC", "0")
    kw = dict(kw, max_seq_len=128, decode_chunk=4, prefill_chunk=32, prompt_cache_mb=0)
    lows, hi = _cases(fill)
    jparams, tparams = _params(model, quant)
    jeng = JaxEngine(model, params=jparams, dtype=jnp.float32, **kw)
    try:
        want, jstats = _jax_contended(jeng, lows, hi, fill)
    finally:
        jeng.shutdown()

    eng = GenerationEngine(model, params=tparams, dtype=torch.float32, device="cpu", **kw)
    assert eng.pipeline_depth == depth and eng._pool is not None
    ptrs = _buffers(eng)
    restored_at: list[int] = []
    restore = eng._restore_snapshot

    def spy(b, snap):
        restored_at.append(eng.compact_rounds)
        return restore(b, snap)

    eng._restore_snapshot = spy

    def mk():
        return [GenRequest(prompt_ids=eng.tokenizer.encode(p), max_tokens=n, temperature=0.0,
                           priority=pri) for p, n, pri in lows]

    hi_req = GenRequest(prompt_ids=eng.tokenizer.encode(hi[0]), max_tokens=hi[1],
                        temperature=0.0, priority=hi[2])
    toks, texts, finals = _hand_drive(eng, mk(), hi_req, fill)
    st = eng.memory_stats()
    assert set(st) == set(jstats)  # the JAX engine's key set
    assert st["preempted_total"] >= 1 and st["restored_total"] >= 1
    assert st["preempted_held"] == 0.0
    assert st["offload_bytes_total"] > 0
    assert all(f["type"] == "done" for f in finals)
    ref, ref_texts, _ = _hand_drive(eng, mk())  # uncontended: no high-priority arrival
    assert eng.memory_stats()["preempted_total"] == st["preempted_total"]
    assert toks[:-1] == ref
    assert texts == want and ref_texts == want[:-1]
    assert _buffers(eng) == ptrs  # every write went into the same storage
    assert eng.total_errors == 0 and eng.kv_scale_audit() == 0
    pg = eng.paging_stats()
    assert pg["leaks"] == 0 and pg["slot_tables"] == 0 and pg["snap_parked"] == 0
    if layout == "llm-int8":  # the restored stream went on in compacted rounds
        assert restored_at and eng.compact_rounds > restored_at[0]
    eng.shutdown()


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("case", ["aligned", "unaligned", "contiguous"])
def test_prefix_hit_victim_snapshot(monkeypatch, case, depth):
    """A victim admitted off a prefix hit. Physical, block-aligned (a
    64-token entry, 32-token blocks): the snapshot holds only the private
    rows [64, L), the shared blocks stay parked in the ledger and are
    re-pinned at restore. Physical, unaligned (a 32-token entry, 64-token
    blocks, its boundary block copied on write): the snapshot is whole.
    Contiguous entries (`TPU_PAGED_PHYSICAL=0`): private rows only, the
    entry's own rows written back at restore. Tokens as uncontended and
    texts as the JAX engine's, the ledger leak-free."""
    _jax_env(monkeypatch, depth)
    aligned = case != "unaligned"
    monkeypatch.setenv("TPU_KV_BLOCK_TOKENS", "32" if aligned else "64")
    monkeypatch.setenv("TPU_PAGED_PHYSICAL", "0" if case == "contiguous" else "1")
    from llm_mcp_tpu.executor.engine import GenerationEngine as JaxEngine

    shared = SHARED if aligned else SHARED[:40]
    kw = dict(max_slots=2, max_seq_len=256, decode_chunk=4, prefill_chunk=32, prompt_cache_mb=1)
    prime = [shared + "prime one", shared + "prime two"]
    lows = [(shared + "preempt identity probe", 40, 0), (shared + "second stream", 12, 1)]
    hi = (HI_PROMPT, 6, 5)
    jparams, tparams = _params("tiny-llm", False)
    jeng = JaxEngine("tiny-llm", params=jparams, dtype=jnp.float32, **kw).start()
    try:
        for p in prime:
            jeng.generate(p, max_tokens=4, temperature=0.0)
        want, _ = _jax_contended(jeng, lows, hi, 2)
    finally:
        jeng.shutdown()

    eng = GenerationEngine("tiny-llm", params=tparams, dtype=torch.float32, device="cpu", **kw)
    assert eng.paging_stats()["physical"] == (0.0 if case == "contiguous" else 1.0)
    snaps = []
    offload = eng._pool.offload

    def rec(snap, seconds=0.0):
        snaps.append((snap.shared_len, snap.length, snap.k_rows.shape[3]))
        offload(snap, seconds)

    eng._pool.offload = rec
    _hand_drive(eng, [GenRequest(prompt_ids=eng.tokenizer.encode(p), max_tokens=4,
                                 temperature=0.0) for p in prime])
    assert eng.prefix_cache_stats()["entries"] >= 1

    def mk():
        return [GenRequest(prompt_ids=eng.tokenizer.encode(p), max_tokens=n, temperature=0.0,
                           priority=pri) for p, n, pri in lows]

    hits0 = eng.prefix_cache_hits
    hi_req = GenRequest(prompt_ids=eng.tokenizer.encode(hi[0]), max_tokens=hi[1],
                        temperature=0.0, priority=hi[2])
    toks, texts, _ = _hand_drive(eng, mk(), hi_req, 2)
    assert eng.prefix_cache_hits - hits0 == 2
    assert snaps, "no snapshot was taken"
    for shared_len, length, rows in snaps:
        if aligned:
            assert shared_len == 64 and rows == length - 64  # private rows only
        else:
            assert shared_len == 0 and rows == length  # whole
    st = eng.memory_stats()
    assert st["restored_total"] == st["preempted_total"] >= 1
    ref, _, _ = _hand_drive(eng, mk())
    assert toks[:-1] == ref
    assert texts == want
    pg = eng.paging_stats()
    assert pg["leaks"] == 0 and pg["slot_tables"] == 0 and pg["snap_parked"] == 0
    if case != "contiguous":
        assert pg["physical_missing_pins"] == 0
    if not aligned:
        assert pg["physical_cow_copies_total"] >= 2
    assert eng.total_errors == 0
    eng.shutdown()


def test_snapshot_over_shared_blocks_reads_the_pool(monkeypatch):
    """A slot admitted off a pinned (pool-resident) prefix: the table maps
    its blocks [0, 64) to the pool, so its arena rows there are stale
    (overwritten with junk below). A snapshot from row 0 reads those blocks
    from the pool through the table, and its rows past the prefix equal the
    private-only snapshot's."""
    monkeypatch.setenv("TPU_KV_BLOCK_TOKENS", "32")
    eng = GenerationEngine("tiny-llm", dtype=torch.float32, device="cpu", max_slots=2,
                           max_seq_len=256, decode_chunk=4, prefill_chunk=32, prompt_cache_mb=1)
    _hand_drive(eng, [GenRequest(prompt_ids=eng.tokenizer.encode(SHARED + p), max_tokens=2,
                                 temperature=0.0) for p in ("one", "two")])
    req = GenRequest(prompt_ids=eng.tokenizer.encode(SHARED + "the hit"), max_tokens=64,
                     temperature=0.0)
    eng.submit(req)
    with torch.inference_mode():
        for _ in range(50):
            eng._step()
            b = next((i for i, s in enumerate(eng._slots) if s is not None), None)
            if b is not None:
                break
        eng._drain()
        s = eng._slots[b]
        assert s.shared_len == 64 and eng._phys.paged([b])
        eng._ck[:, b, :, :64] = 7.0
        L = int(eng._lengths[b])
        whole_k, _ = eng._snapshot_rows(b, L, start=0)
        priv_k, _ = eng._snapshot_rows(b, L, start=64)
        assert whole_k.shape[3] == L and priv_k.shape[3] == L - 64
        assert torch.equal(whole_k[:, :, :, 64:], priv_k)
        srcs = eng._phys.row_sources(b, 2)
        assert [in_arena for in_arena, _, _ in srcs] == [False, False]
        for i, (_, row, _) in enumerate(srcs):
            assert torch.equal(whole_k[:, :, :, 32 * i: 32 * (i + 1)],
                               eng._pool_k[:, row: row + 1])
        assert (whole_k[:, :, :, :64] != 7.0).any()
    eng.shutdown()


def test_offload_disabled_is_noop(monkeypatch):
    """TPU_KV_HOST_OFFLOAD unset (and "0"): no pool, inert surfaces, the
    pool-less path serves, no slot records a preemption signal."""
    for value in (None, "0"):
        if value is None:
            monkeypatch.delenv("TPU_KV_HOST_OFFLOAD", raising=False)
        else:
            monkeypatch.setenv("TPU_KV_HOST_OFFLOAD", value)
        eng = GenerationEngine("tiny-llm", dtype=torch.float32, device="cpu", max_slots=2,
                               max_seq_len=64, decode_chunk=4).start()
        try:
            assert eng._pool is None
            assert eng.memory_stats() == {"enabled": 0.0}
            assert eng.admission_state() == (False, 0.0)
            eng.note_shed()
            assert eng._pool is None
            out = eng.generate("noop check", max_tokens=6, temperature=0.0, priority=3)
            assert out["usage"]["completion_tokens"] >= 1
            assert eng.finished_requests == 1 and eng.total_errors == 0
        finally:
            eng.shutdown()


def _pooled(monkeypatch, **kw):
    monkeypatch.setenv("TPU_KV_HOST_OFFLOAD", "1")
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_seq_len", 128)
    kw.setdefault("decode_chunk", 4)
    return GenerationEngine("tiny-llm", dtype=torch.float32, device="cpu", **kw)


def test_admission_sheds_at_watermark(monkeypatch):
    """Watermark 1.0, one slot: idle admits; with the slot held (the loop
    stepped by hand, so the state is fixed) the engine sheds with a retry
    in [1, 600] s, side-effect free until `note_shed`, which moves
    `shed_total` by one. The drain estimate is the scheduler's."""
    monkeypatch.setenv("TPU_ADMIT_WATERMARK", "1.0")
    eng = _pooled(monkeypatch, max_slots=1)
    assert eng.admission_state() == (False, 0.0)
    eng.submit(GenRequest(prompt_ids=eng.tokenizer.encode("hold the only slot"),
                          max_tokens=200, temperature=0.0))
    with torch.inference_mode():
        eng._step()
    assert eng._slots[0] is not None
    st = eng.memory_stats()
    assert st["watermark"] == 1.0 and st["offered"] >= 1.0 and st["headroom"] == 0.0
    shed, retry = eng.admission_state()
    assert shed and 1.0 <= retry <= 600.0
    want = eng._sched.drain_estimate_s(1, 64.0, eng.decode_chunk, eng.max_slots)
    assert retry == min(600.0, max(1.0, want))
    assert eng.memory_stats()["shed_total"] == 0.0
    eng.note_shed()
    assert eng.memory_stats()["shed_total"] == 1.0
    eng.shutdown()  # errors the held request
    assert eng.total_errors == 1


def test_soak_no_deadlock_no_double_assignment(monkeypatch):
    """Clients at mixed priorities race admission, preemption and finish
    on two slots: every request completes, no slot object is ever in two
    slots, none is both offloaded and live, and at quiesce nothing is held
    and the ledger is clean."""
    eng = _pooled(monkeypatch, max_seq_len=64).start()
    stop = threading.Event()
    violations: list[str] = []

    def watch():
        while not stop.is_set():
            ids = [id(s) for s in list(eng._slots) if s is not None]
            if len(ids) != len(set(ids)):
                violations.append("slot object installed in two slots")
            with eng._pool._lock:
                held = [id(s.slot_obj) for s in eng._pool._snaps]
            if set(held) & set(ids):
                violations.append("offloaded slot object also active")
            time.sleep(0.001)

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    results: list[dict] = []
    lock = threading.Lock()

    def client(i):
        for r in range(2):
            out = eng.generate(f"soak client {i} round {r}", max_tokens=10 + (i * 7 + r) % 30,
                               temperature=0.0, priority=i % 3)
            with lock:
                results.append(out)

    threads = [threading.Thread(target=client, args=(i,), daemon=True) for i in range(6)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        stop.set()
        watcher.join(timeout=10)
    assert not any(t.is_alive() for t in threads), "soak deadlocked"
    assert len(results) == 12
    assert all(r["usage"]["completion_tokens"] >= 1 for r in results)
    assert violations == []
    assert eng.slots_in_use() == 0
    assert eng.memory_stats()["preempted_held"] == 0.0
    assert eng.paging_stats()["leaks"] == 0 and eng.total_errors == 0
    assert eng.finished_requests == 12
    eng.shutdown()


def test_hbm_ratio_keys_match_jax(monkeypatch):
    """The prefix sequence one request at a time through physical paging
    (64-token blocks): the three HBM-ratio keys of `paging_stats()` equal
    the JAX engine's."""
    monkeypatch.setenv("LLM_MCP_TPU_ATTN", "pallas")
    monkeypatch.setenv("LLM_MCP_TPU_RAGGED_IMPL", "kernel")
    monkeypatch.setenv("TPU_KV_BLOCK_TOKENS", "64")
    from llm_mcp_tpu.executor.engine import GenerationEngine as JaxEngine

    sys1 = "system: You are a careful assistant. Answer in one short line, and never guess.\n"
    prompts = [sys1 + "user: what is 2+2?", sys1 + "user: name a color",
               sys1 + "user: spell cat", "sys: terse\nuser: hi", "sys: terse\nuser: yo",
               "sys: terse\nuser: ok then"]
    keys = ("hbm_bytes_contiguous_equiv_peak", "hbm_bytes_physical_peak", "hbm_bytes_ratio_peak")
    jparams, tparams = _params("tiny-llm", False)
    kw = dict(max_slots=4, max_seq_len=256, prefill_chunk=32, decode_chunk=4, prompt_cache_mb=1)
    got = []
    for eng in (JaxEngine("tiny-llm", params=jparams, dtype=jnp.float32, **kw),
                GenerationEngine("tiny-llm", params=tparams, dtype=torch.float32, device="cpu",
                                 **kw)):
        eng.start()
        try:
            for p in prompts:
                eng.generate(p, max_tokens=4, temperature=0.0)
            pg = eng.paging_stats()
        finally:
            eng.shutdown()
        got.append({k: pg[k] for k in keys})
    assert got[0]["hbm_bytes_ratio_peak"] > 1.0
    assert got[1] == got[0]


# -- the chat API --------------------------------------------------------------


class _GateEngine:
    """A stand-in engine: fixed admission answer, records what the API
    passes it."""

    device = "cpu"

    def __init__(self, shed=False, retry=0.0):
        self.gate = (shed, retry)
        self.calls: list[dict] = []
        self.shed = 0

    def admission_state(self):
        return self.gate

    def note_shed(self, n=1):
        self.shed += n

    def generate(self, prompt, **kw):
        self.calls.append(kw)
        return {"text": "ok", "finish_reason": "stop",
                "usage": {"prompt_tokens": 1, "completion_tokens": 1, "total_tokens": 2}}

    def generate_stream(self, prompt, **kw):
        self.calls.append(kw)
        yield {"type": "done", "finish_reason": "stop", "usage": {}}


def _chat(port: int, body: dict):
    """(status, headers, body) of one chat request."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/chat/completions",
        data=json.dumps(dict(body, messages=[{"role": "user", "content": "hi"}])).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read().decode()


@pytest.mark.parametrize("stream", [False, True])
def test_chat_priority_reaches_engine(stream):
    """`priority` as an integer (or a numeric string) reaches the engine; a
    malformed or absent one reads 0, as the reference parses it."""
    eng = _GateEngine()
    api = serve({"m": eng})
    try:
        for raw, want in ((7, 7), ("3", 3), ("high", 0), (None, 0), ([1], 0)):
            body = {"model": "m", "stream": stream}
            if raw is not None:
                body["priority"] = raw
            status, _, _ = _chat(api.port, body)
            assert status == 200
            assert eng.calls[-1]["priority"] == want
    finally:
        api.shutdown()


def test_chat_sheds_with_retry_after(monkeypatch):
    """An engine at its watermark: the chat answers 429 with Retry-After
    (the drain estimate rounded, at least 1) and the reference's message,
    counts the shed, and never reaches generation. A stand-in gives the
    rounding; a real engine (watermark 1.0, its one slot held) the count."""
    eng = _GateEngine(shed=True, retry=2.4)
    api = serve({"m": eng})
    try:
        status, headers, body = _chat(api.port, {"model": "m"})
        assert status == 429 and headers["Retry-After"] == "2"
        assert "admission watermark" in json.loads(body)["error"]["message"]
        assert eng.shed == 1 and eng.calls == []
        eng.gate = (True, 0.2)
        assert _chat(api.port, {"model": "m", "stream": True})[1]["Retry-After"] == "1"
    finally:
        api.shutdown()

    monkeypatch.setenv("TPU_ADMIT_WATERMARK", "1.0")
    real = _pooled(monkeypatch, max_slots=1)
    real.submit(GenRequest(prompt_ids=real.tokenizer.encode("hold"), max_tokens=200,
                           temperature=0.0))
    with torch.inference_mode():
        real._step()  # the slot is held: the loop is not running
    api = serve({"tiny-llm": real})
    try:
        before = real.memory_stats()["shed_total"]
        status, headers, _ = _chat(api.port, {"model": "tiny-llm"})
        assert status == 429 and 1 <= int(headers["Retry-After"]) <= 600
        assert real.memory_stats()["shed_total"] == before + 1
        with urllib.request.urlopen(f"http://127.0.0.1:{api.port}/health", timeout=60) as r:
            health = json.loads(r.read())
        mem = health["engines"]["tiny-llm"]["memory"]
        assert mem["enabled"] == 1.0 and mem["shed_total"] == before + 1
    finally:
        api.shutdown()
        real.shutdown()
