"""The port's decode dispatch on the CPU, against the JAX engine's.

  - greedy tokens at pipeline depth 1, 2 and 3 (`TPU_PIPELINE_DEPTH`, read
    at construction by both engines) equal to the JAX engine's at the same
    depth, on one shared converted parameter tree: `tiny-llm` in f32
    (sequential and concurrent, one prompt through ragged chunks), at
    int8 with compaction (concurrent, `max_slots=16`), a prefix sequence
    whose hits read through the pool (paged), and `tiny-v2` (MLA and MoE);
    the JAX engine runs its Pallas bodies in interpret mode;
  - the JAX engine's pipeline tests (`tests/test_engine.py`): rows that
    reach the context cap mid-pipeline finish with "length", at int8 with
    compaction and every slot churning too, and a chunked prompt's groups
    ride the decode rounds (fused) while another stream keeps emitting;
  - the cooling fence: a slot freed while a round that holds it is in
    flight is not admitted to again before that round's fetch;
  - the scheduler's `observe_fused` against JAX's;
  - the ragged group's cache-write targets as the engine builds them on
    the host, equal to the ones `torch.nonzero` finds, and the chunk's
    output and cache bit for bit the same with either.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_mcp_tpu_torch.executor import GenerationEngine, GenRequest
from llm_mcp_tpu_torch.models.configs import get_config
from llm_mcp_tpu_torch.models.weights import params_from_numpy

SYS1 = "system: You are a careful assistant. Answer in one short line, and never guess.\nuser: "
SYS2 = "sys: terse mode, no lists please\nuser: "
PREFIX_PROMPTS = [SYS1 + "what is 2+2?", SYS1 + "name a color", SYS1 + "spell cat",
                  SYS2 + "hi", SYS2 + "yo", SYS2 + "ok then"]
LONG = "user: " + "the quick brown fox jumps over the lazy dog " * 2  # > prefill_chunk
CHATS = [("user: hello there", 8), (LONG, 8), ("system: be brief\nuser: 2+2?", 8)]
PIPE_CASES = [(f"pipe {i} " * (1 + i % 4), 2 + i % 6) for i in range(7)] + [(LONG, 6)]


def _params(model: str, quant: bool):
    """One JAX tree (f32, or direct int8 with f32 scales) and its port copy."""
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


def _record_tokens(engine) -> dict:
    seen: dict = {}
    orig = engine._process_token

    def rec(s, tok, pos):
        seen.setdefault(s.req.request_id, []).append(int(tok))
        return orig(s, tok, pos)

    engine._process_token = rec
    return seen


def _wait(req) -> dict:
    while True:
        evt = req.out.get(timeout=300)
        if not isinstance(evt, dict) or evt.get("type") in ("done", "error"):
            assert isinstance(evt, dict) and evt["type"] == "done", evt
            return evt


def _drive(engine, make_req, cases, concurrent: bool) -> list[list[int]]:
    """Every (prompt, max_tokens) case, one at a time or all at once; the
    emitted token ids of each."""
    seen = _record_tokens(engine)
    reqs = [make_req(engine.tokenizer.encode(p), n) for p, n in cases]
    if concurrent:
        for r in reqs:
            engine.submit(r)
        for r in reqs:
            _wait(r)
    else:
        for r in reqs:
            engine.submit(r)
            _wait(r)
    return [seen[r.request_id] for r in reqs]


def _jax_env(monkeypatch, depth: int) -> None:
    monkeypatch.setenv("LLM_MCP_TPU_ATTN", "pallas")
    monkeypatch.setenv("LLM_MCP_TPU_RAGGED_IMPL", "kernel")
    monkeypatch.setenv("TPU_PIPELINE_DEPTH", str(depth))


def _both(model, quant, kw, runs):
    """Run `runs` (a list of (cases, concurrent)) on the JAX engine and on
    the port's, each built on the shared tree with `kw`; returns
    (jax tokens, port tokens, port engine stats)."""
    from llm_mcp_tpu.executor.engine import GenerationEngine as JaxEngine
    from llm_mcp_tpu.executor.engine import GenRequest as JaxRequest

    jparams, tparams = _params(model, quant)
    q8 = dict(quant="int8", kv_quant="int8") if quant else {}
    out = []
    for make, req in (
        (lambda: JaxEngine(model, params=jparams, dtype=jnp.float32, **q8, **kw), JaxRequest),
        (lambda: GenerationEngine(model, params=tparams, dtype=torch.float32, device="cpu",
                                  **q8, **kw), GenRequest),
    ):
        eng = make().start()
        try:
            toks = []
            for cases, conc in runs:
                toks += _drive(
                    eng, lambda ids, n, req=req: req(prompt_ids=ids, max_tokens=n, temperature=0.0),
                    cases, conc)
            stats = {"depth": eng.pipeline_depth, "hits": eng.prefix_cache_stats()["hits"],
                     "paging": eng.paging_stats(),
                     "compact": getattr(eng, "compact_rounds", None)}
        finally:
            eng.shutdown()
        out.append((toks, stats))
    (want, jstats), (got, tstats) = out
    assert jstats["depth"] == tstats["depth"]
    return want, got, tstats, jstats


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_depth_parity_llama(monkeypatch, depth):
    """f32 `tiny-llm`, prompt cache off: eight cases one at a time, then all
    at once (one through ragged chunks, slots churning over 4)."""
    _jax_env(monkeypatch, depth)
    kw = dict(max_slots=4, max_seq_len=128, decode_chunk=4, admit_batch=2, prefill_chunk=32,
              prompt_cache_mb=0, seed=5)
    want, got, tstats, _ = _both("tiny-llm", False, kw,
                                 [(PIPE_CASES, False), (PIPE_CASES, True)])
    assert tstats["depth"] == depth
    assert [len(t) for t in got] == [n for _, n in PIPE_CASES] * 2
    assert got[:len(PIPE_CASES)] == got[len(PIPE_CASES):]
    assert got == want


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_depth_parity_int8_compacted(monkeypatch, depth):
    """int8 weights and KV, `max_slots=16`: three concurrent chats run
    compacted rounds (Ba = 8) on both engines."""
    _jax_env(monkeypatch, depth)
    kw = dict(max_slots=16, max_seq_len=128, decode_chunk=4, prefill_chunk=32,
              prompt_cache_mb=0, decode_compact="on")
    want, got, tstats, _ = _both("tiny-llm", True, kw, [(CHATS, True)])
    assert tstats["compact"] > 0
    assert [len(t) for t in got] == [8, 8, 8]
    assert got == want


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_depth_parity_paged_prefix_hits(monkeypatch, depth):
    """The prefix sequence one request at a time, physical paging with
    64-token blocks: the second prompt stores a one-block entry that the
    third pins through the pool, and the sixth hits a 32-token entry
    copied on write."""
    _jax_env(monkeypatch, depth)
    monkeypatch.setenv("TPU_KV_BLOCK_TOKENS", "64")
    kw = dict(max_slots=4, max_seq_len=256, prefill_chunk=32, decode_chunk=4, prompt_cache_mb=1)
    want, got, tstats, jstats = _both("tiny-llm", False, kw,
                                      [([(p, 8) for p in PREFIX_PROMPTS], False)])
    assert tstats["hits"] == jstats["hits"] == 2
    pg = tstats["paging"]
    assert pg["physical"] == 1.0 and pg["physical_cow_copies_total"] == 1
    assert pg["leaks"] == 0 and pg["slot_tables"] == 0
    assert got == want


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_depth_parity_mla(monkeypatch, depth):
    """`tiny-v2` (MLA latents, DeepSeek MoE) in f32, prompt cache off:
    the three chats at once."""
    _jax_env(monkeypatch, depth)
    kw = dict(max_slots=4, max_seq_len=128, prefill_chunk=32, decode_chunk=4, prompt_cache_mb=0)
    want, got, _, _ = _both("tiny-v2", False, kw, [(CHATS, True)])
    assert [len(t) for t in got] == [8, 8, 8]
    assert got == want


def test_seq_cap_finishes_at_depth_2(monkeypatch):
    """A row that reaches the context cap with a round in flight finishes
    with "length" (the dispatch filter and the fetch's cap rule), and the
    engine serves again after it; tokens as the JAX engine's."""
    from llm_mcp_tpu.executor.engine import GenerationEngine as JaxEngine

    _jax_env(monkeypatch, 2)
    jparams, tparams = _params("tiny-llm", False)
    kw = dict(max_slots=2, max_seq_len=32, decode_chunk=4)
    outs = []
    for eng in (JaxEngine("tiny-llm", params=jparams, dtype=jnp.float32, **kw),
                GenerationEngine("tiny-llm", params=tparams, dtype=torch.float32, device="cpu",
                                 **kw)):
        eng.start()
        try:
            assert eng.pipeline_depth == 2
            a = eng.generate("fill the window " * 4, max_tokens=512, temperature=0.0)
            b = eng.generate("after cap", max_tokens=4, temperature=0.0)
        finally:
            eng.shutdown()
        outs.append((a, b))
    (ja, jb), (ta, tb) = outs
    assert ta["finish_reason"] == "length" and ta["usage"]["completion_tokens"] >= 1
    assert tb["usage"]["completion_tokens"] >= 1
    assert (ta, tb) == (ja, jb)


def test_int8_compact_cap_churn_at_depth_2(monkeypatch):
    """int8 with compaction, every one of 16 slots occupied, rows reaching
    the cap on different rounds: the pad rows find a safe target, every
    stream finishes with "length", and the tokens are the JAX engine's."""
    from llm_mcp_tpu.executor.engine import GenerationEngine as JaxEngine
    from llm_mcp_tpu.executor.engine import GenRequest as JaxRequest

    _jax_env(monkeypatch, 2)
    jparams, tparams = _params("tiny-llm", True)
    kw = dict(max_slots=16, max_seq_len=32, decode_chunk=4, quant="int8", kv_quant="int8",
              decode_compact="on", admit_batch=8)
    cases = [("w " * (3 + i), 512) for i in range(16)]
    res = []
    for eng, req in ((JaxEngine("tiny-llm", params=jparams, dtype=jnp.float32, **kw), JaxRequest),
                     (GenerationEngine("tiny-llm", params=tparams, dtype=torch.float32,
                                       device="cpu", **kw), GenRequest)):
        eng.start()
        try:
            seen = _record_tokens(eng)
            reqs = [req(prompt_ids=eng.tokenizer.encode(p), max_tokens=n, temperature=0.0)
                    for p, n in cases]
            for r in reqs:
                eng.submit(r)
            finals = [_wait(r) for r in reqs]
            again = eng.generate("post churn", max_tokens=3, temperature=0.0)
            res.append(([seen[r.request_id] for r in reqs],
                        [f["finish_reason"] for f in finals], again))
            if isinstance(eng, GenerationEngine):
                assert eng.compact_rounds > 0 and eng.kv_scale_audit() == 0
        finally:
            eng.shutdown()
    (jt, jf, ja), (tt, tf, ta) = res
    # every stream ends; those that draw no EOS end at the cap
    assert set(tf) <= {"length", "stop"} and tf.count("length") >= 12, tf
    assert ta["usage"]["completion_tokens"] >= 1
    assert (tt, tf, ta) == (jt, jf, ja)


def test_chunked_prompt_rides_decode_rounds(monkeypatch):
    """While one stream decodes, a long prompt's ragged groups go out in the
    same dispatch as its rounds (fused) and their cost feeds the scheduler
    through `observe_fused`; both streams' tokens equal a quiet JAX
    engine's (one request at a time, no chunking)."""
    from llm_mcp_tpu.executor.engine import GenerationEngine as JaxEngine
    from llm_mcp_tpu.executor.engine import GenRequest as JaxRequest

    _jax_env(monkeypatch, 2)
    jparams, tparams = _params("tiny-llm", False)
    kw = dict(max_slots=2, max_seq_len=512, decode_chunk=2, prompt_cache_mb=0)
    short, long_ = ("hi", 40), ("y" * 300, 4)
    jeng = JaxEngine("tiny-llm", params=jparams, dtype=jnp.float32, prefill_chunk=0, **kw).start()
    try:
        want = _drive(jeng, lambda ids, n: JaxRequest(prompt_ids=ids, max_tokens=n,
                                                      temperature=0.0), [short, long_], False)
    finally:
        jeng.shutdown()

    eng = GenerationEngine("tiny-llm", params=tparams, dtype=torch.float32, device="cpu",
                           prefill_chunk=8, **kw)
    trace: list[str] = []
    fused: list[int] = []
    dispatch, observe = eng._dispatch_decode, eng._sched.observe_fused

    def spy_dispatch(active, group):
        trace.append("f" if group is not None else "d")
        return dispatch(active, group)

    def spy_observe(round_s, prefill_tokens, padded_tokens=0):
        fused.append(prefill_tokens)
        return observe(round_s, prefill_tokens, padded_tokens=padded_tokens)

    eng._dispatch_decode, eng._sched.observe_fused = spy_dispatch, spy_observe
    seen = _record_tokens(eng)
    eng.start()
    try:
        a = GenRequest(prompt_ids=eng.tokenizer.encode(short[0]), max_tokens=short[1],
                       temperature=0.0)
        eng.submit(a)
        for _ in range(500):  # the short stream decodes before the long prompt comes
            if "d" in trace:
                break
            time.sleep(0.01)
        b = GenRequest(prompt_ids=eng.tokenizer.encode(long_[0]), max_tokens=long_[1],
                       temperature=0.0)
        eng.submit(b)
        _wait(a)
        _wait(b)
    finally:
        eng.shutdown()
    assert "f" in "".join(trace), trace
    assert fused and all(n > 0 for n in fused)
    assert [seen[a.request_id], seen[b.request_id]] == want


def test_cooling_fence_holds_a_freed_slot_until_its_round_is_fetched(monkeypatch):
    """One slot, depth 2, the loop stepped by hand: A finishes at the fetch
    of its first round while its second round is in flight; B, queued, is
    not admitted to the slot until that round has been fetched."""
    monkeypatch.setenv("TPU_PIPELINE_DEPTH", "2")
    eng = GenerationEngine("tiny-llm", dtype=torch.float32, device="cpu", max_slots=1,
                           max_seq_len=64, decode_chunk=4)
    a = GenRequest(prompt_ids=eng.tokenizer.encode("first"), max_tokens=3, temperature=0.0)
    b = GenRequest(prompt_ids=eng.tokenizer.encode("second"), max_tokens=2, temperature=0.0)
    eng.submit(a)
    eng.submit(b)
    with torch.inference_mode():
        eng._step()  # admits A
        assert eng._slots[0] is not None and eng._slots[0].req is a
        eng._step()  # round 1 in flight
        eng._step()  # round 2 in flight; round 1 fetched: A is done, its slot cools
        assert eng._slots[0] is None and eng._rid_dispatched == 2 and eng._rid_fetched == 1
        assert eng._cooling == {0: 2}
        assert [d.rid for d in eng._inflight] == [2]
        eng._step()  # emits A; B waits: round 2 may still write slot 0
        assert eng._slots[0] is None and eng.queue_depth() == 1
        assert eng._rid_fetched == 2 and not eng._inflight  # fetched at the end of the step
        eng._step()  # now B is admitted
        assert eng._slots[0] is not None and eng._slots[0].req is b
        assert eng._cooling == {}
        for _ in range(8):
            eng._step()
    assert _wait(a)["usage"]["completion_tokens"] == 3
    assert _wait(b)["usage"]["completion_tokens"] == 2


def test_observe_fused_matches_jax():
    """The same sequence of decode, prefill and fused observations moves
    both schedulers' cost terms and budgets alike."""
    from llm_mcp_tpu.executor.scheduler import TokenBudgetScheduler as JaxScheduler
    from llm_mcp_tpu_torch.executor.scheduler import TokenBudgetScheduler

    kw = dict(target_ttft_ms=500.0, min_budget=16, decode_seed_s=0.05, prefill_tok_seed_s=1e-4)
    j, t = JaxScheduler(**kw), TokenBudgetScheduler(**kw)
    rng = np.random.default_rng(0)
    for i in range(40):
        dt = float(rng.uniform(0.001, 0.08))
        toks = int(rng.integers(0, 600))
        for s in (j, t):
            if i % 3 == 0:
                s.observe_decode(dt)
            elif i % 3 == 1:
                s.observe_fused(dt, toks, padded_tokens=toks + 32)
            else:
                s.observe_prefill(toks, dt, padded_tokens=toks + 16)
        assert t.decode_round_s == j.decode_round_s
        assert t.prefill_tok_s == j.prefill_tok_s
        assert t.pad_waste == j.pad_waste
        assert t.decide(4000, 3, 0.1) == j.decide(4000, 3, 0.1)
    # a fused round faster than the decode term teaches nothing
    before = t.prefill_tok_s
    t.observe_fused(t.decode_round_s / 2, 100)
    assert t.prefill_tok_s == before


@pytest.mark.parametrize("model", ["tiny-llm", "tiny-v2"])
def test_host_write_targets_equal_nonzero(model):
    """The engine stages a group of three mid-prefill prompts (with pads);
    its host-built (keep, wslot, wpos) equal `torch.nonzero`'s over the
    same descriptors, and the chunk gives the same logits and cache, bit
    for bit, with either."""
    from llm_mcp_tpu_torch.models.llama import (
        llama_prefill_chunk_ragged,
        ragged_write_targets,
    )

    eng = GenerationEngine(model, dtype=torch.float32, device="cpu", max_slots=4,
                           max_seq_len=128, prefill_chunk=16, admit_batch=4, prompt_cache_mb=0)
    for n in (40, 23, 70):
        eng.submit(GenRequest(prompt_ids=list(range(3, 3 + n)), max_tokens=2, temperature=0.0))
    with torch.inference_mode():
        eng._admit_pending()
        assert len(eng._prefill_q) == 3
        eng._prefills[eng._prefill_q[1]].done = 16  # one row past its first chunk
        g = eng._stage_ragged_group(0)
        assert g.n_tokens < len(g.tokens)  # pads
        t = {k: torch.from_numpy(getattr(g, k)) for k in (
            "tokens", "rowids", "positions", "slots", "starts", "last_idx")}
        keep, wslot, wpos = ragged_write_targets(t["rowids"], t["positions"], t["slots"],
                                                 eng.max_seq_len)
        assert np.array_equal(g.keep, keep.numpy())
        assert np.array_equal(g.wslot, wslot.numpy())
        assert np.array_equal(g.wpos, wpos.numpy())
        outs = []
        for writes in (None, tuple(torch.from_numpy(x) for x in (g.keep, g.wslot, g.wpos))):
            ck = {k: v.clone() for k, v in eng._ck.items()} if isinstance(eng._ck, dict) \
                else eng._ck.clone()
            cv = eng._cv.clone()
            logits, ck, cv = llama_prefill_chunk_ragged(eng.cfg, eng.params, ck, cv, **t,
                                                        writes=writes)
            outs.append((logits, ck, cv))
    (l0, k0, v0), (l1, k1, v1) = outs
    assert torch.equal(l0, l1) and torch.equal(k0, k1) and torch.equal(v0, v1)
    assert k1.abs().sum() > 0
