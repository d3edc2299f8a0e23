"""The port's engine, HTTP surface and imports, end to end on the CPU.

  - greedy tokens identical to the JAX `GenerationEngine` on one shared
    `tiny-llm` parameter tree (f32; the JAX engine on its Pallas path in
    interpret mode), with the prompt cache off and one prompt longer than
    `prefill_chunk` so ragged chunks interleave with decode rounds; and
    with the prompt cache on over a sequence that stores prefixes and hits
    them, aligned and copy-on-write, through physical paging and through
    contiguous entries (a block size the physical gate refuses);
  - after a failed step the engine drops every prefix entry and table and
    serves the next request hit-free and right;
  - the same at int8 (`quant="int8", kv_quant="int8"` on one shared JAX
    int8 tree): prefix traffic through physical paging (64-token blocks)
    and contiguous entries, with equal prefix partitions, pool rows and
    hit counts, and the fused cache's packed scales equal to "s" bit for
    bit after it; three concurrent chats at `max_slots=16`, so that slot
    compaction runs (Ba = 8) on both; and `quant` alone and `kv_quant`
    alone;
  - `/v1/chat/completions` over SSE ends in `data: [DONE]`;
  - DeepSeek-V2 structure (`tiny-v2`: MLA and DeepSeek MoE) greedy
    tokens identical to the JAX engine over prefix traffic and concurrent
    chats, f32 and at `quant="int8", kv_quant="int8"`, and at int8 a hit
    that pins a whole pool block, its decode read through the pool;
  - every module of the port imports with `jax` and `llm_mcp_tpu`
    blocked, and CPU generates run (Llama bf16 and int8, `tiny-v2` int8);
  - entry points raise without CUDA unless `device="cpu"` is given.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_mcp_tpu_torch.executor import GenerationEngine, GenRequest
from llm_mcp_tpu_torch.models.configs import get_config
from llm_mcp_tpu_torch.models.weights import params_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = [
    "user: hello there",
    "user: " + "the quick brown fox jumps over the lazy dog " * 2,  # > prefill_chunk
    "system: be brief\nuser: 2+2?",
]
ENGINE_KW = dict(max_slots=4, max_seq_len=128, prefill_chunk=32, decode_chunk=4)


def _record_tokens(engine) -> dict:
    """Wrap the engine's per-token hook to record emitted ids per request."""
    seen: dict = {}
    orig = engine._process_token

    def rec(s, tok, pos):
        seen.setdefault(s.req.request_id, []).append(int(tok))
        return orig(s, tok, pos)

    engine._process_token = rec
    return seen


def _run_all(engine, make_req) -> list[list[int]]:
    seen = _record_tokens(engine)
    reqs = [make_req(engine.tokenizer.encode(p)) for p in PROMPTS]
    for r in reqs:  # concurrent: short prompts batch, the long one chunks
        engine.submit(r)
    for r in reqs:
        while True:
            evt = r.out.get(timeout=300)
            if not isinstance(evt, dict) or evt.get("type") in ("done", "error"):
                assert not isinstance(evt, dict) or evt["type"] == "done", evt
                break
    return [seen[r.request_id] for r in reqs]


def _jax_params():
    from llm_mcp_tpu.models.configs import get_config as jax_get_config
    from llm_mcp_tpu.models.llama import init_llama_params

    jparams = init_llama_params(
        jax_get_config("tiny-llm"), jax.random.PRNGKey(0), dtype=jnp.float32
    )
    tparams = params_from_numpy(
        jax.tree.map(np.asarray, jparams), get_config("tiny-llm"), "cpu", torch.float32
    )
    return jparams, tparams


def test_engine_greedy_tokens_match_jax(monkeypatch):
    monkeypatch.setenv("LLM_MCP_TPU_ATTN", "pallas")
    monkeypatch.setenv("LLM_MCP_TPU_RAGGED_IMPL", "kernel")
    from llm_mcp_tpu.executor.engine import GenerationEngine as JaxEngine
    from llm_mcp_tpu.executor.engine import GenRequest as JaxRequest

    jparams, tparams = _jax_params()
    jeng = JaxEngine(
        "tiny-llm", params=jparams, dtype=jnp.float32, prompt_cache_mb=0, **ENGINE_KW
    ).start()
    try:
        assert jeng.attn_impl == "pallas" and jeng.ragged_prefill
        want = _run_all(
            jeng, lambda ids: JaxRequest(prompt_ids=ids, max_tokens=12, temperature=0.0)
        )
    finally:
        jeng.shutdown()
    teng = GenerationEngine(
        "tiny-llm", params=tparams, dtype=torch.float32, device="cpu", prompt_cache_mb=0,
        **ENGINE_KW,
    ).start()
    try:
        got = _run_all(
            teng, lambda ids: GenRequest(prompt_ids=ids, max_tokens=12, temperature=0.0)
        )
    finally:
        teng.shutdown()
    assert len(PROMPTS[1]) + 1 > ENGINE_KW["prefill_chunk"]
    assert [len(t) for t in got] == [12, 12, 12]
    assert got == want


# Prefix traffic on the byte tokenizer (one token per byte): B shares 90+
# tokens with A, so its activation stores A's first 64 tokens (one aligned
# block); C hits it. E shares 40 with D (another system message, nothing in
# common with the first), so it stores 32 tokens, and F hits those
# unaligned: its boundary block is copied on write.
SYS1 = "system: You are a careful assistant. Answer in one short line, and never guess.\nuser: "
SYS2 = "sys: terse mode, no lists please\nuser: "
PREFIX_PROMPTS = [SYS1 + "what is 2+2?", SYS1 + "name a color", SYS1 + "spell cat",
                  SYS2 + "hi", SYS2 + "yo", SYS2 + "ok then"]
PREFIX_KW = dict(max_slots=4, max_seq_len=256, prefill_chunk=32, decode_chunk=4,
                 prompt_cache_mb=1)


def _run_seq(engine, make_req, prompts) -> list[list[int]]:
    """One request at a time, so both engines store and hit alike."""
    seen = _record_tokens(engine)
    out = []
    for p in prompts:
        r = make_req(engine.tokenizer.encode(p))
        engine.submit(r)
        while True:
            evt = r.out.get(timeout=300)
            if not isinstance(evt, dict) or evt.get("type") in ("done", "error"):
                assert not isinstance(evt, dict) or evt["type"] == "done", evt
                break
        out.append(seen[r.request_id])
    return out


@pytest.mark.parametrize("block_tokens,physical", [("64", True), ("16", False)])
def test_engine_prefix_cache_greedy_tokens_match_jax(monkeypatch, block_tokens, physical):
    monkeypatch.setenv("LLM_MCP_TPU_ATTN", "pallas")
    monkeypatch.setenv("LLM_MCP_TPU_RAGGED_IMPL", "kernel")
    monkeypatch.setenv("TPU_KV_BLOCK_TOKENS", block_tokens)  # read at construction
    from llm_mcp_tpu.executor.engine import GenerationEngine as JaxEngine
    from llm_mcp_tpu.executor.engine import GenRequest as JaxRequest

    jparams, tparams = _jax_params()
    jeng = JaxEngine("tiny-llm", params=jparams, dtype=jnp.float32, **PREFIX_KW).start()
    try:
        assert (jeng._phys is not None) == physical
        want = _run_seq(
            jeng, lambda ids: JaxRequest(prompt_ids=ids, max_tokens=8, temperature=0.0),
            PREFIX_PROMPTS,
        )
        jstats = jeng.prefix_cache_stats()
    finally:
        jeng.shutdown()
    teng = GenerationEngine(
        "tiny-llm", params=tparams, dtype=torch.float32, device="cpu", **PREFIX_KW
    ).start()
    try:
        got = _run_seq(
            teng, lambda ids: GenRequest(prompt_ids=ids, max_tokens=8, temperature=0.0),
            PREFIX_PROMPTS,
        )
        tstats = teng.prefix_cache_stats()
        paging = teng.paging_stats()
    finally:
        teng.shutdown()
    assert got == want
    assert tstats["hits"] == jstats["hits"] == 2
    assert tstats == jstats
    assert paging["leaks"] == 0 and paging["slot_tables"] == 0
    assert paging["physical"] == float(physical)
    if physical:  # 32 is not a multiple of 64: F's boundary block copies
        assert paging["cow_copies_total"] == 1
        assert paging["physical_cow_copies_total"] == 1
        assert paging["physical_missing_pins"] == 0
        assert paging["physical_pool_rows_used"] == 2  # one block per entry


def _jax_q8_params():
    """One JAX int8 tree (direct init, f32 scales) for both engines; each
    fuses it as its engine does."""
    from llm_mcp_tpu.models.configs import get_config as jax_get_config
    from llm_mcp_tpu.models.quant import init_llama_params_quantized

    jparams = init_llama_params_quantized(
        jax_get_config("tiny-llm"), jax.random.PRNGKey(0), scale_dtype=jnp.float32
    )
    tparams = params_from_numpy(
        jax.tree.map(np.asarray, jparams), get_config("tiny-llm"), "cpu", torch.float32
    )
    return jparams, tparams


@pytest.mark.parametrize("block_tokens,physical", [("64", True), ("16", False)])
def test_engine_q8_prefix_greedy_tokens_match_jax(monkeypatch, block_tokens, physical):
    """int8 weights and int8 KV with the prompt cache on: the prefix
    sequence above through physical paging (pin-only hits, one copy on
    write, the paged int8 kernels' plain versions) and contiguous entries."""
    monkeypatch.setenv("LLM_MCP_TPU_ATTN", "pallas")
    monkeypatch.setenv("LLM_MCP_TPU_RAGGED_IMPL", "kernel")
    monkeypatch.setenv("TPU_KV_BLOCK_TOKENS", block_tokens)
    from llm_mcp_tpu.executor.engine import GenerationEngine as JaxEngine
    from llm_mcp_tpu.executor.engine import GenRequest as JaxRequest

    jparams, tparams = _jax_q8_params()
    q8 = dict(quant="int8", kv_quant="int8")
    jeng = JaxEngine("tiny-llm", params=jparams, dtype=jnp.float32, **q8, **PREFIX_KW).start()
    try:
        assert (jeng._phys is not None) == physical
        want = _run_seq(
            jeng, lambda ids: JaxRequest(prompt_ids=ids, max_tokens=8, temperature=0.0),
            PREFIX_PROMPTS,
        )
        jstats, jpaging = jeng.prefix_cache_stats(), jeng.paging_stats()
    finally:
        jeng.shutdown()
    teng = GenerationEngine(
        "tiny-llm", params=tparams, dtype=torch.float32, device="cpu", **q8, **PREFIX_KW
    ).start()
    try:
        assert isinstance(teng._ck, dict) and teng._cv == {} and "wqkv" in teng.params["layers"]
        got = _run_seq(
            teng, lambda ids: GenRequest(prompt_ids=ids, max_tokens=8, temperature=0.0),
            PREFIX_PROMPTS,
        )
        tstats, paging = teng.prefix_cache_stats(), teng.paging_stats()
        audit = teng.kv_scale_audit()
    finally:
        teng.shutdown()
    assert got == want
    assert tstats["hits"] == jstats["hits"] == 2
    assert tstats == jstats
    for k in ("prefix_partition", "blocks_total", "block_tokens"):
        assert paging[k] == jpaging[k], k
    assert paging["leaks"] == 0 and paging["slot_tables"] == 0
    assert paging["physical"] == float(physical)
    if physical:
        assert paging["physical_pool_rows"] == jpaging["physical_pool_rows"]
        assert paging["physical_cow_copies_total"] == 1
        assert paging["physical_missing_pins"] == 0
    assert audit == 0


def test_engine_q8_compaction_greedy_tokens_match_jax(monkeypatch):
    """Three concurrent chats at max_slots=16 (one through ragged chunks):
    each decode round runs Ba = 8 rows through slot_ids on both engines."""
    monkeypatch.setenv("LLM_MCP_TPU_ATTN", "pallas")
    monkeypatch.setenv("LLM_MCP_TPU_RAGGED_IMPL", "kernel")
    from llm_mcp_tpu.executor.engine import GenerationEngine as JaxEngine
    from llm_mcp_tpu.executor.engine import GenRequest as JaxRequest

    jparams, tparams = _jax_q8_params()
    kw = dict(ENGINE_KW, max_slots=16, quant="int8", kv_quant="int8", prompt_cache_mb=0)
    jeng = JaxEngine("tiny-llm", params=jparams, dtype=jnp.float32, decode_compact="on",
                     **kw).start()
    try:
        assert jeng.decode_compact
        want = _run_all(
            jeng, lambda ids: JaxRequest(prompt_ids=ids, max_tokens=12, temperature=0.0)
        )
    finally:
        jeng.shutdown()
    teng = GenerationEngine("tiny-llm", params=tparams, dtype=torch.float32, device="cpu",
                            **kw).start()
    try:
        assert teng.decode_compact  # auto: on with the int8 cache
        got = _run_all(
            teng, lambda ids: GenRequest(prompt_ids=ids, max_tokens=12, temperature=0.0)
        )
        assert teng.compact_rounds > 0 and teng.kv_scale_audit() == 0
    finally:
        teng.shutdown()
    assert [len(t) for t in got] == [12, 12, 12]
    assert got == want


@pytest.mark.parametrize("quant,kv_quant", [("int8", ""), ("", "int8")])
def test_engine_one_int8_option_greedy_tokens_match_jax(monkeypatch, quant, kv_quant):
    """The options are independent: int8 weights over a float cache, and
    float weights over the int8 cache."""
    monkeypatch.setenv("LLM_MCP_TPU_ATTN", "pallas")
    monkeypatch.setenv("LLM_MCP_TPU_RAGGED_IMPL", "kernel")
    from llm_mcp_tpu.executor.engine import GenerationEngine as JaxEngine
    from llm_mcp_tpu.executor.engine import GenRequest as JaxRequest

    jparams, tparams = _jax_q8_params() if quant else _jax_params()
    kw = dict(ENGINE_KW, quant=quant, kv_quant=kv_quant, prompt_cache_mb=0)
    jeng = JaxEngine("tiny-llm", params=jparams, dtype=jnp.float32, **kw).start()
    try:
        want = _run_all(
            jeng, lambda ids: JaxRequest(prompt_ids=ids, max_tokens=12, temperature=0.0)
        )
    finally:
        jeng.shutdown()
    teng = GenerationEngine("tiny-llm", params=tparams, dtype=torch.float32, device="cpu",
                            **kw).start()
    try:
        assert isinstance(teng._ck, dict) == bool(kv_quant)
        got = _run_all(
            teng, lambda ids: GenRequest(prompt_ids=ids, max_tokens=12, temperature=0.0)
        )
    finally:
        teng.shutdown()
    assert got == want


def test_kv_scale_audit_after_appends_and_block_copies():
    """Appends, pool copies (arena to pool, pool to pool) and a
    copy-on-write on the fused cache keep the packed pseudo-head equal to
    "s" bit for bit; a copy that moves the payload and not "s" is seen."""
    from llm_mcp_tpu_torch.kernels import attention as K

    eng = GenerationEngine("tiny-llm", dtype=torch.float32, device="cpu", max_slots=2,
                           max_seq_len=128, prompt_cache_mb=1, quant="int8", kv_quant="int8")
    assert eng._phys is not None and eng._pool_k["q"].shape[1] >= 2
    cfg, g = eng.cfg, torch.Generator().manual_seed(0)
    shape = (cfg.n_layers, 2, cfg.n_kv_heads, cfg.resolved_head_dim)
    for w in ([5, 70], [6, 128], [64, 71]):  # row 1 parked once
        K.append_kv_q8(eng._ck, eng._cv, torch.randn(shape, generator=g),
                       torch.randn(shape, generator=g), torch.tensor(w, dtype=torch.int32))
    eng._pool_put_arena(0, 0, 0)
    eng._pool_put_pool(0, 1)
    eng._cow_block(1, 1, 1)
    assert eng._pool_k["s"][:, 1].any() and eng.kv_scale_audit() == 0
    eng._ck["q"][:, 1, :, 6] = eng._ck["q"][:, 0, :, 6]  # payload moved, "s" not
    assert eng.kv_scale_audit() == cfg.n_layers * 2 * cfg.n_kv_heads
    eng.shutdown()


def test_engine_drops_unknown_int8_options(caplog):
    eng = GenerationEngine("tiny-llm", dtype=torch.float32, device="cpu", max_seq_len=64,
                           quant="int4", kv_quant="fp8", decode_compact="sometimes")
    assert (eng.quant, eng.kv_quant, eng.decode_compact) == ("", "", False)
    assert not isinstance(eng._ck, dict)
    text = caplog.text
    assert "unknown quant mode" in text and "unknown kv_quant mode" in text
    assert "unknown decode_compact mode" in text
    eng.shutdown()


def test_engine_failed_step_drops_prefix_state(monkeypatch):
    """A step that raises mid-decode errors its requests and leaves no
    prefix entry, ledger table or pool row behind; the next request with
    the same prefix is served hit-free, with the tokens of a fresh engine."""
    from llm_mcp_tpu_torch.executor import engine as E

    _, tparams = _jax_params()
    kw = dict(params=tparams, dtype=torch.float32, device="cpu", **PREFIX_KW)
    fresh = GenerationEngine("tiny-llm", **kw).start()
    try:
        want = _run_seq(
            fresh, lambda ids: GenRequest(prompt_ids=ids, max_tokens=8, temperature=0.0),
            PREFIX_PROMPTS[2:3],
        )
    finally:
        fresh.shutdown()
    eng = GenerationEngine("tiny-llm", **kw).start()
    try:
        for p in PREFIX_PROMPTS[:2]:
            eng.generate(p, max_tokens=4, temperature=0.0)
        assert eng.prefix_cache_stats()["entries"] == 1
        real = E.llama_decode_step
        calls = {"n": 0}

        def flaky(*a, **k):
            calls["n"] += 1
            if calls["n"] == 2:
                raise RuntimeError("injected step failure")
            return real(*a, **k)

        monkeypatch.setattr(E, "llama_decode_step", flaky)
        with pytest.raises(RuntimeError, match="injected"):
            eng.generate(PREFIX_PROMPTS[2], max_tokens=8, temperature=0.0)
        monkeypatch.setattr(E, "llama_decode_step", real)
        st, pg = eng.prefix_cache_stats(), eng.paging_stats()
        assert st["entries"] == 0 and st["hits"] == 1
        assert pg["leaks"] == 0 and pg["slot_tables"] == 0 and pg["blocks_used"] == 0
        assert pg["physical_pool_rows_used"] == 0
        assert not eng._pool_k.any() and not eng._ck.any()
        got = _run_seq(
            eng, lambda ids: GenRequest(prompt_ids=ids, max_tokens=8, temperature=0.0),
            PREFIX_PROMPTS[2:3],
        )
        assert eng.prefix_cache_stats()["hits"] == 1  # no new hit
    finally:
        eng.shutdown()
    assert got == want


def test_engine_events_and_stop_rules():
    eng = GenerationEngine("tiny-llm", dtype=torch.float32, device="cpu", **ENGINE_KW).start()
    try:
        evts = list(eng.generate_stream("user: hi", max_tokens=5, temperature=0.0))
        assert all(e["type"] == "token" for e in evts[:-1])
        done = evts[-1]
        assert done["type"] == "done" and done["finish_reason"] == "length"
        assert done["usage"]["completion_tokens"] == 5
        assert done["usage"]["total_tokens"] == done["usage"]["prompt_tokens"] + 5
        assert done["ttft_ms"] >= 0
        # a prompt at the context cap is left-truncated and stops at the cap
        out = eng.generate("z" * 400, max_tokens=50, temperature=0.0)
        assert out["finish_reason"] == "length"
        assert out["usage"]["prompt_tokens"] == ENGINE_KW["max_seq_len"] - ENGINE_KW["decode_chunk"]
        # max_tokens = 0 finishes at once
        out = eng.generate("abc", max_tokens=0)
        assert out["usage"]["completion_tokens"] == 0
        # sampled requests run on the same path
        out = eng.generate("abc", max_tokens=6, temperature=0.9, top_k=8, top_p=0.9)
        assert out["usage"]["completion_tokens"] <= 6
    finally:
        eng.shutdown()


def test_chat_completions_sse_ends_in_done():
    from llm_mcp_tpu_torch.api.inference import serve

    eng = GenerationEngine("tiny-llm", dtype=torch.float32, device="cpu", **ENGINE_KW).start()
    api = serve({"tiny-llm": eng})
    base = f"http://127.0.0.1:{api.port}"
    try:
        body = {
            "model": "tiny-llm", "stream": True, "max_tokens": 6, "temperature": 0,
            "messages": [{"role": "user", "content": "hello"}],
        }
        req = urllib.request.Request(
            base + "/v1/chat/completions", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.headers["Content-Type"] == "text/event-stream"
            lines = [ln for ln in r.read().decode().splitlines() if ln.startswith("data: ")]
        assert lines[-1] == "data: [DONE]"
        chunks = [json.loads(ln[6:]) for ln in lines[:-1]]
        assert chunks[0]["choices"][0]["delta"] == {"role": "assistant"}
        assert chunks[-1]["choices"][0]["finish_reason"] == "length"
        assert chunks[-1]["usage"]["completion_tokens"] == 6
        # the same request without streaming
        body["stream"] = False
        req = urllib.request.Request(
            base + "/v1/chat/completions", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())
        assert out["object"] == "chat.completion"
        assert out["choices"][0]["finish_reason"] == "length"
        with urllib.request.urlopen(base + "/v1/models", timeout=30) as r:
            assert json.loads(r.read())["data"][0]["id"] == "tiny-llm"
        with urllib.request.urlopen(base + "/health", timeout=30) as r:
            assert json.loads(r.read())["engines"]["tiny-llm"]["device"] == "cpu"
    finally:
        api.shutdown()
        eng.shutdown()


_IMPORT_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["llm_mcp_tpu"] = None
sys.modules["ml_dtypes"] = None
import torch
import llm_mcp_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(llm_mcp_tpu_torch.__path__, "llm_mcp_tpu_torch.")]
for name in ("llm_mcp_tpu_torch.models.weights", "llm_mcp_tpu_torch.executor.bpe",
             "llm_mcp_tpu_torch.executor.tokenizer", "llm_mcp_tpu_torch.native",
             "llm_mcp_tpu_torch.models.embedder", "llm_mcp_tpu_torch.executor.embedding"):
    assert name in mods, name
for name in mods:
    importlib.import_module(name)
# a checkpoint directory (a windowed family, the real-vocabulary tokenizer)
import json, os, shutil, tempfile
from llm_mcp_tpu_torch.executor.bpe import BPETokenizer
from llm_mcp_tpu_torch.models.configs import get_config
from llm_mcp_tpu_torch.models.llama import init_llama_params
from llm_mcp_tpu_torch.models.weights import llama_to_hf_tensors, write_checkpoint_dir
ckpt = tempfile.mkdtemp()
cfg = get_config("tiny-mistral")
tree = init_llama_params(cfg, torch.Generator().manual_seed(0), torch.float32)
write_checkpoint_dir(ckpt, llama_to_hf_tensors(cfg, tree), shards=2, config={
    "model_type": "mistral", "vocab_size": 512, "hidden_size": 128, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2, "intermediate_size": 256,
    "sliding_window": 64, "tie_word_embeddings": True})
shutil.copy(os.path.join("tests", "fixtures", "tiny_real_vocab", "tokenizer.json"), ckpt)
from llm_mcp_tpu_torch.executor import GenerationEngine
eng = GenerationEngine("my-mistral", weights_dir=ckpt, max_slots=2, max_seq_len=128,
                       prefill_chunk=16, dtype=torch.float32, device="cpu").start()
assert isinstance(eng.tokenizer, BPETokenizer) and eng.cfg.sliding_window == 64
out = eng.generate("Hello there, a checkpoint directory.", max_tokens=4, temperature=0)
assert out["usage"]["completion_tokens"] >= 1, out
eng.shutdown()
shutil.rmtree(ckpt)
from llm_mcp_tpu_torch.executor import GenerationEngine
eng = GenerationEngine("tiny-llm", max_slots=2, max_seq_len=128, prefill_chunk=16,
                       dtype=torch.float32, device="cpu", prompt_cache_mb=1).start()
sys_msg = "system: the same long preamble for both requests\nuser: "
for q in ("hello", "again", "third"):  # the second stores, the third hits
    out = eng.generate(sys_msg + q, max_tokens=4, temperature=0)
    assert out["usage"]["completion_tokens"] == 4, out
hits, pg = eng.prefix_cache_stats()["hits"], eng.paging_stats()
eng.shutdown()
assert hits == 1 and pg["physical"] == 1.0 and pg["leaks"] == 0, (hits, pg)
# the int8 serving configuration, the same traffic: a hit through the pool
eng = GenerationEngine("tiny-llm", max_slots=2, max_seq_len=128, prefill_chunk=16,
                       dtype=torch.float32, device="cpu", prompt_cache_mb=1,
                       quant="int8", kv_quant="int8").start()
for q in ("hello", "again", "third"):
    out = eng.generate(sys_msg + q, max_tokens=4, temperature=0)
    assert out["usage"]["completion_tokens"] == 4, out
hits, audit = eng.prefix_cache_stats()["hits"], eng.kv_scale_audit()
eng.shutdown()
assert hits == 1 and audit == 0, (hits, audit)
# the MLA path (DeepSeek-V2 structure) with int8 latents, the same traffic
eng = GenerationEngine("tiny-v2", max_slots=2, max_seq_len=128, prefill_chunk=16,
                       dtype=torch.float32, device="cpu", prompt_cache_mb=1,
                       quant="int8", kv_quant="int8").start()
for q in ("hello", "again", "third"):
    out = eng.generate(sys_msg + q, max_tokens=4, temperature=0)
    assert out["usage"]["completion_tokens"] == 4, out
hits = eng.prefix_cache_stats()["hits"]
eng.shutdown()
assert hits == 1, hits
# the embedders: an encoder and a decoder, float and int8
from llm_mcp_tpu_torch.executor import EmbeddingEngine
for name, quant in (("tiny-embed", ""), ("tiny-embed", "int8"), ("tiny-qwen3", "int8")):
    emb = EmbeddingEngine(name, max_batch=2, max_seq_len=64, dtype=torch.float32, device="cpu",
                          quant=quant)
    vecs, ntok = emb.embed(["one", "two", "three"], dimensions=16)
    assert len(vecs) == 3 and len(vecs[0]) == 16 and ntok > 0, (name, quant)
bad = [k for k, v in sys.modules.items() if v is not None and
       (k.split(".")[0] in ("jax", "jaxlib", "llm_mcp_tpu"))]
assert not bad, bad
print("IMPORT_OK")
"""


def test_port_imports_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    r = subprocess.run(
        [sys.executable, "-c", _IMPORT_PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0 and "IMPORT_OK" in r.stdout, r.stdout + r.stderr


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is available")
    with pytest.raises(RuntimeError, match="CUDA"):
        GenerationEngine("tiny-llm")
    with pytest.raises(RuntimeError, match="CUDA"):
        GenerationEngine("tiny-llm", device="cuda")
    from llm_mcp_tpu_torch.api.__main__ import main

    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--model", "tiny-llm", "--port", "0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--model", "tiny-llm", "--port", "0", "--quant", "int8", "--kv-quant", "int8"])
    eng = GenerationEngine("tiny-llm", device="cpu", max_seq_len=64)
    assert eng.device.type == "cpu"
    eng.shutdown()
    from llm_mcp_tpu_torch.executor import EmbeddingEngine

    for name in ("tiny-embed", "tiny-qwen3"):
        with pytest.raises(RuntimeError, match="CUDA"):
            EmbeddingEngine(name)
        with pytest.raises(RuntimeError, match="CUDA"):
            EmbeddingEngine(name, device="cuda", quant="int8")
        assert EmbeddingEngine(name, device="cpu", max_seq_len=64).device.type == "cpu"


def _jax_v2_params(quant: bool):
    """One JAX `tiny-v2` tree (dense layer 0, MoE layers with shared experts,
    yarn rope): f32, or direct int8 with f32 scales."""
    from llm_mcp_tpu.models.configs import get_config as jax_get_config
    from llm_mcp_tpu.models.llama import init_llama_params
    from llm_mcp_tpu.models.quant import init_llama_params_quantized

    jcfg = jax_get_config("tiny-v2")
    if quant:
        jparams = init_llama_params_quantized(jcfg, jax.random.PRNGKey(0), scale_dtype=jnp.float32)
    else:
        jparams = init_llama_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tparams = params_from_numpy(
        jax.tree.map(np.asarray, jparams), get_config("tiny-v2"), "cpu", torch.float32
    )
    return jparams, tparams


@pytest.mark.parametrize("quant,block_tokens", [("", "64"), ("int8", "256")])
def test_engine_mla_greedy_tokens_match_jax(monkeypatch, quant, block_tokens):
    """DeepSeek-V2 structure (`tiny-v2`): the prefix sequence above (two
    hits) through physical paging, then three concurrent chats (one through
    ragged chunks), in f32 and at `quant=int8 kv_quant=int8` (int8 latents,
    compaction on). The JAX engine runs its Pallas path in interpret mode
    (`LLM_MCP_TPU_ATTN=pallas`). At int8 its decode takes the kernel arm
    (pre-append, the exact current token), forced to the paged body
    (`LLM_MCP_TPU_Q8_DECODE=paged`: in interpret mode with tables it would
    take its exact fallback, a different computation); one 256-token block
    per row then gives JAX's paged group and the port's whole-row group the
    same 256 keys on every step. f32: 64-token blocks, one hit pinned
    through the pool, one copied on write; int8: both hits copied on
    write (entries shorter than a block)."""
    monkeypatch.setenv("LLM_MCP_TPU_ATTN", "pallas")
    monkeypatch.setenv("LLM_MCP_TPU_RAGGED_IMPL", "kernel")
    monkeypatch.setenv("TPU_KV_BLOCK_TOKENS", block_tokens)
    if quant:
        monkeypatch.setenv("LLM_MCP_TPU_Q8_DECODE", "paged")
    from llm_mcp_tpu.executor.engine import GenerationEngine as JaxEngine
    from llm_mcp_tpu.executor.engine import GenRequest as JaxRequest

    jparams, tparams = _jax_v2_params(bool(quant))
    kw = dict(PREFIX_KW, quant=quant, kv_quant=quant)
    jeng = JaxEngine("tiny-v2", params=jparams, dtype=jnp.float32, **kw).start()
    try:
        want = _run_seq(
            jeng, lambda ids: JaxRequest(prompt_ids=ids, max_tokens=8, temperature=0.0),
            PREFIX_PROMPTS,
        )
        want += _run_all(
            jeng, lambda ids: JaxRequest(prompt_ids=ids, max_tokens=8, temperature=0.0)
        )
        jstats = jeng.prefix_cache_stats()
    finally:
        jeng.shutdown()
    teng = GenerationEngine("tiny-v2", params=tparams, dtype=torch.float32, device="cpu",
                            **kw).start()
    try:
        assert isinstance(teng._ck, dict) == bool(quant)
        if quant:  # two planes of their own, not fused; routed banks stay f32
            assert set(teng._ck) == set(teng._cv) == {"q", "s"}
            assert teng._ck["q"].shape[-1] == 32 and teng._cv["q"].shape[-1] == 16
            assert not isinstance(teng.params["layers"]["w1e"], dict)
            assert teng.decode_compact
        got = _run_seq(
            teng, lambda ids: GenRequest(prompt_ids=ids, max_tokens=8, temperature=0.0),
            PREFIX_PROMPTS,
        )
        got += _run_all(
            teng, lambda ids: GenRequest(prompt_ids=ids, max_tokens=8, temperature=0.0)
        )
        tstats, paging = teng.prefix_cache_stats(), teng.paging_stats()
        audit = teng.kv_scale_audit()
    finally:
        teng.shutdown()
    assert got == want
    assert tstats["hits"] == jstats["hits"] == 2
    assert tstats == jstats
    assert paging["physical"] == 1.0 and paging["leaks"] == 0 and paging["slot_tables"] == 0
    assert paging["physical_cow_copies_total"] == (2 if quant else 1)
    assert paging["physical_missing_pins"] == 0
    assert audit == 0  # the latent planes carry no packed pseudo-head


def test_engine_mla_q8_pool_pinned_hit_matches_jax(monkeypatch):
    """`tiny-v2` at `quant=int8 kv_quant=int8`, 64-token blocks: A and B
    share 86 tokens (SYS1) and stop after their first token, so neither
    decodes; B's activation stores the 64-token prefix, one whole block,
    and C hits it: its table pins the pool row (no copy on write) and every
    one of its decode steps reads block 0 from the pool, through the int8
    MLA decode's paged arm, with the bt-key requantization group of JAX's
    paged body (forced with `LLM_MCP_TPU_Q8_DECODE=paged`, as above). Greedy
    tokens identical to the JAX engine."""
    monkeypatch.setenv("LLM_MCP_TPU_ATTN", "pallas")
    monkeypatch.setenv("LLM_MCP_TPU_RAGGED_IMPL", "kernel")
    monkeypatch.setenv("TPU_KV_BLOCK_TOKENS", "64")
    monkeypatch.setenv("LLM_MCP_TPU_Q8_DECODE", "paged")
    from llm_mcp_tpu.executor.engine import GenerationEngine as JaxEngine
    from llm_mcp_tpu.executor.engine import GenRequest as JaxRequest
    from llm_mcp_tpu_torch.models import mla as TMLA

    prompts = PREFIX_PROMPTS[:3]
    max_tokens = [1, 1, 12]

    def run(engine, request):
        seen = _record_tokens(engine)
        out = []
        for p, n in zip(prompts, max_tokens):
            r = request(engine.tokenizer.encode(p), n)
            engine.submit(r)
            while True:
                evt = r.out.get(timeout=300)
                if not isinstance(evt, dict) or evt.get("type") in ("done", "error"):
                    assert not isinstance(evt, dict) or evt["type"] == "done", evt
                    break
            out.append(seen[r.request_id])
        return out

    jparams, tparams = _jax_v2_params(True)
    kw = dict(PREFIX_KW, quant="int8", kv_quant="int8")
    jeng = JaxEngine("tiny-v2", params=jparams, dtype=jnp.float32, **kw).start()
    try:
        want = run(jeng, lambda ids, n: JaxRequest(prompt_ids=ids, max_tokens=n, temperature=0.0))
        jstats = jeng.prefix_cache_stats()
    finally:
        jeng.shutdown()

    decode = TMLA.decode_attend_q8_mla
    steps = {"decode": 0, "through_pool": 0}

    def spy(*args, **kwargs):
        steps["decode"] += 1
        tbl, rows = kwargs.get("block_tables"), kwargs.get("slot_ids")
        if tbl is not None:
            rows = torch.arange(args[0].shape[0]) if rows is None else rows.long()
            pool_base = args[4]["q"].shape[1] * tbl.shape[1]
            steps["through_pool"] += int((tbl[rows] >= pool_base).any())
        return decode(*args, **kwargs)

    monkeypatch.setattr(TMLA, "decode_attend_q8_mla", spy)
    teng = GenerationEngine("tiny-v2", params=tparams, dtype=torch.float32, device="cpu",
                            **kw).start()
    try:
        got = run(teng, lambda ids, n: GenRequest(prompt_ids=ids, max_tokens=n, temperature=0.0))
        tstats, paging = teng.prefix_cache_stats(), teng.paging_stats()
        n_layers = teng.cfg.n_layers
    finally:
        teng.shutdown()
    assert [len(t) for t in got] == max_tokens
    assert got == want
    assert tstats["hits"] == jstats["hits"] == 1
    assert paging["physical"] == 1.0 and paging["physical_cow_copies_total"] == 0
    assert paging["leaks"] == 0 and paging["physical_missing_pins"] == 0
    # C's decode steps (rounds of decode_chunk), every layer through the pool row
    assert steps["decode"] >= 11 * n_layers and steps["through_pool"] == steps["decode"], steps
