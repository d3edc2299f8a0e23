"""Grammar-constrained decoding in the port against the JAX package's, on
the CPU, from numpy seeds.

  - the port's copy of `constrain/` (grammar, schema, masks) accepts and
    rejects exactly what the reference's does: the same interned state at
    every step of seeded random walks over regex, choice, json_schema and
    json_object specs, the same accepting flags and live bytes, and the
    same `GrammarError` messages on bad specs;
  - packed mask rows, transitions, filtered drafts and per-draft masks bit
    for bit equal to the reference's over the BPE vocabulary of
    `tests/fixtures/tiny_real_vocab` (a tokenizer that is not the byte
    one: token bytes come from `decode`);
  - `expand_mask` / `apply_token_mask` equal JAX's on [B, V] and [A, C, V]
    logits (exact; -inf where masked), and a bias never brings back a
    masked token;
  - a masked verify never emits an illegal token (greedy: the masked
    argmax is judged; sampled: chi-square over the legal set at p = 0.999
    under an adversarial drafter);
  - the engine: greedy constrained texts equal the JAX engine's (f32;
    choice, a forced regex, a closed json_schema, logit_bias); constrained
    speculation (masked verify) emits what the masked single step emits;
    a bad spec errors the request and the engine serves on; mixed
    constrained and unconstrained traffic (uncompacted, and compacted with
    every slot held) leaves each stream's text as it is alone;
    `TPU_CONSTRAIN=0` builds no compiler and no masked step and changes no
    token; a constrained victim's tokens survive preempt -> offload ->
    restore (the cursor rebuilt from its spec and replayed);
  - the chat API: `parse_constraints` returns the reference's
    (constraint, logit_bias, error) on a table of bodies, and the HTTP
    handler answers its 400s and serves constrained chats.
"""

from __future__ import annotations

import json
import os
import re
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_mcp_tpu import constrain as jcn
from llm_mcp_tpu_torch import constrain as tcn
from llm_mcp_tpu_torch.executor import GenerationEngine, GenRequest
from llm_mcp_tpu_torch.ops.sampling import apply_token_mask, expand_mask, spec_verify

CLOSED_SCHEMA = {
    "type": "object",
    "properties": {"tool": {"enum": ["search", "fetch"]}, "urgent": {"type": "boolean"}},
    "required": ["tool", "urgent"],
}
SPECS = [
    {"type": "regex", "pattern": "a(b|c){2}d?"},
    {"type": "regex", "pattern": "[a-c]+[0-9]*!"},
    {"type": "regex", "pattern": "[^x]x|(ha|ho){1,8}!"},
    {"type": "choice", "choices": ["yes", "no", "maybe", "héllo"]},
    {"type": "json_schema", "schema": CLOSED_SCHEMA},
    {"type": "json_schema", "schema": {
        "$defs": {"lvl": {"enum": ["low", "high"]}},
        "anyOf": [{"type": "object", "properties": {"op": {"const": "set"},
                                                    "level": {"$ref": "#/$defs/lvl"}}},
                  {"const": "noop"}]}},
    {"type": "json_schema", "schema": {
        "type": "object",
        "properties": {"n": {"type": "integer"}, "x": {"type": "number"},
                       "tags": {"type": "array", "items": {"type": "string"}},
                       "none": {"type": "null"}}}},
    {"type": "json_object"},
]
BAD_SPECS = [
    {"type": "regex", "pattern": "a(b"},
    {"type": "regex", "pattern": "a{3,1}"},
    {"type": "regex", "pattern": "[z-a]"},
    {"type": "regex", "pattern": "a**"},
    {"type": "json_schema", "schema": {"type": "object", "properties": {"x": {"$ref": "#/nope"}}}},
    {"type": "yaml"},
]


def _walk(auto, rng, steps):
    """A seeded walk: mostly live bytes, sometimes any byte (a dead end)."""
    sid, trace = auto.start_state, []
    for _ in range(steps):
        live = sorted(auto.live_bytes(sid))
        if not live or rng.random() < 0.1:
            byte = int(rng.integers(0, 256))
        else:
            byte = int(live[rng.integers(0, len(live))])
        sid = auto.step(sid, byte)
        trace.append((byte, sid, sid >= 0 and auto.accepting(sid),
                      sorted(auto.live_bytes(sid)) if sid >= 0 else None))
        if sid < 0:
            sid = auto.start_state
    return trace


@pytest.mark.parametrize("i", range(len(SPECS)))
def test_automata_match_jax(i):
    spec = SPECS[i]
    mine, ref = tcn.build_automaton(spec), jcn.build_automaton(spec)
    assert mine.accepting(mine.start_state) == ref.accepting(ref.start_state)
    for seed in range(4):
        assert _walk(mine, np.random.default_rng(seed), 60) == _walk(
            ref, np.random.default_rng(seed), 60)
    assert mine.n_states() == ref.n_states()


def test_bad_specs_raise_as_jax():
    for spec in BAD_SPECS:
        with pytest.raises(jcn.GrammarError) as want:
            jcn.build_automaton(spec)
        with pytest.raises(tcn.GrammarError) as got:
            tcn.build_automaton(spec)
        assert str(got.value) == str(want.value)


# -- token masks over a real BPE vocabulary ----------------------------------------------

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "tiny_real_vocab", "tokenizer.json")


@pytest.fixture(scope="module")
def bpe():
    from llm_mcp_tpu.executor.bpe import BPETokenizer

    tok = BPETokenizer(FIXTURE, force_python=True)
    return tok, int(tok.vocab_size)


@pytest.mark.parametrize("i", [0, 3, 4, 5, 7])
def test_mask_rows_match_jax_on_real_vocab(bpe, i):
    """Both compilers over the same BPE tokenizer: every mask row along a
    seeded walk of legal tokens, each transition, the filtered draft of a
    random proposal and its per-position masks, bit for bit."""
    tok, V = bpe
    spec = SPECS[i]
    mine = tcn.ConstraintCompiler(tok, V).make(spec, logit_bias=[[5, 1.5]])
    ref = jcn.ConstraintCompiler(tok, V).make(spec, logit_bias=[[5, 1.5]])
    assert mine.cc.table.n_tokens == ref.cc.table.n_tokens > 0
    rng = np.random.default_rng(i)
    for _ in range(24):
        row = mine.mask_row()
        np.testing.assert_array_equal(row, ref.mask_row())
        legal = [t for t in range(V) if (row[t >> 5] >> (t & 31)) & 1]
        if not legal:
            break  # a byte no whole token spells ("é" here): a dead end on both
        proposal = [int(t) for t in rng.integers(0, V, 3)] + legal[:2]
        assert mine.filter_draft(proposal) == ref.filter_draft(proposal)
        d = mine.filter_draft(legal[:1] + proposal)
        np.testing.assert_array_equal(mine.masks_for_draft(d), ref.masks_for_draft(d))
        t = legal[int(rng.integers(0, len(legal)))]
        if t == tok.eos_id:
            break
        assert mine.advance(t) == ref.advance(t)
        assert (mine.state, mine.accepting) == (ref.state, ref.accepting)
    assert (mine.bias_ids, mine.bias_vals) == (ref.bias_ids, ref.bias_vals)


# -- the mask and the masked verify --------------------------------------------------------


def _pack(legal, V):
    row = np.zeros(tcn.mask_words(V), dtype=np.uint32)
    for t in legal:
        row[t >> 5] |= np.uint32(1 << (t & 31))
    return row


@pytest.mark.parametrize("ndim", [2, 3])
def test_apply_token_mask_matches_jax(ndim):
    from llm_mcp_tpu.ops.sampling import apply_token_mask as jax_apply
    from llm_mcp_tpu.ops.sampling import expand_mask as jax_expand

    rng = np.random.default_rng(ndim)
    B, C, V, NB = 5, 3, 300, 6  # V not a multiple of 32
    W = tcn.mask_words(V)
    lead = (B,) if ndim == 2 else (B, C)
    logits = rng.standard_normal(lead + (V,)).astype(np.float32)
    packed = rng.integers(0, 2 ** 32, lead + (W,), dtype=np.uint64).astype(np.uint32)
    bids = np.stack([rng.choice(V, NB, replace=False) for _ in range(B)]).astype(np.int32)
    bids[:, -2:] = -1  # pads
    bvals = rng.uniform(-100, 100, (B, NB)).astype(np.float32)
    want = np.asarray(jax_apply(jnp.asarray(logits), jnp.asarray(packed), jnp.asarray(bids),
                                jnp.asarray(bvals)))
    t = torch.from_numpy
    got = apply_token_mask(t(logits), t(packed.view(np.int32)), t(bids), t(bvals)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(expand_mask(t(packed.view(np.int32)), V).numpy(),
                                  np.asarray(jax_expand(jnp.asarray(packed), V)))
    # a bias never brings back a masked token
    V = 8
    out = apply_token_mask(torch.zeros(1, V), t(_pack({1, 2}, V)[None].view(np.int32)),
                           torch.tensor([[5, 2, -1]]), torch.tensor([[100.0, 3.0, 9.9]]))
    assert out[0, 2] == 3.0 and out[0, 1] == 0.0
    assert torch.isneginf(out[0, 5]) and torch.isneginf(out[0, 0])


def _verify(logits, drafts, nd, temp, seed=0):
    A = logits.shape[0]
    n_acc, final = spec_verify(
        torch.from_numpy(logits), torch.from_numpy(drafts), torch.from_numpy(np.asarray(nd)),
        torch.Generator().manual_seed(seed), torch.full((A,), temp),
        torch.zeros(A, dtype=torch.int32), torch.ones(A), exact=True)
    return n_acc.numpy(), final.numpy()


def test_masked_verify_greedy_never_emits_illegal():
    V, legal = 8, {1, 4, 6}
    logits = np.zeros((2, 3, V), np.float32)
    logits[:, :, 0], logits[:, :, 4], logits[:, :, 1] = 10.0, 5.0, 3.0  # argmax 0 illegal
    packed = np.broadcast_to(_pack(legal, V), (2, 3, tcn.mask_words(V))).copy()
    masked = apply_token_mask(torch.from_numpy(logits),
                              torch.from_numpy(packed.view(np.int32))).numpy()
    drafts = np.array([[4, 4], [0, 0]], np.int32)  # row 1 drafts the illegal argmax
    n_acc, final = _verify(masked, drafts, [2, 2], 0.0)
    assert n_acc.tolist() == [2, 0] and final.tolist() == [4, 4]


def test_masked_chi_square_rejection_resampling_stays_exact():
    """Per-position masks before accept/reject and the least likely legal
    token drafted every time: the emitted marginal is the masked,
    renormalized target (chi-square over the 5 legal outcomes, df = 4,
    18.47 at p = 0.999), and no masked token ever comes out."""
    A, V = 4000, 8
    legal = [0, 1, 2, 4, 6]
    row = np.array([2.0, 1.5, 1.0, 0.5, 0.0, -0.5, -1.0, -2.0], np.float32)
    p = np.exp(row[legal] - row[legal].max())
    p /= p.sum()
    logits = np.tile(row, (A, 2, 1)).astype(np.float32)
    packed = np.broadcast_to(_pack(set(legal), V), (A, 2, tcn.mask_words(V))).copy()
    masked = apply_token_mask(torch.from_numpy(logits),
                              torch.from_numpy(packed.view(np.int32))).numpy()
    worst = 6
    drafts = np.full((A, 1), worst, np.int32)
    n_acc, final = _verify(masked, drafts, np.ones(A, np.int32), 1.0, seed=11)
    first = np.where(n_acc >= 1, drafts[:, 0], final)
    counts = np.bincount(first, minlength=V).astype(np.float64)
    assert counts[3] == counts[5] == counts[7] == 0
    expected = p * A
    chi2 = float(((counts[legal] - expected) ** 2 / expected).sum())
    assert chi2 < 18.47, (chi2, counts.tolist(), expected.tolist())
    assert abs(float((n_acc >= 1).mean()) - p[legal.index(worst)]) < 0.05


# -- the engine -------------------------------------------------------------------------------

# fully forced: greedy output is the literal on any model, and its
# repetition gives the drafter something to speculate on
FORCED_RE = "(alpha beta gamma delta ){4}done"
FORCED_TEXT = "alpha beta gamma delta " * 4 + "done"
ENGINE_CASES = [
    ("pick a side", 16, dict(constraint={"type": "choice", "choices": ["heads", "tails"]})),
    ("say the phrase", 128, dict(constraint={"type": "regex", "pattern": FORCED_RE})),
    ("call a tool", 48, dict(constraint={"type": "json_schema", "schema": CLOSED_SCHEMA})),
    ("laugh", 24, dict(constraint={"type": "regex", "pattern": "(ha|ho){1,8}!"})),
    ("anything", 6, dict(logit_bias=[[3 + ord("z"), 100.0], [3 + ord("q"), 99.0]])),
]
ENGINE_KW = dict(max_slots=2, max_seq_len=256, decode_chunk=4, prompt_cache_mb=0)


def _port_engine(**kw):
    from test_torch_spec import _llama_trees

    kw = dict(ENGINE_KW, **kw)
    params = kw.pop("params", None)
    if params is None:
        params = _llama_trees(False)[3]
    return GenerationEngine("tiny-llm", params=params, dtype=torch.float32, device="cpu", **kw)


def test_engine_constrained_texts_match_jax(monkeypatch):
    """Greedy constrained requests, one at a time on each engine: texts,
    usage and finish reasons equal the JAX engine's; every constrained
    output matches its grammar; no illegal token; the bias-only request
    compiles no grammar."""
    from test_torch_spec import _llama_trees

    from llm_mcp_tpu.executor.engine import GenerationEngine as JaxEngine

    monkeypatch.setenv("LLM_MCP_TPU_ATTN", "pallas")
    monkeypatch.setenv("LLM_MCP_TPU_RAGGED_IMPL", "kernel")
    for k in ("TPU_SPEC", "TPU_CONSTRAIN"):
        monkeypatch.delenv(k, raising=False)
    _, jparams, _, tparams = _llama_trees(False)
    jeng = JaxEngine("tiny-llm", params=jparams, dtype=jnp.float32, **ENGINE_KW).start()
    try:
        want = [jeng.generate(p, max_tokens=n, temperature=0.0, **kw)
                for p, n, kw in ENGINE_CASES]
        jstats = jeng.constrain_stats()
    finally:
        jeng.shutdown()
    eng = _port_engine(params=tparams).start()
    try:
        got = [eng.generate(p, max_tokens=n, temperature=0.0, **kw) for p, n, kw in ENGINE_CASES]
        st = eng.constrain_stats()
    finally:
        eng.shutdown()
    assert got == want
    assert got[0]["text"] in ("heads", "tails") and got[1]["text"] == FORCED_TEXT
    doc = json.loads(got[2]["text"])
    assert doc["tool"] in ("search", "fetch") and isinstance(doc["urgent"], bool)
    assert re.fullmatch("(ha|ho){1,8}!", got[3]["text"])
    assert set(st) == set(jstats) and set(st["cache"]) == set(jstats["cache"])
    for k in ("requests", "tokens", "illegal_tokens", "finished", "finished_accepting",
              "schema_valid_rate"):
        assert st[k] == jstats[k], k
    assert st["illegal_tokens"] == 0.0 and st["schema_valid_rate"] == 1.0
    assert st["cache"]["misses"] == 4 and eng.cn_bias_max == 64


def test_engine_constrained_spec_identity(monkeypatch):
    """Constrained speculation: the masked verify rounds run (filtered
    drafts accepted) and emit token for token what the masked single step
    emits with `TPU_SPEC=0`."""
    from test_torch_memory import _hand_drive

    cn = {"type": "regex", "pattern": FORCED_RE}
    runs = []
    for spec in ("1", "0"):
        monkeypatch.setenv("TPU_SPEC", spec)
        eng = _port_engine()
        reqs = [GenRequest(prompt_ids=eng.tokenizer.encode(p), max_tokens=128, temperature=0.0,
                           constraint=cn) for p in ("say the phrase", "and again")]
        toks, texts, _ = _hand_drive(eng, reqs)
        runs.append((toks, texts, eng))
    (toks, texts, spec), (plain, _, off) = runs
    assert texts == [FORCED_TEXT] * 2 and toks == plain
    assert spec.cn_spec_drafted > 0 and spec.cn_spec_accepted > 0
    assert off.cn_spec_drafted == 0 and off._cn_step_fn is not None
    assert spec.constrain_stats()["illegal_tokens"] == 0.0


def test_engine_rejects_bad_spec_and_serves_on():
    eng = _port_engine().start()
    try:
        with pytest.raises(RuntimeError, match="constraint"):
            eng.generate("x", max_tokens=4, temperature=0.0,
                         constraint={"type": "regex", "pattern": "a(b"})
        ok = eng.generate("x", max_tokens=4, temperature=0.0)
        assert ok["usage"]["completion_tokens"] >= 1 and eng.total_errors == 1
    finally:
        eng.shutdown()


@pytest.mark.parametrize("layout", ["full", "compacted"])
def test_mixed_traffic_keeps_each_stream(layout):
    """Constrained slots beside unconstrained ones: the pipelined rounds
    park the constrained rows (uncompacted) and the masked steps' pad rows
    leave the ring as they found it (compacted, every slot held, so pads
    aim at a live row): each stream's greedy tokens are its tokens alone."""
    from test_torch_memory import _hand_drive

    kw = dict(max_slots=2) if layout == "full" else dict(max_slots=16, decode_compact="on",
                                                         admit_batch=8)
    B = kw["max_slots"]
    cases = []
    for i in range(B):
        if i % 2:
            cases.append((f"free text {i}", 20, {}))
        else:
            cases.append((f"laugh {i}", 20, dict(constraint={"type": "regex",
                                                                 "pattern": "(ha|ho){1,9}!"})))

    def mk(eng, sel):
        return [GenRequest(prompt_ids=eng.tokenizer.encode(p), max_tokens=n, temperature=0.0,
                           **c) for p, n, c in (cases[i] for i in sel)]

    eng = _port_engine(**kw)
    together, _, _ = _hand_drive(eng, mk(eng, range(B)))
    alone = [_hand_drive(eng, mk(eng, [i]))[0][0] for i in range(B)]
    assert together == alone
    assert eng.constrain_stats()["illegal_tokens"] == 0.0
    if layout == "compacted":
        assert eng.compact_rounds > 0


def test_constrain_kill_switch_is_a_noop(monkeypatch):
    """`TPU_CONSTRAIN=0`: no compiler, no masked step, a constraint keyword
    ignored, greedy tokens as an unconstrained request's with it on, and
    the JAX engine's off-state `constrain_stats()`; with it on, plain
    traffic builds no masked step either."""
    from test_torch_memory import _hand_drive

    from llm_mcp_tpu.executor.engine import GenerationEngine as JaxEngine

    prompt = "tell me something interesting"
    monkeypatch.setenv("TPU_CONSTRAIN", "0")
    off = _port_engine()
    toks_off, _, _ = _hand_drive(off, [GenRequest(
        prompt_ids=off.tokenizer.encode(prompt), max_tokens=24, temperature=0.0,
        constraint={"type": "choice", "choices": ["ignored"]})])
    assert off._constrain is None and off._cn_step_fn is None
    jeng = JaxEngine("tiny-llm", max_slots=2, max_seq_len=64, dtype=jnp.float32)
    try:
        assert off.constrain_stats() == jeng.constrain_stats()
    finally:
        jeng.shutdown()
    monkeypatch.setenv("TPU_CONSTRAIN", "1")
    on = _port_engine()
    toks_on, _, _ = _hand_drive(on, [GenRequest(
        prompt_ids=on.tokenizer.encode(prompt), max_tokens=24, temperature=0.0)])
    assert toks_off == toks_on
    assert on._constrain is not None and on._cn_step_fn is None
    assert on.constrain_stats()["requests"] == 0.0


def test_constrained_preempt_restore_token_identical(monkeypatch):
    """A constrained victim goes to the host and comes back: its cursor is
    rebuilt from the spec and replayed over the consumed ids, and its
    greedy tokens equal the uncontended run's (a reset cursor would force
    the pattern from its start again)."""
    from test_torch_memory import _hand_drive

    monkeypatch.setenv("TPU_KV_HOST_OFFLOAD", "1")
    cn = {"type": "regex", "pattern": "(alpha beta gamma delta ){2}done"}
    eng = _port_engine(max_seq_len=256)
    replays = []
    make = eng._constrain.make

    def spy(*a, **k):
        out = make(*a, **k)
        replays.append(out)
        return out

    def mk():
        return [GenRequest(prompt_ids=eng.tokenizer.encode(p), max_tokens=64, temperature=0.0,
                           priority=pri, constraint=cn)
                for p, pri in (("constrained preempt probe", 0), ("second constrained", 1))]

    eng._constrain.make = spy
    hi = GenRequest(prompt_ids=eng.tokenizer.encode("urgent"), max_tokens=8, temperature=0.0,
                    priority=5)
    toks, texts, _ = _hand_drive(eng, mk(), hi, 2)
    st = eng.memory_stats()
    assert st["preempted_total"] >= 1 and st["restored_total"] >= 1
    assert len(replays) > 2  # two attaches, then the restore's rebuild
    ref, _, _ = _hand_drive(eng, mk())
    assert toks[:-1] == ref
    assert texts[0] == texts[1] == "alpha beta gamma delta " * 2 + "done"
    assert eng.constrain_stats()["illegal_tokens"] == 0.0 and eng.total_errors == 0


# -- the chat API ---------------------------------------------------------------------------

TOOLS = [{"type": "function", "function": {"name": "search", "parameters": CLOSED_SCHEMA}},
         {"type": "function", "function": {"name": "noop"}}]
BODIES = [
    {},
    {"response_format": {"type": "json_schema", "json_schema": {"schema": CLOSED_SCHEMA}}},
    {"response_format": {"type": "json_schema", "schema": CLOSED_SCHEMA}},
    {"response_format": {"type": "json_object"}},
    {"response_format": {"type": "choice", "choices": ["a", "b"]}},
    {"response_format": {"type": "regex", "pattern": "a+"}},
    {"response_format": {"type": "text"}},
    {"response_format": {"type": "yaml"}},
    {"response_format": {"type": "regex"}},
    {"response_format": {"type": "choice", "choices": []}},
    {"response_format": {"type": "json_schema"}},
    {"response_format": "json"},
    {"tools": TOOLS, "tool_choice": "auto"},
    {"tools": TOOLS, "tool_choice": "none"},
    {"tools": TOOLS},
    {"tools": TOOLS, "tool_choice": {"type": "function", "function": {"name": "search"}}},
    {"tools": TOOLS, "tool_choice": "required"},
    {"tools": TOOLS, "tool_choice": {"function": {"name": "ghost"}}},
    {"tools": TOOLS, "tool_choice": "sometimes"},
    {"tools": [], "tool_choice": "required"},
    {"tools": [{"function": {}}], "tool_choice": "required"},
    {"logit_bias": {"5": 150, "7": -3.5}},
    {"logit_bias": {"999": 1}},
    {"logit_bias": {str(i): 1 for i in range(70)}},
    {"logit_bias": {"x": 1}},
    {"logit_bias": [5, 1]},
    {"response_format": {"type": "choice", "choices": ["x"]}, "logit_bias": {"3": 2}},
]


@pytest.mark.parametrize("n_vocab", [259, 0])
def test_parse_constraints_matches_jax(n_vocab):
    from llm_mcp_tpu.api.inference import parse_constraints as jax_parse

    from llm_mcp_tpu_torch.api.inference import parse_constraints

    for body in BODIES:
        assert parse_constraints(body, n_vocab, 64) == jax_parse(body, n_vocab, 64), body


def _post(port: int, body: dict):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/chat/completions",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_constrained_chats_and_400s():
    from llm_mcp_tpu.api.inference import parse_constraints as jax_parse

    from llm_mcp_tpu_torch.api.inference import serve

    eng = _port_engine().start()
    api = serve({"tiny-llm": eng})
    try:
        base = {"model": "tiny-llm", "messages": [{"role": "user", "content": "hi"}],
                "max_tokens": 96, "temperature": 0}
        for bad in ({"logit_bias": {"99999": 2}}, {"response_format": {"type": "yaml"}},
                    {"tools": TOOLS, "tool_choice": {"function": {"name": "ghost"}}}):
            code, out = _post(api.port, dict(base, **bad))
            assert code == 400
            assert out["error"]["message"] == jax_parse(dict(base, **bad), 512, 64)[2]
        code, out = _post(api.port, dict(base, response_format={"type": "choice",
                                                                "choices": ["yes", "no"]}))
        assert code == 200 and out["choices"][0]["message"]["content"] in ("yes", "no")
        code, out = _post(api.port, dict(base, tools=TOOLS, tool_choice={
            "type": "function", "function": {"name": "search"}}))
        assert code == 200
        doc = json.loads(out["choices"][0]["message"]["content"])
        assert doc["name"] == "search" and doc["arguments"]["tool"] in ("search", "fetch")
        assert eng.constrain_stats()["requests"] == 2.0
    finally:
        api.shutdown()
        eng.shutdown()
