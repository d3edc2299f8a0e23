"""Self-speculative decoding in the port against the JAX package's, on the
CPU, from numpy seeds.

  - `executor/drafter.py`: the port's copy drafts what JAX's drafts, after
    every append of random histories;
  - `ops/sampling.py:spec_verify`: greedy rows give JAX's (n_acc, final)
    exactly, in all-greedy and mixed batches; sampled rows are held to
    the target distribution by a chi-square test under an adversarial
    drafter (the least likely token drafted every time), over the full
    vocabulary and inside a top-k window (the port's random stream is a
    `torch.Generator`, so sampled tokens cannot equal JAX's);
  - `models/llama.py:llama_prefill_chunk_batch(all_logits=True)` against
    JAX's over f32, the fused int8 cache, block tables (`paged`), and MLA
    f32 and int8 latents: logits within 1e-4 (f32; 2e-3 with int8
    caches, whose past rows are dequantized after the dot on both sides),
    written caches as `test_torch_model.py` / `test_torch_mla.py` compare
    them; a pad row (slot B) reads and writes nothing the live rows see;
  - the engine: greedy tokens with `TPU_SPEC` on equal those with it off
    and the JAX engine's with it on, while verify rounds accept drafts,
    for `tiny-llm` f32, `tiny-llm` int8 (weights and the fused cache) and
    `tiny-mla`; sampled traffic completes; `TPU_SPEC=0` builds no verify
    function and no drafter; `speculation_stats()` has JAX's keys.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_mcp_tpu.executor.drafter import NGramDrafter as JaxDrafter
from llm_mcp_tpu.models import llama as JL
from llm_mcp_tpu.models.configs import get_config as jax_get_config
from llm_mcp_tpu_torch.executor import GenerationEngine, GenRequest
from llm_mcp_tpu_torch.executor.drafter import NGramDrafter
from llm_mcp_tpu_torch.models import llama as TL
from llm_mcp_tpu_torch.models.configs import get_config
from llm_mcp_tpu_torch.models.weights import params_from_numpy
from llm_mcp_tpu_torch.ops.sampling import spec_verify
from test_torch_mla import _assert_latents, _caches, _copy, _pools, _tree_j, _tree_t
from test_torch_model import _assert_q8_cache_close, _cache, _fused_cache, _paged_operand

LOGIT_TOL = dict(atol=1e-4, rtol=0)
LOGIT_TOL_Q8 = dict(atol=2e-3, rtol=0)
CACHE_TOL = dict(atol=1e-5, rtol=0)

# -- the drafter ------------------------------------------------------------------


@pytest.mark.parametrize("seed,min_n,alphabet", [(0, 2, 4), (1, 2, 7), (2, 1, 3), (3, 3, 5)])
def test_drafter_matches_jax(seed, min_n, alphabet):
    rng = np.random.default_rng(seed)
    mine, ref = NGramDrafter(min_n, max(min_n, 3)), JaxDrafter(min_n, max(min_n, 3))
    # loops and noise: a period-5 stretch, then random tokens, then a loop
    hist = list(rng.integers(0, alphabet, 40)) + [1, 2, 3, 4, 5] * 6 + list(
        rng.integers(0, alphabet, 60))
    for tok in hist:
        mine.append(int(tok))
        ref.append(int(tok))
        for k in (1, 3, 7):
            assert mine.draft(k) == ref.draft(k)
    assert len(mine) == len(ref) == len(hist)
    for bad in (dict(min_n=0), dict(min_n=3, max_n=2)):
        with pytest.raises(ValueError):
            NGramDrafter(**bad)


# -- spec_verify ----------------------------------------------------------------------


def _jax_verify(logits, drafts, nd, temp, top_k=0, top_p=1.0, seed=0):
    from llm_mcp_tpu.ops.sampling import spec_verify as jax_spec_verify

    A = logits.shape[0]
    n_acc, final = jax_spec_verify(
        jnp.asarray(logits), jnp.asarray(drafts), jnp.asarray(nd), jax.random.PRNGKey(seed),
        jnp.asarray(temp, dtype=jnp.float32), jnp.full((A,), top_k, jnp.int32),
        jnp.full((A,), top_p, jnp.float32))
    return np.asarray(n_acc), np.asarray(final)


def _port_verify(logits, drafts, nd, temp, top_k=0, top_p=1.0, seed=0):
    A = logits.shape[0]
    t = torch.from_numpy
    n_acc, final = spec_verify(
        t(logits), t(drafts), t(nd), torch.Generator().manual_seed(seed),
        t(np.asarray(temp, np.float32)), torch.full((A,), top_k, dtype=torch.int32),
        torch.full((A,), top_p, dtype=torch.float32))
    return n_acc.numpy(), final.numpy()


@pytest.mark.parametrize("mixed", [False, True])
def test_spec_verify_greedy_matches_jax(mixed):
    """Rows whose drafts agree with the argmax for 0..K positions, rows with
    fewer drafts, a row with none; greedy rows give JAX's counts and final
    tokens exactly, alone and beside sampled rows."""
    rng = np.random.default_rng(3)
    A, C, V = 8, 6, 50
    K = C - 1
    logits = rng.standard_normal((A, C, V)).astype(np.float32) * 3
    arg = logits.argmax(-1)
    drafts = arg[:, :K].copy()
    nd = np.full(A, K, np.int32)
    for a in range(A):
        cut = a % (K + 1)  # the first disagreeing position
        if cut < K:
            drafts[a, cut] = (arg[a, cut] + 1) % V
    nd[3], nd[5], nd[6] = 2, 0, 1
    drafts = drafts.astype(np.int32)
    temp = np.zeros(A, np.float32)
    if mixed:
        temp[1::2] = 0.8
    ja, jf = _jax_verify(logits, drafts, nd, temp)
    ta, tf = _port_verify(logits, drafts, nd, temp)
    greedy = temp <= 0
    assert (ta[greedy] == ja[greedy]).all() and (tf[greedy] == jf[greedy]).all()
    assert (ta <= nd).all()


# chi-square critical values at p = 0.999 by degrees of freedom
CHI2_999 = {4: 18.47, 7: 24.32}


@pytest.mark.parametrize("top_k", [0, 5])
def test_spec_verify_adversarial_drafter_preserves_distribution(top_k):
    """Rejection sampling is exact: with the least likely token of the
    target drafted every time, the first emitted token's marginal is the
    target's (the full softmax, or the softmax of the top-k window) by
    chi-square at p = 0.999; the draft is accepted at its target
    probability within 0.05."""
    A, V = 4000, 8
    row = np.array([2.0, 1.5, 1.0, 0.5, 0.0, -0.5, -1.0, -2.0], np.float32)
    n = V if top_k == 0 else top_k
    p = np.exp(row[:n] - row.max())
    p /= p.sum()
    logits = np.tile(row, (A, 2, 1)).astype(np.float32)
    worst = n - 1  # the least likely token of the target's support
    drafts = np.full((A, 1), worst, np.int32)
    n_acc, final = _port_verify(logits, drafts, np.ones(A, np.int32), np.ones(A, np.float32),
                                top_k=top_k, seed=7)
    first = np.where(n_acc >= 1, drafts[:, 0], final)
    counts = np.bincount(first, minlength=V).astype(np.float64)
    assert counts[n:].sum() == 0
    expected = p * A
    chi2 = float(((counts[:n] - expected) ** 2 / expected).sum())
    assert chi2 < CHI2_999[n - 1], (chi2, counts.tolist(), expected.tolist())
    assert abs(float((n_acc >= 1).mean()) - p[worst]) < 0.05


# -- the batched chunk with every position's logits -------------------------------------


def _llama_trees(quant: bool):
    from llm_mcp_tpu.models import quant as JQ

    jcfg = jax_get_config("tiny-llm")
    if quant:
        jparams = JQ.fuse_layer_weights(JQ.init_llama_params_quantized(
            jcfg, jax.random.PRNGKey(0), scale_dtype=jnp.float32))
    else:
        jparams = JL.init_llama_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jparams)
    cfg = get_config("tiny-llm")
    return jcfg, jparams, cfg, params_from_numpy(tree, cfg, "cpu", torch.float32)


def _mla_trees():
    jcfg = jax_get_config("tiny-mla")
    jparams = JL.init_llama_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jparams)
    cfg = get_config("tiny-mla")
    return jcfg, jparams, cfg, params_from_numpy(tree, cfg, "cpu", torch.float32)


# four chunks: a long past, no past, a past past a 64-token bucket, a short one
CHUNK_SLOTS = np.asarray([2, 0, 3, 1], np.int32)
CHUNK_STARTS = np.asarray([40, 0, 77, 9], np.int32)
CHUNK_NVALID = np.asarray([8, 5, 1, 3], np.int32)


def _chunk_inputs(rng, C=8):
    tokens = rng.integers(3, 259, (4, C)).astype(np.int32)
    return tokens, CHUNK_SLOTS, CHUNK_STARTS, CHUNK_NVALID


@pytest.mark.parametrize("layout", ["f32", "f32-paged", "int8", "int8-paged"])
def test_prefill_chunk_batch_matches_jax(layout):
    quant, paged = layout.startswith("int8"), layout.endswith("paged")
    jcfg, jparams, cfg, tparams = _llama_trees(quant)
    rng = np.random.default_rng(21)
    B, S, bt = 4, 128, 32
    args = _chunk_inputs(rng)
    if quant:
        ck, cv = _fused_cache(rng, cfg, B, S), {}
    else:
        ck, cv = _cache(rng, cfg, B, S)
    jpg = tpg = None
    if paged:
        tbl, pk, pv = _paged_operand(rng, cfg, B, S, bt)
        if quant:
            pk, pv = _fused_cache(rng, cfg, 3, bt), {}
        jpg = {"tbl": jnp.asarray(tbl), "k": _tree_j(pk), "v": _tree_j(pv)}
        tpg = {"tbl": torch.from_numpy(tbl), "k": _tree_t(pk), "v": _tree_t(pv)}
    jl, jk, jv = JL.llama_prefill_chunk_batch(
        jcfg, jparams, _tree_j(ck), _tree_j(cv), *map(jnp.asarray, args), skey=128,
        all_logits=True, paged=jpg)
    tl, tk, tv = TL.llama_prefill_chunk_batch(
        cfg, tparams, _tree_t(_copy(ck)), _tree_t(_copy(cv)), *map(torch.from_numpy, args),
        skey=128, all_logits=True, paged=tpg)
    assert tl.shape == (4, 8, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **(LOGIT_TOL_Q8 if quant else LOGIT_TOL))
    if quant:
        assert tv == jv == {}
        _assert_q8_cache_close(tk, jk, cfg)
    else:
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **CACHE_TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **CACHE_TOL)
    if paged:  # the tables mattered
        flat, _, _ = TL.llama_prefill_chunk_batch(
            cfg, tparams, _tree_t(_copy(ck)), _tree_t(_copy(cv)), *map(torch.from_numpy, args),
            skey=128, all_logits=True)
        assert not np.allclose(flat.numpy()[0], tl.numpy()[0], atol=1e-3)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("paged", [False, True])
def test_mla_prefill_chunk_batch_matches_jax(quantized, paged):
    jcfg, jparams, cfg, tparams = _mla_trees()
    rng = np.random.default_rng(22)
    B, S, bt, pxb = 4, 128, 32, 3
    cc, cr = _caches(rng, cfg, B, S, quantized)
    args = _chunk_inputs(rng)
    jpg = tpg = None
    if paged:
        pc, pr, tbl = _pools(rng, cfg, cc, cr, B, S, bt, pxb, quantized)
        jpg = {"tbl": jnp.asarray(tbl), "k": _tree_j(pc), "v": _tree_j(pr)}
        tpg = {"tbl": torch.from_numpy(tbl), "k": _tree_t(pc), "v": _tree_t(pr)}
    jl, jc, jr = JL.llama_prefill_chunk_batch(
        jcfg, jparams, _tree_j(cc), _tree_j(cr), *map(jnp.asarray, args), skey=128,
        all_logits=True, paged=jpg)
    tl, tc, tr = TL.llama_prefill_chunk_batch(
        cfg, tparams, _tree_t(_copy(cc)), _tree_t(_copy(cr)), *map(torch.from_numpy, args),
        skey=128, all_logits=True, paged=tpg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               **(LOGIT_TOL_Q8 if quantized else LOGIT_TOL))
    _assert_latents(tc, jc)
    _assert_latents(tr, jr)


def test_prefill_chunk_batch_pad_row_and_last_logits():
    """A pad row (slot B, JAX's convention) writes nothing and leaves the
    live rows' logits as they are; without `all_logits` each row's logits
    are its last valid position's; a smaller past bucket (`skey`) that
    covers every start changes nothing."""
    _, _, cfg, tparams = _llama_trees(False)
    rng = np.random.default_rng(23)
    B, S = 4, 128
    ck, cv = _cache(rng, cfg, B, S)
    tokens, slots, starts, nvalid = _chunk_inputs(rng)
    t = torch.from_numpy
    full, k1, v1 = TL.llama_prefill_chunk_batch(
        cfg, tparams, t(ck.copy()), t(cv.copy()), t(tokens[:2]), t(slots[:2]), t(starts[:2]),
        t(nvalid[:2]), all_logits=True)
    padded = (np.concatenate([tokens[:2], tokens[2:3]]), np.asarray([2, 0, B], np.int32),
              np.asarray([40, 0, 0], np.int32), np.asarray([8, 5, 1], np.int32))
    got, k2, v2 = TL.llama_prefill_chunk_batch(
        cfg, tparams, t(ck.copy()), t(cv.copy()), *map(t, padded), skey=64, all_logits=True)
    np.testing.assert_allclose(got.numpy()[:2], full.numpy(), atol=1e-5, rtol=0)
    assert torch.equal(k1, k2) and torch.equal(v1, v2)
    last, _, _ = TL.llama_prefill_chunk_batch(
        cfg, tparams, t(ck.copy()), t(cv.copy()), t(tokens[:2]), t(slots[:2]), t(starts[:2]),
        t(nvalid[:2]))
    np.testing.assert_allclose(last.numpy(), full.numpy()[[0, 1], nvalid[:2] - 1], atol=1e-6)


# -- the engine -------------------------------------------------------------------------

REPETITIVE = ("repeat this exact list again and again: alpha beta gamma delta "
              "alpha beta gamma delta alpha beta gamma delta")
SPEC_PROMPTS = [REPETITIVE, "count with me: one two three, one two three, one two three"]
SPEC_LAYOUTS = {
    # name: (model, int8 weights, engine kwargs)
    "llm-f32": ("tiny-llm", False, {}),
    "llm-int8": ("tiny-llm", True, dict(quant="int8", kv_quant="int8")),
    "mla-f32": ("tiny-mla", False, {}),
}
SPEC_KW = dict(max_slots=2, max_seq_len=256, decode_chunk=4, prefill_chunk=32,
               prompt_cache_mb=0)


def _port_run(tparams, model, kw, prompts, max_tokens=48, **req):
    """Greedy tokens and texts of `prompts` queued together on a fresh
    port engine driven by hand; the engine is returned for its stats."""
    from test_torch_memory import _hand_drive

    eng = GenerationEngine(model, params=tparams, dtype=torch.float32, device="cpu", **kw)
    reqs = [GenRequest(prompt_ids=eng.tokenizer.encode(p), max_tokens=max_tokens,
                       temperature=0.0, **req) for p in prompts]
    toks, texts, finals = _hand_drive(eng, reqs)
    assert all(f["type"] == "done" for f in finals), finals
    eng.shutdown()
    return toks, texts, eng


@pytest.mark.parametrize("layout", list(SPEC_LAYOUTS))
def test_engine_greedy_spec_identity_and_jax(monkeypatch, layout):
    """Greedy tokens with `TPU_SPEC` on equal those with it off (the verify
    rounds accept drafts on repetitive prompts), and the texts equal the
    JAX engine's with `TPU_SPEC` on, both queued before their loops."""
    from test_torch_memory import _jax_uncontended, _params

    from llm_mcp_tpu.executor.engine import GenerationEngine as JaxEngine

    monkeypatch.setenv("LLM_MCP_TPU_ATTN", "pallas")
    monkeypatch.setenv("LLM_MCP_TPU_RAGGED_IMPL", "kernel")
    monkeypatch.delenv("TPU_SPEC", raising=False)
    model, quant, extra = SPEC_LAYOUTS[layout]
    kw = dict(SPEC_KW, **extra)
    jparams, tparams = _params(model, quant)
    jeng = JaxEngine(model, params=jparams, dtype=jnp.float32, **kw)
    try:
        want = _jax_uncontended(jeng, [(p, 48, 0) for p in SPEC_PROMPTS])
        jstats = jeng.speculation_stats()
    finally:
        jeng.shutdown()
    toks, texts, eng = _port_run(tparams, model, kw, SPEC_PROMPTS)
    st = eng.speculation_stats()
    assert set(st) == set(jstats)
    assert st["enabled"] == 1.0 and st["verify_calls"] > 0 and st["accepted_tokens"] > 0
    assert eng._sched.verify_rounds == st["verify_calls"]
    assert texts == want
    monkeypatch.setenv("TPU_SPEC", "0")
    plain, _, off = _port_run(tparams, model, kw, SPEC_PROMPTS)
    assert toks == plain
    assert off.speculation_stats()["verify_calls"] == 0.0


def test_spec_kill_switch_builds_nothing(monkeypatch):
    """`TPU_SPEC=0` (and `TPU_SPEC_K=0`): no verify function, no drafter on
    any slot, zero counters, the JAX engine's `speculation_stats()`."""
    from llm_mcp_tpu.executor.engine import GenerationEngine as JaxEngine

    for env in (("TPU_SPEC", "0"), ("TPU_SPEC_K", "0")):
        monkeypatch.delenv("TPU_SPEC", raising=False)
        monkeypatch.delenv("TPU_SPEC_K", raising=False)
        monkeypatch.setenv(*env)
        _, _, eng = _port_run(None, "tiny-llm", SPEC_KW, [REPETITIVE], max_tokens=16)
        assert not eng.spec_enabled and eng._verify_fn is None
        assert all(s is None or s.spec is None for s in eng._slots)
        assert eng._sched.verify_rounds == 0
        jeng = JaxEngine("tiny-llm", max_slots=2, max_seq_len=256, dtype=jnp.float32)
        try:
            assert eng.speculation_stats() == jeng.speculation_stats()
        finally:
            jeng.shutdown()


def test_spec_knobs_and_sampled_traffic(monkeypatch):
    """`TPU_SPEC_K` / `TPU_SPEC_MIN_NGRAM` as JAX reads them; sampled rows
    (temperature, top-k, top-p beside a greedy one, at temperatures low
    enough that the texts repeat and drafts form) go through the
    rejection-sampling verify and complete without errors."""
    monkeypatch.setenv("TPU_SPEC_K", "4")
    monkeypatch.setenv("TPU_SPEC_MIN_NGRAM", "3")
    eng = GenerationEngine("tiny-llm", max_slots=4, max_seq_len=256, dtype=torch.float32,
                           device="cpu", prompt_cache_mb=0)
    assert (eng.spec_k, eng.spec_min_ngram, eng.spec_max_ngram) == (4, 3, 3)
    eng.start()
    try:
        import concurrent.futures as cf

        cases = [dict(temperature=0.0), dict(temperature=0.05), dict(temperature=0.05, top_k=8),
                 dict(temperature=0.05, top_p=0.9)]
        with cf.ThreadPoolExecutor(max_workers=4) as ex:
            outs = list(ex.map(lambda kw: eng.generate(REPETITIVE, max_tokens=24, **kw), cases))
        assert all(o["usage"]["completion_tokens"] >= 1 for o in outs)
        assert eng.total_errors == 0 and eng.speculation_stats()["verify_calls"] > 0
    finally:
        eng.shutdown()
