"""The head_dim-64 arms (Llama-3.2-1B: 32 query heads over 8 KV heads, G = 4;
Qwen2.5-0.5B: 14 over 2, G = 7), plain versions against the Pallas bodies
in interpret mode, as `tests/test_torch_kernels.py` holds the 128 arms:

  - flash prefill: rows of full and partial length, with and without a
    sliding window;
  - ragged prefill, bf16 and int8: identity and block tables, prefixes of
    0 and more than 0 tokens;
  - bf16 decode: the whole-S, blocked and paged arms, with `append=True`:
    the cache after the call is JAX's `append_kv_bf16` of that layer bit
    for bit;
  - int8 decode: the blocked (group 256) and paged (group bt) arms and the
    whole row (S = 200, which no int8 group divides), with `append=True`:
    payload, packed-scale row and plain scales bit for bit JAX's
    `append_kv_q8` of that layer;
  - the post-append decode;
  - a reduced Llama-3.2-1B and Qwen2.5-0.5B (2 layers, narrow, head_dim
    64, G = 4 and 7 at fewer heads, a 512-token vocabulary) served by the
    port's engine and by the JAX engine with `LLM_MCP_TPU_ATTN=pallas`:
    the same greedy tokens, float weights (f32 on the CPU, as the other
    engine parity tests: bf16 rounds at other places in the two
    frameworks) and int8 weights with the int8 KV cache.

Tolerances, in f32: atol = rtol = 2e-5 as the other kernel tests; the
int8 decode within Q8_TOL of the Pallas arm (both requantize p to int8,
and a probability whose exp differs in the last bit can round to the
neighbouring int8 step: `tests/test_torch_kernels.py`) and within 2e-5 of
the plain math on the same group. The CUDA arms run on the card only
(`tests/test_torch_cuda.py -k hd64`, `chip_smoke.py`).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_mcp_tpu.kernels.attention as A
from llm_mcp_tpu_torch.kernels import attention as P
from test_torch_family_kernels import _fused_q8, _ragged_case  # both at head_dim 64

TOL = dict(atol=2e-5, rtol=2e-5)
Q8_TOL = dict(atol=2e-3, rtol=0)
HD = 64
GS = [4, 7]  # Llama-3.2-1B's and Qwen2.5-0.5B's query heads a KV head


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _j(x):
    if isinstance(x, dict):
        return {k: jnp.asarray(v) for k, v in x.items()}
    return jnp.asarray(x)


def _tq(c: dict) -> dict:
    return {k: _t(v) for k, v in c.items()}


# -- flash prefill -------------------------------------------------------------


@pytest.mark.parametrize("window,lens", [(0, [128, 128]), (0, [128, 77]), (40, [128, 90])])
@pytest.mark.parametrize("G", GS)
def test_flash_prefill_hd64_matches_pallas(G, window, lens):
    rng = np.random.default_rng(60 + G + window)
    B, Hkv, S = 2, 1, 128
    H = Hkv * G
    q = rng.standard_normal((B, H, S, HD)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, HD)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, HD)).astype(np.float32)
    ln = np.asarray(lens, np.int32)
    out_j = np.asarray(A.flash_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ln), window=window,
        interpret=True))
    out_t = P.flash_prefill_attention(_t(q), _t(k), _t(v), _t(ln), window=window).numpy()
    np.testing.assert_allclose(out_t, out_j, **TOL)


# -- ragged prefill --------------------------------------------------------------


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arm", ["bf16", "q8"])
@pytest.mark.parametrize("G", GS)
def test_ragged_prefill_hd64_matches_pallas(G, arm, paged):
    rng = np.random.default_rng(70 + G + 2 * paged + (arm == "q8"))
    c = _ragged_case(rng, G, paged)
    L, B, Hkv, S, pxb, bt = c["L"], c["B"], c["Hkv"], c["S"], c["pxb"], c["bt"]
    sc = HD**-0.5
    head = [c[k] for k in ("q", "ks", "vs")]
    tail = [c[k] for k in ("rowids", "offsets", "slots", "starts")]
    if arm == "bf16":
        ck = rng.standard_normal((L, B, Hkv, S, HD)).astype(np.float32)
        cv = rng.standard_normal((L, B, Hkv, S, HD)).astype(np.float32)
        jkw, tkw = {}, {}
        if paged:
            pk = rng.standard_normal((L, pxb, Hkv, bt, HD)).astype(np.float32)
            pv = rng.standard_normal((L, pxb, Hkv, bt, HD)).astype(np.float32)
            jkw = dict(block_tables=_j(c["tbl"]), pool_k=_j(pk), pool_v=_j(pv))
            tkw = dict(block_tables=_t(c["tbl"]), pool_k=_t(pk), pool_v=_t(pv))
        out_j = A.ragged_prefill_attend_bf16(*map(_j, head), _j(ck), _j(cv), 1, *map(_j, tail),
                                             scale=sc, impl="kernel", interpret=True,
                                             block_q=16, **jkw)
        out_t = P.ragged_prefill_attend_bf16(*map(_t, head), _t(ck), _t(cv), 1, *map(_t, tail),
                                             scale=sc, **tkw)
    else:
        cache = _fused_q8(rng, (L, B, 2 * Hkv, S, HD))
        jkw, tkw = {}, {}
        if paged:
            pool = _fused_q8(rng, (L, pxb, 2 * Hkv, bt, HD))
            jkw = dict(block_tables=_j(c["tbl"]), pool=_j(pool))
            tkw = dict(block_tables=_t(c["tbl"]), pool=_tq(pool))
        out_j = A.ragged_prefill_attend_q8(*map(_j, head), _j(cache), 1, *map(_j, tail),
                                           impl="kernel", interpret=True, block_q=16, **jkw)
        out_t = P.ragged_prefill_attend_q8(*map(_t, head), _tq(cache), 1, *map(_t, tail), **tkw)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)


# -- decode, bf16, with the fused append -------------------------------------------


def _tables(B, S, bt):
    """Tables whose first blocks live in pool rows (out of order) and one
    block in another slot's arena home."""
    nbs = S // bt
    tbl = np.arange(B * nbs, dtype=np.int32).reshape(B, nbs)
    tbl[0, 0], tbl[0, 1] = B * nbs + 2, B * nbs + 0
    tbl[1, 1] = 2 * nbs + 1
    return tbl


@pytest.mark.parametrize("arm", ["whole", "blocked", "paged"])
@pytest.mark.parametrize("G", GS)
def test_decode_bf16_hd64_matches_pallas_and_appends(monkeypatch, G, arm):
    monkeypatch.setenv("LLM_MCP_TPU_BF16_DECODE", arm)
    A.decode_attend_bf16.clear_cache()  # the arm is read at trace time
    rng = np.random.default_rng(80 + G)
    L, B, Hkv, S, bt, pxb, layer = 2, 5, 2, 256, 32, 3, 1
    ck = rng.standard_normal((L, B, Hkv, S, HD)).astype(np.float32)
    cv = rng.standard_normal((L, B, Hkv, S, HD)).astype(np.float32)
    q = rng.standard_normal((B, Hkv, G, HD)).astype(np.float32)
    nk = rng.standard_normal((B, Hkv, HD)).astype(np.float32)
    nv = rng.standard_normal((B, Hkv, HD)).astype(np.float32)
    lens = np.asarray([0, 100, S - 1, S, 63], np.int32)  # row 3 parked
    ids = np.asarray([3, 0, 4, 1, 2], np.int32)
    jkw, tkw = {}, {}
    if arm == "paged":
        pk = rng.standard_normal((L, pxb, Hkv, bt, HD)).astype(np.float32)
        pv = rng.standard_normal((L, pxb, Hkv, bt, HD)).astype(np.float32)
        tbl = _tables(B, S, bt)
        jkw = dict(block_tables=_j(tbl), pool_k=_j(pk), pool_v=_j(pv))
        tkw = dict(block_tables=_t(tbl), pool_k=_t(pk), pool_v=_t(pv))
    out_j = np.asarray(A.decode_attend_bf16(
        _j(q), _j(nk), _j(nv), _j(ck), _j(cv), jnp.int32(layer), _j(lens), slot_ids=_j(ids),
        scale=0.07, interpret=True, **jkw))
    tk, tv = _t(ck), _t(cv)
    out_t = P.decode_attend_bf16(_t(q), _t(nk), _t(nv), tk, tv, layer, _t(lens),
                                 slot_ids=_t(ids), scale=0.07, append=True, **tkw).numpy()
    live = lens < S
    np.testing.assert_allclose(out_t[live], out_j[live], **TOL)
    assert np.isfinite(out_t).all()
    ak, av = A.append_kv_bf16(_j(ck[layer:layer + 1]), _j(cv[layer:layer + 1]), _j(nk[None]),
                              _j(nv[None]), _j(lens), slot_ids=_j(ids), interpret=True)
    np.testing.assert_array_equal(tk[layer].numpy(), np.asarray(ak)[0])
    np.testing.assert_array_equal(tv[layer].numpy(), np.asarray(av)[0])
    np.testing.assert_array_equal(tk[0].numpy(), ck[0])  # the other layer untouched


# -- decode, int8, with the fused append -------------------------------------------


@pytest.mark.parametrize("arm,S", [("blocked", 512), ("paged", 256), ("whole", 200)])
@pytest.mark.parametrize("G", GS)
def test_decode_q8_hd64_matches_pallas_and_appends(monkeypatch, G, arm, S):
    """The blocked arm (group 256), the paged arm (group bt = 32) and the
    whole row at S = 200 (no int8 group divides it; it fits JAX's whole-S
    budget), each with the packed pseudo-head."""
    monkeypatch.setenv("LLM_MCP_TPU_Q8_DECODE", arm)
    A.decode_attend_q8.clear_cache()
    rng = np.random.default_rng(90 + G + S)
    L, B, Hkv, bt, pxb, layer = 2, 5, 2, 32, 3, 1
    cache = _fused_q8(rng, (L, B, 2 * Hkv, S, HD))
    q = rng.standard_normal((B, Hkv, G, HD)).astype(np.float32)
    nk = rng.standard_normal((B, Hkv, HD)).astype(np.float32)
    nv = rng.standard_normal((B, Hkv, HD)).astype(np.float32)
    lens = np.asarray([0, 100, S - 1, S, 150], np.int32)  # row 3 parked
    ids = np.asarray([3, 0, 4, 1, 2], np.int32)
    jkw, tkw, tbl, pool = {}, {}, None, None
    nbs = None
    if arm == "paged":
        pool = _fused_q8(rng, (L, pxb, 2 * Hkv, bt, HD))
        tbl = _tables(B, S, bt)
        nbs = S // bt
        jkw = dict(block_tables=_j(tbl), pool_k=_j(pool))
        tkw = dict(block_tables=_t(tbl), pool_k=_tq(pool))
    group = P.q8_decode_plan(S, HD, Hkv, Hkv * G, nbs)[0]
    assert group == {"blocked": 256, "paged": bt, "whole": S}[arm]
    out_j = np.asarray(A.decode_attend_q8(
        _j(q), _j(nk), _j(nv), _j(cache), {}, jnp.int32(layer), _j(lens), slot_ids=_j(ids),
        scale=0.07, interpret=True, **jkw))
    got = _tq(cache)
    out_t = P.decode_attend_q8(_t(q), _t(nk), _t(nv), got, {}, layer, _t(lens),
                               slot_ids=_t(ids), scale=0.07, append=True, **tkw).numpy()
    live = lens < S
    np.testing.assert_allclose(out_t[live], out_j[live], **Q8_TOL)
    want = P.decode_attend_q8_plain(_t(q), _t(nk), _t(nv), _tq(cache), layer, _t(lens),
                                    _t(ids), 0.07, group,
                                    None if tbl is None else _t(tbl),
                                    None if pool is None else _tq(pool)).numpy()
    np.testing.assert_allclose(out_t, want, **TOL)
    aq, _ = A.append_kv_q8({k: _j(v[layer:layer + 1]) for k, v in cache.items()}, {},
                           _j(nk[None]), _j(nv[None]), _j(lens), slot_ids=_j(ids),
                           interpret=True)
    for k in ("q", "s"):  # payload with the packed-scale row, and the plain scales
        np.testing.assert_array_equal(got[k][layer].numpy(), np.asarray(aq[k])[0])
        np.testing.assert_array_equal(got[k][0].numpy(), cache[k][0])
    assert not np.array_equal(got["q"][layer].numpy(), cache["q"][layer])  # rows were written


@pytest.mark.parametrize("hkv,h", [(8, 32), (2, 14)])  # Llama-3.2-1B, Qwen2.5-0.5B
def test_q8_decode_plan_hd64_takes_jax_group(hkv, h):
    """At head_dim 64 the int8 decode plan keeps JAX's group: JAX's
    whole-S budget (`decode_pallas_max_seq`, copied), its blocked BS where
    an int8 block divides S, the whole row where none does but S fits the
    budget (5313 keys at Llama-3.2-1B's widths, 19660 at Qwen2.5-0.5B's),
    else its exact fallback (group 0)."""
    budget = A.decode_pallas_max_seq(HD, hkv, h, quantized=True)
    assert P.decode_pallas_max_seq(HD, hkv, h, quantized=True) == budget
    for S in (256, 608, 1000, 4072, budget, budget + 8, 20008):
        bs = next((c for c in (256, 128, 64, 32) if S % c == 0), 0)
        want = bs or (S if S <= budget else 0)
        assert P.q8_decode_plan(S, HD, hkv, h)[0] == want, S


# -- decode_attention (post-append) ------------------------------------------------


@pytest.mark.parametrize("G", GS)
def test_decode_attention_hd64_matches_pallas(G):
    rng = np.random.default_rng(100 + G)
    B, Hkv, S = 5, 2, 96
    q = rng.standard_normal((B, Hkv, G, HD)).astype(np.float32)
    ck = rng.standard_normal((B, Hkv, S, HD)).astype(np.float32)
    cv = rng.standard_normal((B, Hkv, S, HD)).astype(np.float32)
    lens = np.asarray([0, 41, S - 1, S + 3, -1], np.int32)
    out_j = np.asarray(A.decode_attention(_j(q), _j(ck), _j(cv), _j(lens), interpret=True))
    out_t = P.decode_attention(_t(q), _t(ck), _t(cv), _t(lens)).numpy()
    np.testing.assert_allclose(out_t, out_j, **TOL)


# -- the two models, served --------------------------------------------------------

# reduced to 2 layers and narrow widths at head_dim 64 and the real G
REDUCED = {
    "llama-3.2-1b": dict(n_layers=2, dim=256, n_heads=8, n_kv_heads=2, head_dim=HD,
                         ffn_hidden=512, vocab_size=512),
    "qwen2.5-0.5b": dict(n_layers=2, dim=128, n_heads=7, n_kv_heads=1, head_dim=HD,
                         ffn_hidden=384, vocab_size=512),
}
PROMPTS = [
    "user: hello there",
    "user: " + "the quick brown fox jumps over the lazy dog " * 3,  # past prefill_chunk
    "system: be brief\nuser: 2+2?",
]
ENGINE_KW = dict(max_slots=4, max_seq_len=256, prefill_chunk=32, decode_chunk=4,
                 prompt_cache_mb=0)


def _configs(name):
    from llm_mcp_tpu.models.configs import get_config as jax_get_config
    from llm_mcp_tpu_torch.models.configs import get_config

    over = REDUCED[name]
    return (dataclasses.replace(jax_get_config(name), **over),
            dataclasses.replace(get_config(name), **over))


def _run_all(engine, make_req) -> list[list[int]]:
    seen: dict = {}
    orig = engine._process_token

    def rec(s, tok, pos):
        seen.setdefault(s.req.request_id, []).append(int(tok))
        return orig(s, tok, pos)

    engine._process_token = rec
    reqs = [make_req(engine.tokenizer.encode(p)) for p in PROMPTS]
    for r in reqs:
        engine.submit(r)
    for r in reqs:
        while True:
            evt = r.out.get(timeout=300)
            if not isinstance(evt, dict) or evt.get("type") in ("done", "error"):
                assert not isinstance(evt, dict) or evt["type"] == "done", evt
                break
    return [seen[r.request_id] for r in reqs]


@pytest.mark.parametrize("quant", ["", "int8"])
@pytest.mark.parametrize("name", sorted(REDUCED))
def test_engine_hd64_greedy_tokens_match_jax(monkeypatch, name, quant):
    """Three concurrent chats (one through ragged chunks) on the reduced
    model: the port's engine on the CPU and the JAX engine with its Pallas
    kernels in interpret mode give the same greedy tokens; with `quant`,
    int8 weights and the int8 KV cache (compacted decode at 16 slots)."""
    monkeypatch.setenv("LLM_MCP_TPU_ATTN", "pallas")
    monkeypatch.setenv("LLM_MCP_TPU_RAGGED_IMPL", "kernel")
    monkeypatch.setenv("TPU_SPEC", "0")  # int8 KV: verify rounds read exact K/V
    from llm_mcp_tpu.executor.engine import GenerationEngine as JaxEngine
    from llm_mcp_tpu.executor.engine import GenRequest as JaxRequest
    from llm_mcp_tpu.models import llama as JL
    from llm_mcp_tpu.models.quant import init_llama_params_quantized
    from llm_mcp_tpu_torch.executor import GenerationEngine, GenRequest
    from llm_mcp_tpu_torch.models.weights import params_from_numpy

    jcfg, cfg = _configs(name)
    assert cfg.resolved_head_dim == HD
    if quant:
        jp = init_llama_params_quantized(jcfg, jax.random.PRNGKey(0), scale_dtype=jnp.float32)
        kw = dict(ENGINE_KW, quant="int8", kv_quant="int8", max_slots=16)
    else:
        jp = JL.init_llama_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
        kw = dict(ENGINE_KW)
    tree = jax.tree.map(np.asarray, jp)
    jeng = JaxEngine(jcfg, params=jax.tree.map(jnp.asarray, tree), dtype=jnp.float32,
                     **kw).start()
    try:
        want = _run_all(jeng, lambda ids: JaxRequest(prompt_ids=ids, max_tokens=12,
                                                     temperature=0.0))
    finally:
        jeng.shutdown()
    teng = GenerationEngine(cfg, params=params_from_numpy(tree, cfg, "cpu", torch.float32),
                            dtype=torch.float32, device="cpu", **kw).start()
    try:
        assert teng.ragged_prefill
        got = _run_all(teng, lambda ids: GenRequest(prompt_ids=ids, max_tokens=12,
                                                    temperature=0.0))
        if quant:
            assert teng.kv_scale_audit() == 0
    finally:
        teng.shutdown()
    assert all(t for t in got)
    assert got == want
