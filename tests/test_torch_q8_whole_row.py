"""The int8 decode's whole-row requantization group against the JAX package.

Where no int8 block (256/128/64/32 keys) divides the cache length S, JAX's
`decode_attend_q8` runs its whole-S body (`_attend_q8_kernel`, p
requantized once over the attended row) as long as the row fits that
body's budget (`decode_pallas_max_seq`: 2849 keys at Llama-3.1-8B's
widths, 41391 at tiny-llm's), and its exact f32 fallback past it. The
port's `q8_decode_plan` makes the same choice, so on the CPU its public
`decode_attend_q8` (the plain version with that group) equals JAX's public
`decode_attend_q8(..., interpret=True)` within TOL = 2e-5: both requantize
with the same group and differ by f32 rounding alone. Here:

  - S = 1000 at tiny widths (hd 32, Hkv 2, G 4) and at Llama-3.1-8B's
    (hd 128, Hkv 8, G 4), where the whole row fits the budget, and S =
    4072 at Llama-3.1-8B's, where it does not (the exact arm against JAX's
    fallback); packed and plain scales; rows at w = 0, 255, 256, S - 1 and
    one parked (its output is discarded, as the engine does);
  - an int8-KV engine at `max_seq_len=1000` (contiguous cache, the
    whole-row group) emits the JAX engine's greedy tokens on one shared
    int8 parameter tree.

The kernel's whole-row arm runs on the card (`tests/test_torch_cuda.py`);
its schedule is emulated in `tests/test_torch_decode_q8.py`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_mcp_tpu.kernels.attention as A
from llm_mcp_tpu_torch.kernels import attention as P

TOL = dict(atol=2e-5, rtol=2e-5)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _case(seed, Hkv, G, S, hd, packed):
    """A random fused cache (2 layers, 5 rows), queries, this step's K/V,
    lengths w = 0, 255, 256, S - 1 and S (parked), and permuted rows."""
    from llm_mcp_tpu.models.quant import pack_scales

    rng = np.random.default_rng(seed)
    L, B = 2, 5
    pay = rng.integers(-127, 128, (L, B, 2 * Hkv, S, hd), dtype=np.int8)
    s = (rng.random((L, B, 2 * Hkv, S), dtype=np.float32) * 0.02).astype(np.float32)
    if packed:
        pay = np.concatenate([pay, np.asarray(pack_scales(jnp.asarray(s), hd))], 2)
    q = rng.standard_normal((B, Hkv, G, hd)).astype(np.float32)
    nk = rng.standard_normal((B, Hkv, hd)).astype(np.float32)
    nv = rng.standard_normal((B, Hkv, hd)).astype(np.float32)
    lens = np.asarray([0, 255, 256, S - 1, S], np.int32)
    ids = rng.permutation(B).astype(np.int32)
    return {"q": pay, "s": s}, q, nk, nv, lens, ids


def _both(monkeypatch, seed, Hkv, G, S, hd, packed):
    """(port, JAX) outputs of the public decode_attend_q8 on one case, the
    JAX side in interpret mode with its own arm choice."""
    monkeypatch.delenv("LLM_MCP_TPU_Q8_DECODE", raising=False)
    A.decode_attend_q8.clear_cache()  # the arm is read at trace time
    cache, q, nk, nv, lens, ids = _case(seed, Hkv, G, S, hd, packed)
    jout = np.asarray(A.decode_attend_q8(
        jnp.asarray(q), jnp.asarray(nk), jnp.asarray(nv),
        {k: jnp.asarray(v) for k, v in cache.items()}, {}, jnp.int32(1), jnp.asarray(lens),
        slot_ids=jnp.asarray(ids), interpret=True))
    tout = P.decode_attend_q8(_t(q), _t(nk), _t(nv), {k: _t(v) for k, v in cache.items()}, {},
                              1, _t(lens), slot_ids=_t(ids)).numpy()
    live = lens < S
    return tout[live], jout[live]


@pytest.mark.parametrize("packed", [True, False])
def test_decode_attend_q8_whole_row_matches_jax(monkeypatch, packed):
    """S = 1000 at hd 32, Hkv 2, G 4: no int8 block divides S and the row
    fits JAX's whole-S budget, so both sides requantize p over the whole
    attended row."""
    S, hd, Hkv, G = 1000, 32, 2, 4
    assert P.q8_group(S) == 0
    assert P.q8_decode_plan(S, hd, Hkv, Hkv * G)[0] == S
    assert P.decode_pallas_max_seq(hd, Hkv, Hkv * G, True) == A.decode_pallas_max_seq(
        hd, Hkv, Hkv * G, True)
    got, want = _both(monkeypatch, 1100 + packed, Hkv, G, S, hd, packed)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("S", [1000, 4072])
def test_decode_attend_q8_llama_widths_match_jax(monkeypatch, S, packed):
    """Llama-3.1-8B's widths (hd 128, Hkv 8, G 4; budget 2849 keys): S =
    1000 takes the whole row on both sides, S = 4072 the exact arm, JAX's
    f32 fallback."""
    hd, Hkv, G = 128, 8, 4
    budget = A.decode_pallas_max_seq(hd, Hkv, Hkv * G, quantized=True)
    assert P.decode_pallas_max_seq(hd, Hkv, Hkv * G, quantized=True) == budget == 2849
    assert P.q8_decode_plan(S, hd, Hkv, Hkv * G)[0] == (S if S <= budget else 0)
    got, want = _both(monkeypatch, 1200 + S + packed, Hkv, G, S, hd, packed)
    np.testing.assert_allclose(got, want, **TOL)


PROMPTS = [
    "user: hello there",
    "user: " + "the quick brown fox jumps over the lazy dog " * 2,  # > prefill_chunk
    "system: be brief\nuser: 2+2?",
]
ENGINE_KW = dict(max_slots=4, prefill_chunk=32, decode_chunk=4)


def _run_all(engine, make_req) -> list[list[int]]:
    """Submit PROMPTS at once; the greedy ids each request emitted."""
    seen: dict = {}
    orig = engine._process_token

    def rec(s, tok, pos):
        seen.setdefault(s.req.request_id, []).append(int(tok))
        return orig(s, tok, pos)

    engine._process_token = rec
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


def test_int8_engine_at_unaligned_seq_len_matches_jax(monkeypatch):
    """An int8-KV engine at max_seq_len = 1000 (no block size divides it:
    the contiguous cache; no int8 group either: the whole-row group) emits
    the JAX engine's greedy tokens on one shared int8 tree, three
    concurrent chats (one through ragged chunks)."""
    monkeypatch.setenv("LLM_MCP_TPU_ATTN", "pallas")
    monkeypatch.setenv("LLM_MCP_TPU_RAGGED_IMPL", "kernel")
    monkeypatch.delenv("LLM_MCP_TPU_Q8_DECODE", raising=False)
    A.decode_attend_q8.clear_cache()
    from llm_mcp_tpu.executor.engine import GenerationEngine as JaxEngine
    from llm_mcp_tpu.executor.engine import GenRequest as JaxRequest
    from llm_mcp_tpu.models.configs import get_config as jax_get_config
    from llm_mcp_tpu.models.quant import init_llama_params_quantized
    from llm_mcp_tpu_torch.executor import GenerationEngine, GenRequest
    from llm_mcp_tpu_torch.models.configs import get_config
    from llm_mcp_tpu_torch.models.weights import params_from_numpy

    jparams = init_llama_params_quantized(
        jax_get_config("tiny-llm"), jax.random.PRNGKey(0), scale_dtype=jnp.float32)
    tparams = params_from_numpy(
        jax.tree.map(np.asarray, jparams), get_config("tiny-llm"), "cpu", torch.float32)
    kw = dict(ENGINE_KW, max_seq_len=1000, quant="int8", kv_quant="int8", prompt_cache_mb=0)
    jeng = JaxEngine("tiny-llm", params=jparams, dtype=jnp.float32, **kw).start()
    try:
        want = _run_all(
            jeng, lambda ids: JaxRequest(prompt_ids=ids, max_tokens=12, temperature=0.0))
    finally:
        jeng.shutdown()
    teng = GenerationEngine("tiny-llm", params=tparams, dtype=torch.float32, device="cpu",
                            **kw).start()
    try:
        S = teng._ck["q"].shape[3]
        cfg = teng.cfg
        assert S == 1000 and teng._phys is None
        assert P.q8_decode_plan(S, cfg.resolved_head_dim, cfg.n_kv_heads, cfg.n_heads)[0] == S
        got = _run_all(
            teng, lambda ids: GenRequest(prompt_ids=ids, max_tokens=12, temperature=0.0))
    finally:
        teng.shutdown()
    assert [len(t) for t in got] == [12, 12, 12]
    assert got == want
