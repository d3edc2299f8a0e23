"""Parity of the port's Llama decoder with the JAX package's on `tiny-llm`.

One JAX parameter tree (f32) goes through `params_from_numpy` to the port,
so both compute from the same weights; caches and tokens are made with
numpy. The JAX side runs its Pallas path in interpret mode
(`attn_impl="pallas"`, `LLM_MCP_TPU_RAGGED_IMPL=kernel`, and
`LLM_MCP_TPU_BF16_DECODE=paged` for the paged decode arm). The paged cases
give both sides the same `paged={"tbl", "k", "v"}` operand: tables whose
blocks resolve to pool rows and to another slot's arena home. Tolerances,
in f32: logits within 1e-4 absolute, updated caches within 1e-5.

The int8 cases share one JAX int8 tree (`init_llama_params_quantized`,
f32 scales, then `fuse_layer_weights`, as the single-device engine runs
it) and fused int8 caches (`LLM_MCP_TPU_Q8_DECODE=paged` for the paged
decode arm; the contiguous arm's whole-S group equals the port's at
S = 128). K/V differ between the two in the last bits (rope and the f32
epilogues round differently), so a quantized cache is compared as: int8
payload heads within 1 on at most Q8_PAYLOAD_FRAC of the elements, scales
(plain and unpacked from the pseudo-head) within 1e-6 relative; and the
port's pseudo-head unpacks to its own "s" bit for bit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_mcp_tpu.models import llama as JL
from llm_mcp_tpu.models.configs import get_config as jax_get_config
from llm_mcp_tpu_torch.models import llama as TL
from llm_mcp_tpu_torch.models.configs import get_config
from llm_mcp_tpu_torch.models.weights import params_from_numpy
from llm_mcp_tpu_torch.ops.rope import llama3_rope_frequencies, rope_tables

LOGIT_TOL = dict(atol=1e-4, rtol=0)
CACHE_TOL = dict(atol=1e-5, rtol=0)
Q8_PAYLOAD_FRAC = 1e-3


@pytest.fixture(scope="module")
def shared():
    jcfg = jax_get_config("tiny-llm")
    jparams = JL.init_llama_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jparams)
    cfg = get_config("tiny-llm")
    return jcfg, jparams, cfg, params_from_numpy(tree, cfg, "cpu", torch.float32), tree


def _cache(rng, cfg, B, S):
    shape = (cfg.n_layers, B, cfg.n_kv_heads, S, cfg.resolved_head_dim)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def test_llama_prefill_matches_jax(shared):
    jcfg, jparams, cfg, tparams, _ = shared
    rng = np.random.default_rng(0)
    B, S = 3, 32
    tokens = rng.integers(3, 259, (B, S)).astype(np.int32)
    lengths = np.asarray([32, 17, 1], np.int32)
    jl, jk, jv = JL.llama_prefill(
        jcfg, jparams, jnp.asarray(tokens), jnp.asarray(lengths), attn_impl="pallas"
    )
    tl, tk, tv = TL.llama_prefill(cfg, tparams, torch.from_numpy(tokens), torch.from_numpy(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **CACHE_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **CACHE_TOL)


def test_llama_prefill_length0_row_matches_jax(shared):
    """A length-0 row reads the last position, as JAX's take_along_axis at
    index -1 does (it wraps to S - 1)."""
    jcfg, jparams, cfg, tparams, _ = shared
    rng = np.random.default_rng(3)
    tokens = rng.integers(3, 259, (3, 32)).astype(np.int32)
    lengths = np.asarray([32, 0, 5], np.int32)
    jl, _, _ = JL.llama_prefill(
        jcfg, jparams, jnp.asarray(tokens), jnp.asarray(lengths), attn_impl="pallas"
    )
    tl, _, _ = TL.llama_prefill(cfg, tparams, torch.from_numpy(tokens), torch.from_numpy(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    # row 1 is position S - 1 of its (empty) row, not position 0
    at0, _, _ = TL.llama_prefill(cfg, tparams, torch.from_numpy(tokens[1:2]),
                                 torch.from_numpy(np.asarray([1], np.int32)))
    assert not np.allclose(tl.numpy()[1], at0.numpy()[0], atol=1e-3)


def test_llama_decode_step_matches_jax(shared):
    jcfg, jparams, cfg, tparams, _ = shared
    rng = np.random.default_rng(1)
    B, S = 4, 64
    ck, cv = _cache(rng, cfg, B, S)
    tokens = rng.integers(3, 259, (B,)).astype(np.int32)
    lengths = np.asarray([5, 31, S, 63], np.int32)  # row 2 parked
    jl, jk, jv = JL.llama_decode_step(
        jcfg, jparams, jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(tokens),
        jnp.asarray(lengths), attn_impl="pallas",
    )
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    tl, tk, tv = TL.llama_decode_step(
        cfg, tparams, tk, tv, torch.from_numpy(tokens), torch.from_numpy(lengths)
    )
    live = lengths < S  # a parked row's logits are discarded by the engine
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live], **LOGIT_TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **CACHE_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **CACHE_TOL)
    assert np.isfinite(tl.numpy()).all()


def test_llama_prefill_chunk_ragged_matches_jax(shared, monkeypatch):
    monkeypatch.setenv("LLM_MCP_TPU_RAGGED_IMPL", "kernel")
    jcfg, jparams, cfg, tparams, _ = shared
    rng = np.random.default_rng(2)
    B, S, R, T = 4, 128, 3, 32
    ck, cv = _cache(rng, cfg, B, S)
    lens = [12, 9, 0]  # row 2 unused; 21 real tokens, 11 pads
    starts = np.asarray([40, 0, 0], np.int32)  # a cached prefix, and none
    slots = np.asarray([2, 0, 3], np.int32)
    rowids = np.full(T, R, np.int32)
    positions = np.full(T, S, np.int32)
    last_idx = np.zeros(R, np.int32)
    off = 0
    for r, n in enumerate(lens):
        rowids[off: off + n] = r
        positions[off: off + n] = np.arange(starts[r], starts[r] + n)
        last_idx[r] = off + n - 1 if n else 0
        off += n
    tokens = rng.integers(3, 259, (T,)).astype(np.int32)
    args = (tokens, rowids, positions, slots, starts, last_idx)
    jl, jk, jv = JL.llama_prefill_chunk_ragged(
        jcfg, jparams, jnp.asarray(ck), jnp.asarray(cv), *map(jnp.asarray, args)
    )
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    tl, tk, tv = TL.llama_prefill_chunk_ragged(
        cfg, tparams, tk, tv, *map(torch.from_numpy, args)
    )
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], **LOGIT_TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **CACHE_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **CACHE_TOL)


def _paged_operand(rng, cfg, B, S, bt):
    """Tables [B, S/bt] with pool rows and a foreign arena home, and a
    random pool [L, 3, Hkv, bt, hd] for K and V (numpy)."""
    nbs = S // bt
    tbl = np.arange(B * nbs, dtype=np.int32).reshape(B, nbs)
    tbl[0, 0], tbl[0, 1] = B * nbs + 2, B * nbs + 0  # pool rows, out of order
    tbl[1, 0] = 3 * nbs + 2  # slot 3's home block 2
    tbl[2, 1] = B * nbs + 1
    shape = (cfg.n_layers, 3, cfg.n_kv_heads, bt, cfg.resolved_head_dim)
    return (tbl, rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def test_llama_decode_step_paged_matches_jax(shared, monkeypatch):
    monkeypatch.setenv("LLM_MCP_TPU_BF16_DECODE", "paged")
    from llm_mcp_tpu.kernels.attention import decode_attend_bf16

    decode_attend_bf16.clear_cache()  # the arm is read at trace time
    jcfg, jparams, cfg, tparams, _ = shared
    rng = np.random.default_rng(5)
    B, S, bt = 4, 128, 32
    ck, cv = _cache(rng, cfg, B, S)
    tbl, pk, pv = _paged_operand(rng, cfg, B, S, bt)
    tokens = rng.integers(3, 259, (B,)).astype(np.int32)
    lengths = np.asarray([70, 40, S, 100], np.int32)  # row 2 parked
    jl, jk, jv = JL.llama_decode_step(
        jcfg, jparams, jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(tokens),
        jnp.asarray(lengths), attn_impl="pallas",
        paged={"tbl": jnp.asarray(tbl), "k": jnp.asarray(pk), "v": jnp.asarray(pv)},
    )
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    t = torch.from_numpy
    tl, tk, tv = TL.llama_decode_step(
        cfg, tparams, tk, tv, t(tokens), t(lengths),
        paged={"tbl": t(tbl), "k": t(pk), "v": t(pv)},
    )
    live = lengths < S
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live], **LOGIT_TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **CACHE_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **CACHE_TOL)
    # the tables mattered: the same step over the bare arena differs
    flat, _, _ = TL.llama_decode_step(
        cfg, tparams, torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()),
        t(tokens), t(lengths))
    assert not np.allclose(flat.numpy()[:2], tl.numpy()[:2], atol=1e-3)


def test_llama_prefill_chunk_ragged_paged_matches_jax(shared, monkeypatch):
    monkeypatch.setenv("LLM_MCP_TPU_RAGGED_IMPL", "kernel")
    jcfg, jparams, cfg, tparams, _ = shared
    rng = np.random.default_rng(6)
    B, S, R, T, bt = 4, 128, 3, 32, 32
    ck, cv = _cache(rng, cfg, B, S)
    tbl, pk, pv = _paged_operand(rng, cfg, B, S, bt)
    lens = [12, 9, 0]  # row 2 unused
    starts = np.asarray([40, 33, 0], np.int32)  # prefixes through the tables
    slots = np.asarray([0, 1, 3], np.int32)
    rowids = np.full(T, R, np.int32)
    positions = np.full(T, S, np.int32)
    last_idx = np.zeros(R, np.int32)
    off = 0
    for r, n in enumerate(lens):
        rowids[off: off + n] = r
        positions[off: off + n] = np.arange(starts[r], starts[r] + n)
        last_idx[r] = off + n - 1 if n else 0
        off += n
    tokens = rng.integers(3, 259, (T,)).astype(np.int32)
    args = (tokens, rowids, positions, slots, starts, last_idx)
    jl, jk, jv = JL.llama_prefill_chunk_ragged(
        jcfg, jparams, jnp.asarray(ck), jnp.asarray(cv), *map(jnp.asarray, args),
        paged={"tbl": jnp.asarray(tbl), "k": jnp.asarray(pk), "v": jnp.asarray(pv)},
    )
    t = torch.from_numpy
    tk, tv = t(ck.copy()), t(cv.copy())
    tl, tk, tv = TL.llama_prefill_chunk_ragged(
        cfg, tparams, tk, tv, *map(t, args), paged={"tbl": t(tbl), "k": t(pk), "v": t(pv)},
    )
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], **LOGIT_TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **CACHE_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **CACHE_TOL)


def test_rope_llama3_matches_jax():
    from llm_mcp_tpu.models.configs import get_config as jcfg_of
    from llm_mcp_tpu.ops.rope import rope_tables as jax_rope_tables

    pos = np.arange(0, 8192, 37, dtype=np.int32)
    jc, js = jax_rope_tables(jcfg_of("llama-3.1-8b"), 128, jnp.asarray(pos))
    tc, ts = rope_tables(get_config("llama-3.1-8b"), 128, torch.from_numpy(pos))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5, rtol=0)
    c2, _ = llama3_rope_frequencies(128, 500_000.0, torch.from_numpy(pos), factor=8.0,
                                    orig_max=8192)
    assert c2.dtype == torch.float32


@pytest.mark.parametrize("name", ["llama-3.1-8b", "llama-3.2-1b", "tiny-llm"])
def test_configs_match_jax(name):
    from llm_mcp_tpu.models.configs import get_config as jcfg_of

    j, t = jcfg_of(name), get_config(name)
    for f in ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads", "ffn_hidden",
              "rope_theta", "norm_eps", "rope_factor", "rope_orig_max",
              "tie_embeddings", "resolved_head_dim", "attn_scale"):
        assert getattr(t, f) == getattr(j, f), f
    # the port computes the llama3 scaling with the default band factors
    assert (j.llama3_low_freq_factor, j.llama3_high_freq_factor) == (1.0, 4.0)
    if j.rope_factor > 1.0:
        assert j.rope_type == "llama3"


def test_params_from_numpy_checks_keys_and_shapes(shared):
    *_, cfg, _, tree = shared
    bad = dict(tree, layers=dict(tree["layers"], bq=np.zeros((2, 128), np.float32)))
    with pytest.raises(KeyError, match="bq"):
        params_from_numpy(bad, cfg)
    missing = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(KeyError, match="final_norm"):
        params_from_numpy(missing, cfg)
    wrong = dict(tree, embed=tree["embed"][:10])
    with pytest.raises(ValueError, match="embed"):
        params_from_numpy(wrong, cfg)


def test_sampling_matches_jax_greedy_and_gumbel():
    from llm_mcp_tpu.ops.sampling import sample_tokens as jax_sample
    from llm_mcp_tpu_torch.ops.sampling import sample_tokens

    rng = np.random.default_rng(4)
    B, V = 6, 300
    logits = rng.standard_normal((B, V)).astype(np.float32)
    logits[0, 7] = logits[0, 9] = 50.0  # a tie: first index wins
    zeros_i, ones_f = np.zeros(B, np.int32), np.ones(B, np.float32)
    greedy_j = np.asarray(jax_sample(
        jnp.asarray(logits), jax.random.PRNGKey(0), jnp.zeros(B), jnp.asarray(zeros_i),
        jnp.asarray(ones_f),
    ))
    t = torch.from_numpy
    greedy_t = sample_tokens(t(logits), None, torch.zeros(B), t(zeros_i), t(ones_f)).numpy()
    np.testing.assert_array_equal(greedy_t, greedy_j)
    assert greedy_t[0] == 7
    # plain temperature: Gumbel-argmax over the full vocabulary
    noise = rng.gumbel(size=(B, V)).astype(np.float32)
    temp = np.full(B, 0.7, np.float32)
    got = sample_tokens(t(logits), None, t(temp), t(zeros_i), t(ones_f), noise=t(noise))
    np.testing.assert_array_equal(got.numpy(), np.argmax(logits / 0.7 + noise, axis=-1))
    # mixed batch: greedy rows stay greedy, top-k rows stay in their top k
    topk = np.asarray([0, 3, 3, 1, 5, 2], np.int32)
    temp = np.asarray([0.0, 1.0, 1.0, 1.0, 1.0, 1.0], np.float32)
    g = torch.Generator().manual_seed(0)
    for _ in range(5):
        got = sample_tokens(t(logits), g, t(temp), t(topk), t(ones_f)).numpy()
        assert got[0] == 7
        for b in range(1, B):
            assert got[b] in np.argsort(-logits[b])[: topk[b]]


# -- int8 weights and the fused int8 cache -------------------------------------


@pytest.fixture(scope="module")
def shared_q8():
    from llm_mcp_tpu.models import quant as JQ

    jcfg = jax_get_config("tiny-llm")
    jparams = JQ.fuse_layer_weights(
        JQ.init_llama_params_quantized(jcfg, jax.random.PRNGKey(0), scale_dtype=jnp.float32))
    cfg = get_config("tiny-llm")
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, cfg, params_from_numpy(tree, cfg, "cpu", torch.float32)


def _fused_cache(rng, cfg, B, S, rows=None):
    """A random fused int8 cache (numpy) with a consistent pseudo-head."""
    from llm_mcp_tpu.models.quant import pack_scales

    L, Hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    pay = rng.integers(-127, 128, (L, B, 2 * Hkv, S, hd), dtype=np.int8)
    s = (rng.random((L, B, 2 * Hkv, S), dtype=np.float32) * 0.02).astype(np.float32)
    return {"q": np.concatenate([pay, np.asarray(pack_scales(jnp.asarray(s), hd))], 2), "s": s}


def _assert_q8_cache_close(got: dict, want: dict, cfg) -> None:
    from llm_mcp_tpu_torch.models.quant import unpack_scales

    Hs = 2 * cfg.n_kv_heads
    gq, wq = got["q"].numpy().astype(np.int32), np.asarray(want["q"]).astype(np.int32)
    d = np.abs(gq[:, :, :Hs] - wq[:, :, :Hs])
    assert d.max() <= 1 and (d > 0).mean() <= Q8_PAYLOAD_FRAC, (d.max(), (d > 0).mean())
    ws = np.asarray(want["s"])
    np.testing.assert_allclose(got["s"].numpy(), ws, rtol=1e-6, atol=0)
    packed = unpack_scales(got["q"][:, :, Hs], Hs, got["s"].dtype)
    assert torch.equal(packed, got["s"])
    np.testing.assert_allclose(
        unpack_scales(torch.from_numpy(np.array(want["q"])[:, :, Hs]), Hs, got["s"].dtype).numpy(),
        ws, rtol=1e-6, atol=0)


def test_llama_prefill_q8_matches_jax(shared_q8):
    jcfg, jparams, cfg, tparams = shared_q8
    rng = np.random.default_rng(10)
    tokens = rng.integers(3, 259, (3, 32)).astype(np.int32)
    lengths = np.asarray([32, 17, 1], np.int32)
    jl, jk, jv = JL.llama_prefill(jcfg, jparams, jnp.asarray(tokens), jnp.asarray(lengths),
                                  attn_impl="pallas", quant_kv=True)
    tl, tk, tv = TL.llama_prefill(cfg, tparams, torch.from_numpy(tokens),
                                  torch.from_numpy(lengths), quant_kv=True)
    assert tv == jv == {}
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _assert_q8_cache_close(tk, jk, cfg)


@pytest.mark.parametrize("paged", [False, True])
def test_llama_decode_step_q8_matches_jax(shared_q8, monkeypatch, paged):
    """`_decode_step_q8` through `llama_decode_step` on a fused cache:
    unpaged (JAX's whole-S arm, group S = 128 on both sides) and paged
    (JAX's paged arm, group bt = 32), with a parked row and compaction
    ids."""
    monkeypatch.setenv("LLM_MCP_TPU_Q8_DECODE", "paged" if paged else "auto")
    from llm_mcp_tpu.kernels.attention import decode_attend_q8

    decode_attend_q8.clear_cache()  # the arm is read at trace time
    jcfg, jparams, cfg, tparams = shared_q8
    rng = np.random.default_rng(11)
    B, S, bt = 4, 128, 32
    cache = _fused_cache(rng, cfg, B, S)
    tokens = rng.integers(3, 259, (3,)).astype(np.int32)
    lengths = np.asarray([70, S, 100], np.int32)  # row 1 parked
    ids = np.asarray([2, 3, 0], np.int32)
    jpg = tpg = None
    if paged:
        pool = _fused_cache(rng, cfg, 3, bt)
        tbl = np.arange(B * (S // bt), dtype=np.int32).reshape(B, S // bt)
        tbl[2, 0], tbl[2, 1] = B * (S // bt) + 2, B * (S // bt) + 0  # pool rows
        tbl[0, 0] = 3 * (S // bt) + 2  # slot 3's home block 2
        jpg = {"tbl": jnp.asarray(tbl), "k": {k: jnp.asarray(v) for k, v in pool.items()},
               "v": {}}
        tpg = {"tbl": torch.from_numpy(tbl), "k": {k: torch.from_numpy(v) for k, v in pool.items()},
               "v": {}}
    jl, jk, jv = JL.llama_decode_step(
        jcfg, jparams, {k: jnp.asarray(v) for k, v in cache.items()}, {}, jnp.asarray(tokens),
        jnp.asarray(lengths), attn_impl="pallas", slot_ids=jnp.asarray(ids), paged=jpg,
    )
    tc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    tl, tk, tv = TL.llama_decode_step(
        cfg, tparams, tc, {}, torch.from_numpy(tokens), torch.from_numpy(lengths),
        slot_ids=torch.from_numpy(ids), paged=tpg,
    )
    assert tk is tc and tv == jv == {}
    live = lengths < S
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live], **LOGIT_TOL)
    _assert_q8_cache_close(tk, jk, cfg)


@pytest.mark.parametrize("paged", [False, True])
def test_llama_prefill_chunk_ragged_q8_matches_jax(shared_q8, monkeypatch, paged):
    monkeypatch.setenv("LLM_MCP_TPU_RAGGED_IMPL", "kernel")
    jcfg, jparams, cfg, tparams = shared_q8
    rng = np.random.default_rng(12)
    B, S, R, T, bt = 4, 128, 3, 32, 32
    cache = _fused_cache(rng, cfg, B, S)
    lens = [12, 9, 0]
    starts = np.asarray([40, 33 if paged else 0, 0], np.int32)
    slots = np.asarray([0, 1, 3], np.int32)
    rowids = np.full(T, R, np.int32)
    positions = np.full(T, S, np.int32)
    last_idx = np.zeros(R, np.int32)
    off = 0
    for r, n in enumerate(lens):
        rowids[off: off + n] = r
        positions[off: off + n] = np.arange(starts[r], starts[r] + n)
        last_idx[r] = off + n - 1 if n else 0
        off += n
    tokens = rng.integers(3, 259, (T,)).astype(np.int32)
    args = (tokens, rowids, positions, slots, starts, last_idx)
    jpg = tpg = None
    if paged:
        pool = _fused_cache(rng, cfg, 3, bt)
        tbl = np.arange(B * (S // bt), dtype=np.int32).reshape(B, S // bt)
        tbl[0, 0], tbl[0, 1] = B * (S // bt) + 2, B * (S // bt) + 0
        tbl[1, 0] = 3 * (S // bt) + 2
        jpg = {"tbl": jnp.asarray(tbl), "k": {k: jnp.asarray(v) for k, v in pool.items()},
               "v": {}}
        tpg = {"tbl": torch.from_numpy(tbl), "k": {k: torch.from_numpy(v) for k, v in pool.items()},
               "v": {}}
    jl, jk, jv = JL.llama_prefill_chunk_ragged(
        jcfg, jparams, {k: jnp.asarray(v) for k, v in cache.items()}, {},
        *map(jnp.asarray, args), paged=jpg,
    )
    tc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    tl, tk, tv = TL.llama_prefill_chunk_ragged(
        cfg, tparams, tc, {}, *map(torch.from_numpy, args), paged=tpg,
    )
    assert tv == jv == {}
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], **LOGIT_TOL)
    _assert_q8_cache_close(tk, jk, cfg)
