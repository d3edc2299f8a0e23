"""The decode step's appends, folded into the decode kernels, on the CPU.

`llama_decode_step` no longer stacks the layers' K/V rows and appends them
after the last layer: each layer's `decode_attend_bf16` /
`decode_attend_q8` call takes `append=True` and leaves that layer's new row
in the cache (on the card from inside the decode kernel; here the wrapper
runs the plain attention, then the plain append of that one layer). Layer
li's rows are read by layer li's call alone, before its write, so the step
must give what the post-scan append gave. One step on `tiny-llm` (f32
cache, and int8 weights over the fused int8 cache), contiguous and through
tables with compaction (slot_ids), with rows at w = 0, at a split edge, at
S - 1 and parked:

  - the cache is bit for bit the cache of the same step with the appends
    taken out of the decode calls and done after the last layer by the
    standalone `append_kv_bf16` / `append_kv_q8` over the stacked K/V (the
    structure of JAX's step), and the logits are bit for bit that step's;
  - the cache is bit for bit JAX's public `append_kv_bf16` / `append_kv_q8`
    (interpret mode) on the same cache with those stacked K/V rows;
  - against JAX's `llama_decode_step` on the same converted params (the
    Pallas path in interpret mode): logits within LOGIT_TOL, the f32 cache
    within CACHE_TOL and the int8 cache by `test_torch_model.py`'s rule
    (tests/test_torch_model.py: the two frameworks' K/V differ in the last
    bits, so no cache is bitwise across them; the standalone appends are
    bitwise against JAX's on equal inputs, `test_torch_kernels.py`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_mcp_tpu.models import llama as JL
from llm_mcp_tpu.models.configs import get_config as jax_get_config
from llm_mcp_tpu_torch.kernels import attention as P
from llm_mcp_tpu_torch.models import llama as TL
from llm_mcp_tpu_torch.models.configs import get_config
from llm_mcp_tpu_torch.models.weights import params_from_numpy

LOGIT_TOL = dict(atol=1e-4, rtol=0)  # as tests/test_torch_model.py
CACHE_TOL = dict(atol=1e-5, rtol=0)
Q8_PAYLOAD_FRAC = 1e-3
B, S, BT = 6, 256, 32  # cache rows, length, block tokens of the tables


@pytest.fixture(scope="module")
def trees():
    from llm_mcp_tpu.models import quant as JQ

    jcfg, cfg = jax_get_config("tiny-llm"), get_config("tiny-llm")
    out = {}
    for quant, jp in (
        ("", JL.init_llama_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)),
        ("int8", JQ.fuse_layer_weights(JQ.init_llama_params_quantized(
            jcfg, jax.random.PRNGKey(0), scale_dtype=jnp.float32))),
    ):
        out[quant] = (jp, params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu",
                                            torch.float32))
    return jcfg, cfg, out


def _caches(rng, cfg, quantized, rows, tokens):
    """A random cache (numpy) of `rows` rows and `tokens` positions: f32
    K, V; or the fused int8 dict with a consistent pseudo-head."""
    from llm_mcp_tpu.models.quant import pack_scales

    L, Hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    if not quantized:
        shape = (L, rows, Hkv, tokens, hd)
        return (rng.standard_normal(shape).astype(np.float32),
                rng.standard_normal(shape).astype(np.float32))
    pay = rng.integers(-127, 128, (L, rows, 2 * Hkv, tokens, hd), dtype=np.int8)
    s = (rng.random((L, rows, 2 * Hkv, tokens), dtype=np.float32) * 0.02).astype(np.float32)
    pay = np.concatenate([pay, np.asarray(pack_scales(jnp.asarray(s), hd))], 2)
    return {"q": pay, "s": s}, {}


def _torch(x):
    if isinstance(x, dict):
        return {k: torch.from_numpy(np.array(v)) for k, v in x.items()}
    return torch.from_numpy(np.array(x))


def _jax(x):
    if isinstance(x, dict):
        return {k: jnp.asarray(v) for k, v in x.items()}
    return jnp.asarray(x)


def _step_post_scan(monkeypatch, cfg, params, ck, cv, tokens, lengths, ids, paged):
    """The step with JAX's structure: the decode calls append nothing, their
    K/V rows are kept, and one standalone append writes them all after the
    last layer. Returns (logits, ck, cv, the stacked K rows, V rows)."""
    quantized = isinstance(ck, dict)
    name = "decode_attend_q8" if quantized else "decode_attend_bf16"
    orig = getattr(TL, name)
    rows: dict[int, tuple] = {}

    def no_append(q, nk, nv, ck_, cv_, layer, lens, **kw):
        assert kw.pop("append") is True
        rows[int(layer)] = (nk, nv)
        return orig(q, nk, nv, ck_, cv_, layer, lens, **kw)

    monkeypatch.setattr(TL, name, no_append)
    try:
        logits, ck, cv = TL.llama_decode_step(cfg, params, ck, cv, tokens, lengths,
                                              slot_ids=ids, paged=paged)
    finally:
        monkeypatch.setattr(TL, name, orig)
    nk = torch.stack([rows[li][0] for li in range(cfg.n_layers)])
    nv = torch.stack([rows[li][1] for li in range(cfg.n_layers)])
    append = P.append_kv_q8 if quantized else P.append_kv_bf16
    append(ck, cv, nk, nv, lengths, slot_ids=ids)
    return logits, ck, cv, nk, nv


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("quant", ["", "int8"])
def test_decode_step_fused_append_matches_post_scan_and_jax(trees, monkeypatch, quant, paged):
    jcfg, cfg, by_quant = trees
    jparams, tparams = by_quant[quant]
    quantized = bool(quant)
    monkeypatch.setenv("LLM_MCP_TPU_BF16_DECODE", "paged" if paged else "auto")
    monkeypatch.setenv("LLM_MCP_TPU_Q8_DECODE", "paged" if paged else "auto")
    from llm_mcp_tpu.kernels.attention import decode_attend_bf16, decode_attend_q8

    decode_attend_bf16.clear_cache()  # the arm is read at trace time
    decode_attend_q8.clear_cache()
    rng = np.random.default_rng(20 + 2 * quantized + paged)
    ck, cv = _caches(rng, cfg, quantized, B, S)
    split = P.DECODE_CHUNK if quantized else P.DECODE_CHUNK_BF16
    lengths = np.asarray([0, split - 1, S - 1, S, split], np.int32)  # row 3 parked
    ids = np.asarray([4, 0, 5, 2, 1], np.int32)  # compacted rows
    tokens = rng.integers(3, 259, (len(ids),)).astype(np.int32)
    jpg = tpg = None
    if paged:
        nbs = S // BT
        pk, pv = _caches(rng, cfg, quantized, 3, BT)
        tbl = np.arange(B * nbs, dtype=np.int32).reshape(B, nbs)
        tbl[4, 0], tbl[4, 1] = B * nbs + 2, B * nbs + 0  # pool rows, out of order
        tbl[0, 0] = 3 * nbs + 2  # slot 3's home block 2
        jpg = {"tbl": _jax(tbl), "k": _jax(pk), "v": _jax(pv)}
        tpg = {"tbl": _torch(tbl), "k": _torch(pk), "v": _torch(pv)}
    t = torch.from_numpy
    tk, tv = _torch(ck), _torch(cv)
    logits, tk, tv = TL.llama_decode_step(cfg, tparams, tk, tv, t(tokens), t(lengths),
                                          slot_ids=t(ids), paged=tpg)
    pl, pk_, pv_, nk, nv = _step_post_scan(monkeypatch, cfg, tparams, _torch(ck), _torch(cv),
                                   t(tokens), t(lengths), t(ids), tpg)
    assert torch.equal(logits, pl)
    if quantized:
        assert tv == pv_ == {}
        for k in ("q", "s"):
            assert torch.equal(tk[k], pk_[k]), k
    else:
        assert torch.equal(tk, pk_) and torch.equal(tv, pv_)
    # the step wrote: each live row's position changed, the parked row's not
    li, b, w = 0, ids[0], lengths[0]
    before = ck["q"][li, b, :, w] if quantized else ck[li, b, :, w]
    after = (tk["q"] if quantized else tk)[li, b, :, w].numpy()
    assert not np.array_equal(before, after)

    # JAX's public append on the same cache with the port's own K/V rows:
    # the step's cache bit for bit
    from llm_mcp_tpu.kernels import attention as JA

    def rows(x):
        return jnp.asarray(x.float().numpy()).astype(
            jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32)

    ak, av = (JA.append_kv_q8 if quantized else JA.append_kv_bf16)(
        _jax(ck), _jax(cv), rows(nk), rows(nv), jnp.asarray(lengths),
        slot_ids=jnp.asarray(ids), interpret=True)
    for got, want in ((tk, ak), (tv, av)) if not quantized else ((tk["q"], ak["q"]),
                                                                   (tk["s"], ak["s"])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    jl, jk, jv = JL.llama_decode_step(
        jcfg, jparams, _jax(ck), _jax(cv), jnp.asarray(tokens), jnp.asarray(lengths),
        attn_impl="pallas", slot_ids=jnp.asarray(ids), paged=jpg)
    live = lengths < S  # a parked row's logits are discarded by the engine
    np.testing.assert_allclose(logits.numpy()[live], np.asarray(jl)[live], **LOGIT_TOL)
    if quantized:
        Hs = 2 * cfg.n_kv_heads
        d = np.abs(tk["q"].numpy().astype(np.int32)[:, :, :Hs]
                   - np.asarray(jk["q"]).astype(np.int32)[:, :, :Hs])
        assert d.max() <= 1 and (d > 0).mean() <= Q8_PAYLOAD_FRAC, (d.max(), (d > 0).mean())
        np.testing.assert_allclose(tk["s"].numpy(), np.asarray(jk["s"]), rtol=1e-6, atol=0)
        from llm_mcp_tpu_torch.models.quant import unpack_scales

        assert torch.equal(unpack_scales(tk["q"][:, :, Hs], Hs, tk["s"].dtype), tk["s"])
    else:
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **CACHE_TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **CACHE_TOL)
