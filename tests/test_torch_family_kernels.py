"""The kernel arms the decoder families add, plain versions against the
Pallas bodies in interpret mode (as `tests/test_torch_kernels.py`).

  - flash prefill at head_dim 256 (Gemma-2's width) with a sliding window
    (one key, several tiles, past S), the score softcap 50 and the scale
    224**-0.5, G = 1, 2 and 4, rows of full, partial and zero length;
  - ragged prefill, bf16 and int8, identity and block tables, at G = 6 and
    7 query heads a KV head (R1-Distill-Qwen-1.5B's and Qwen2.5-7B's),
    which do not divide the CUDA tile's 64 rows; a head count that fits
    the CPU (one KV head).

In f32, atol = rtol = 2e-5, as the other kernel tests. The CUDA arms run
on the card only (`tests/test_torch_cuda.py`, `chip_smoke.py`).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import llm_mcp_tpu.kernels.attention as A
from llm_mcp_tpu_torch.kernels import attention as P

TOL = dict(atol=2e-5, rtol=2e-5)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


# (G, window, lengths): G = 2 is Gemma-2's; the CUDA kernel pairs heads
# 2j, 2j + 1 there and, at odd G, two 64-row query tiles of one head;
# lengths on and beside its 64- and 128-row edges, windows of one key and
# past S, rows of length 0
HD256_CASES = [
    (2, 0, [256, 130]), (2, 100, [256, 200]), (2, 64, [0, 97]),
    (1, 0, [1, 63]), (1, 1, [64, 65]), (1, 300, [127, 0]),
    (2, 1, [128, 129]), (2, 256, [63, 64]),
    (4, 0, [65, 127]), (4, 1, [129, 1]), (4, 300, [128, 0]),
]


@pytest.mark.parametrize("G,window,lens", HD256_CASES)
def test_flash_prefill_hd256_matches_pallas(G, window, lens):
    rng = np.random.default_rng(5)
    B, Hkv, S, hd = 2, 2, 256, 256
    H = Hkv * G
    q = rng.standard_normal((B, H, S, hd)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, hd)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, hd)).astype(np.float32)
    ln = np.asarray(lens, np.int32)
    kw = dict(window=window, softcap=50.0, scale=224.0**-0.5)
    out_j = np.asarray(A.flash_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ln), interpret=True, **kw))
    out_t = P.flash_prefill_attention(_t(q), _t(k), _t(v), _t(ln), **kw).numpy()
    np.testing.assert_allclose(out_t, out_j, **TOL)
    if 0 in lens:  # a row with no valid key emits 0
        assert not out_t[lens.index(0)].any()


def _ragged_case(rng, G, paged, bt=32):
    """Three descriptor rows (one empty) and pads; slot 4's prefix partly
    through pool rows and slot 2's arena home with `paged`."""
    L, B, Hkv, hd, S, pxb = 2, 6, 1, 64, 128, 4
    R, T = 3, 32
    lens = [10, 0, 15]
    offsets = np.zeros(R + 1, np.int32)
    offsets[1:] = np.cumsum(lens)
    rowids = np.concatenate([np.full(n, r, np.int32) for r, n in enumerate(lens)]
                            + [np.full(T - sum(lens), R, np.int32)])
    starts = np.asarray([77, 0, 40], np.int32)
    slots = np.asarray([4, 2, 0], np.int32)
    tbl = None
    if paged:
        nbs = S // bt
        tbl = np.arange(B * nbs, dtype=np.int32).reshape(B, nbs)
        tbl[4, 0], tbl[4, 1], tbl[0, 1] = B * nbs + 1, 2 * nbs + 1, B * nbs + 3
    q = rng.standard_normal((T, Hkv, G, hd)).astype(np.float32)
    ks = rng.standard_normal((T, Hkv, hd)).astype(np.float32)
    vs = rng.standard_normal((T, Hkv, hd)).astype(np.float32)
    return dict(L=L, B=B, Hkv=Hkv, hd=hd, S=S, pxb=pxb, bt=bt, q=q, ks=ks, vs=vs,
                rowids=rowids, offsets=offsets, slots=slots, starts=starts, tbl=tbl)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("G", [6, 7])
def test_ragged_prefill_g_not_dividing_64_matches_pallas(G, paged):
    rng = np.random.default_rng(40 + G)
    c = _ragged_case(rng, G, paged)
    shape = (c["L"], c["B"], c["Hkv"], c["S"], c["hd"])
    ck = rng.standard_normal(shape).astype(np.float32)
    cv = rng.standard_normal(shape).astype(np.float32)
    sc = c["hd"] ** -0.5
    jkw, tkw = {}, {}
    if paged:
        pshape = (c["L"], c["pxb"], c["Hkv"], c["bt"], c["hd"])
        pk = rng.standard_normal(pshape).astype(np.float32)
        pv = rng.standard_normal(pshape).astype(np.float32)
        jkw = dict(block_tables=jnp.asarray(c["tbl"]), pool_k=jnp.asarray(pk),
                   pool_v=jnp.asarray(pv))
        tkw = dict(block_tables=_t(c["tbl"]), pool_k=_t(pk), pool_v=_t(pv))
    out_j = np.asarray(A.ragged_prefill_attend_bf16(
        jnp.asarray(c["q"]), jnp.asarray(c["ks"]), jnp.asarray(c["vs"]), jnp.asarray(ck),
        jnp.asarray(cv), 1, jnp.asarray(c["rowids"]), jnp.asarray(c["offsets"]),
        jnp.asarray(c["slots"]), jnp.asarray(c["starts"]), scale=sc, impl="kernel",
        interpret=True, block_q=16, **jkw))
    out_t = P.ragged_prefill_attend_bf16(
        _t(c["q"]), _t(c["ks"]), _t(c["vs"]), _t(ck), _t(cv), 1, _t(c["rowids"]),
        _t(c["offsets"]), _t(c["slots"]), _t(c["starts"]), scale=sc, **tkw).numpy()
    np.testing.assert_allclose(out_t, out_j, **TOL)


def _fused_q8(rng, shape_pay) -> dict:
    """A fused int8 cache (numpy) with its packed pseudo-head."""
    from llm_mcp_tpu.models.quant import pack_scales

    pay = rng.integers(-127, 128, shape_pay, dtype=np.int8)
    s = (rng.random(shape_pay[:4], dtype=np.float32) * 0.02).astype(np.float32)
    pay = np.concatenate([pay, np.asarray(pack_scales(jnp.asarray(s), pay.shape[-1]))], 2)
    return {"q": pay, "s": s}


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("G", [6, 7])
def test_ragged_prefill_q8_g_not_dividing_64_matches_pallas(G, paged):
    rng = np.random.default_rng(50 + G)
    c = _ragged_case(rng, G, paged)
    cache = _fused_q8(rng, (c["L"], c["B"], 2 * c["Hkv"], c["S"], c["hd"]))
    jkw, tkw = {}, {}
    if paged:
        pool = _fused_q8(rng, (c["L"], c["pxb"], 2 * c["Hkv"], c["bt"], c["hd"]))
        jkw = dict(block_tables=jnp.asarray(c["tbl"]),
                   pool={k: jnp.asarray(v) for k, v in pool.items()})
        tkw = dict(block_tables=_t(c["tbl"]), pool={k: _t(v) for k, v in pool.items()})
    out_j = np.asarray(A.ragged_prefill_attend_q8(
        jnp.asarray(c["q"]), jnp.asarray(c["ks"]), jnp.asarray(c["vs"]),
        {k: jnp.asarray(v) for k, v in cache.items()}, 1, jnp.asarray(c["rowids"]),
        jnp.asarray(c["offsets"]), jnp.asarray(c["slots"]), jnp.asarray(c["starts"]),
        impl="kernel", interpret=True, block_q=16, **jkw))
    out_t = P.ragged_prefill_attend_q8(
        _t(c["q"]), _t(c["ks"]), _t(c["vs"]), {k: _t(v) for k, v in cache.items()}, 1,
        _t(c["rowids"]), _t(c["offsets"]), _t(c["slots"]), _t(c["starts"]), **tkw).numpy()
    np.testing.assert_allclose(out_t, out_j, **TOL)
