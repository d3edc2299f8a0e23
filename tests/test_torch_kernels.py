"""Parity of the port's attention kernels with the JAX package's Pallas
kernels.

Inputs are made with numpy from a seed and fed to both sides. The JAX side
runs its Pallas kernels in interpret mode, as `tests/test_kernel_parity.py`
does (`interpret=True`, `impl="kernel"` for ragged prefill, the decode arm
forced with `LLM_MCP_TPU_BF16_DECODE`, `paged` for the block-table arm).
On the CPU the port's wrappers take
their plain PyTorch versions, which is what is compared here, in f32:

  - append and `paged_gather`: bitwise (copies); the int8 append bitwise
    too, payload, packed pseudo-head and scales;
  - attention: atol = rtol = 2e-5, the summation order differing (the
    Pallas kernels fold key blocks with an online softmax, the plain
    versions take one softmax over the whole row);
  - int8 decode: atol 2e-3 (Q8_TOL) on unit-scale inputs, against the
    Pallas arm with the same requantization group (`whole`: S, `blocked`:
    256, `paged`: bt, forced with `LLM_MCP_TPU_Q8_DECODE`). Both quantize
    p to int8; where their exp or the order of a max differs in the last
    bit a probability can round to the neighbouring int8 step, which moves
    an output by about psc * |v| / l. The measured worst case is in
    PERF.md; and within JAX's own 0.05 of its exact f32 fallback.

The CUDA kernels themselves run only on the card: `tests/test_torch_cuda.py`
holds each against its plain version there, in bf16.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import llm_mcp_tpu.kernels.attention as A
from llm_mcp_tpu_torch.kernels import attention as P

TOL = dict(atol=2e-5, rtol=2e-5)
Q8_TOL = dict(atol=2e-3, rtol=0)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


# -- append ------------------------------------------------------------------


@pytest.mark.parametrize("with_ids", [True, False])
def test_append_kv_bitwise(with_ids):
    rng = np.random.default_rng(15)
    L, B, Hkv, S, hd = 2, 3, 2, 32, 128  # hd=128 runs the Pallas body
    ck = rng.standard_normal((L, B, Hkv, S, hd)).astype(np.float32)
    cv = rng.standard_normal((L, B, Hkv, S, hd)).astype(np.float32)
    nk = rng.standard_normal((L, B, Hkv, hd)).astype(np.float32)
    nv = rng.standard_normal((L, B, Hkv, hd)).astype(np.float32)
    lens = np.asarray([15, S, 16], np.int32)  # tile boundary + parked row
    ids = np.asarray([1, 2, 0], np.int32) if with_ids else None
    jk, jv = A.append_kv_bf16(
        jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(nk), jnp.asarray(nv),
        jnp.asarray(lens), slot_ids=None if ids is None else jnp.asarray(ids),
        interpret=True,
    )
    tk, tv = _t(ck), _t(cv)
    P.append_kv_bf16(
        tk, tv, _t(nk), _t(nv), _t(lens), slot_ids=None if ids is None else _t(ids)
    )
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# -- decode ------------------------------------------------------------------


@pytest.mark.parametrize("arm", ["whole", "blocked"])
@pytest.mark.parametrize("case", ["mixed", "boundaries"])
def test_decode_attend_matches_pallas(monkeypatch, arm, case):
    monkeypatch.setenv("LLM_MCP_TPU_BF16_DECODE", arm)
    A.decode_attend_bf16.clear_cache()  # the arm is read at trace time
    rng = np.random.default_rng(7)
    L, B, Hkv, G, S, hd = 2, 5, 2, 4, 256, 128
    ck = rng.standard_normal((L, B, Hkv, S, hd)).astype(np.float32)
    cv = rng.standard_normal((L, B, Hkv, S, hd)).astype(np.float32)
    q = rng.standard_normal((B, Hkv, G, hd)).astype(np.float32)
    nk = rng.standard_normal((B, Hkv, hd)).astype(np.float32)
    nv = rng.standard_normal((B, Hkv, hd)).astype(np.float32)
    if case == "mixed":  # empty row, mid row, full row, parked row, short
        lens = np.asarray([0, 100, S - 1, S, 3], np.int32)
    else:  # block-boundary fills of the blocked arm (BS = 256 / 128 / 64)
        lens = np.asarray([63, 64, 127, 128, 255], np.int32)
    ids = np.asarray([3, 0, 4, 1, 2], np.int32)  # permuted cache rows
    scale = 0.07
    out_j = np.asarray(A.decode_attend_bf16(
        jnp.asarray(q), jnp.asarray(nk), jnp.asarray(nv), jnp.asarray(ck),
        jnp.asarray(cv), jnp.int32(1), jnp.asarray(lens), slot_ids=jnp.asarray(ids),
        scale=scale, interpret=True,
    ))
    out_t = P.decode_attend_bf16(
        _t(q), _t(nk), _t(nv), _t(ck), _t(cv), 1, _t(lens), slot_ids=_t(ids), scale=scale
    ).numpy()
    live = lens < S
    np.testing.assert_allclose(out_t[live], out_j[live], **TOL)
    # a parked row's output is ignored by the engine: finite is the contract
    assert np.isfinite(out_t).all()


# -- decode_attention (post-append) -----------------------------------------


@pytest.mark.parametrize("G", [1, 2, 4])
def test_decode_attention_matches_pallas(G):
    """The post-append decode (`_decode_attn_kernel`): the inclusive mask at
    length 0, mid-row and S - 1; lengths >= S attend all S; lengths -1 mask
    every key with the finite -1e30, so the row is the mean of V over S."""
    rng = np.random.default_rng(40 + G)
    B, Hkv, S, hd = 5, 2, 96, 128
    q = rng.standard_normal((B, Hkv, G, hd)).astype(np.float32)
    ck = rng.standard_normal((B, Hkv, S, hd)).astype(np.float32)
    cv = rng.standard_normal((B, Hkv, S, hd)).astype(np.float32)
    lens = np.asarray([0, 41, S - 1, S + 3, -1], np.int32)
    out_j = np.asarray(A.decode_attention(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(lens), interpret=True))
    out_t = P.decode_attention(_t(q), _t(ck), _t(cv), _t(lens)).numpy()
    np.testing.assert_allclose(out_t, out_j, **TOL)
    np.testing.assert_allclose(out_t[4], np.broadcast_to(cv[4].mean(1)[:, None], (Hkv, G, hd)),
                               **TOL)


# -- paged decode ------------------------------------------------------------
#
# The construction of `tests/test_kernel_parity.py` (`_paged_split`,
# `_paged_tables`): blocks [0, nshared) of every slot share one content,
# one copy of them goes to the pool, the tables point there, and the arena's
# donor blocks are scrambled. One more block resolves to a foreign arena
# home (another slot's row), its own home scrambled. A read that goes to
# the arena where the table says pool (or to its own home) then fails.


def _paged_case(rng, L, B, H, S, hd, bt, nshared):
    """(ref, arena, pool) for K or V, and the tables: `ref` is the
    contiguous cache the paged read must reproduce."""
    nbs = S // bt
    x = rng.standard_normal((L, B, H, S, hd)).astype(np.float32)
    for j in range(nshared):
        x[:, :, :, j * bt:(j + 1) * bt] = x[:, :1, :, j * bt:(j + 1) * bt]
    tbl = np.arange(B * nbs, dtype=np.int32).reshape(B, nbs)
    tbl[:, :nshared] = B * nbs + np.arange(nshared, dtype=np.int32)
    pool = np.zeros((L, nbs, H, bt, hd), np.float32)
    for j in range(nshared):
        pool[:, j] = x[:, 0, :, j * bt:(j + 1) * bt]
    if nshared < nbs:  # slot 1's block nshared lives in slot 2's home
        j = nshared
        x[:, 1, :, j * bt:(j + 1) * bt] = x[:, 2, :, j * bt:(j + 1) * bt]
        tbl[1, j] = 2 * nbs + j
    ref = x.copy()
    for j in range(nshared):
        x[:, :, :, j * bt:(j + 1) * bt] = rng.standard_normal(x[:, :, :, j * bt:(j + 1) * bt].shape)
    if nshared < nbs:
        x[:, 1, :, nshared * bt:(nshared + 1) * bt] = rng.standard_normal((L, H, bt, hd))
    return ref, x, pool, tbl


@pytest.mark.parametrize("bt", [32, 64])
@pytest.mark.parametrize("fill", [0.4, 0.9])
def test_decode_attend_paged_matches_pallas(monkeypatch, fill, bt):
    monkeypatch.setenv("LLM_MCP_TPU_BF16_DECODE", "paged")
    A.decode_attend_bf16.clear_cache()  # the arm is read at trace time
    rng = np.random.default_rng(22)
    L, B, Hkv, G, S, hd = 2, 3, 2, 2, 256, 64
    nshared = min(S // bt, round(fill * S / bt))
    ref_k, ck, pk, tbl = _paged_case(rng, L, B, Hkv, S, hd, bt, nshared)
    ref_v, cv, pv, _ = _paged_case(rng, L, B, Hkv, S, hd, bt, nshared)
    q = rng.standard_normal((B, Hkv, G, hd)).astype(np.float32)
    nk = rng.standard_normal((B, Hkv, hd)).astype(np.float32)
    nv = rng.standard_normal((B, Hkv, hd)).astype(np.float32)
    base = int(fill * (S - 2))
    lens = ((base + rng.integers(0, S // 8, B)) % (S - 1)).astype(np.int32)
    ids = rng.permutation(B).astype(np.int32)
    out_j = np.asarray(A.decode_attend_bf16(
        jnp.asarray(q), jnp.asarray(nk), jnp.asarray(nv), jnp.asarray(ck), jnp.asarray(cv),
        jnp.int32(1), jnp.asarray(lens), slot_ids=jnp.asarray(ids),
        block_tables=jnp.asarray(tbl), pool_k=jnp.asarray(pk), pool_v=jnp.asarray(pv),
        interpret=True,
    ))
    out_t = P.decode_attend_bf16(
        _t(q), _t(nk), _t(nv), _t(ck), _t(cv), 1, _t(lens), slot_ids=_t(ids),
        block_tables=_t(tbl), pool_k=_t(pk), pool_v=_t(pv),
    ).numpy()
    np.testing.assert_allclose(out_t, out_j, **TOL)
    # and the contiguous reference the tables stand for
    want = P.decode_attend_plain(_t(q), _t(nk), _t(nv), _t(ref_k), _t(ref_v), 1, _t(lens), _t(ids))
    np.testing.assert_allclose(out_t, want.numpy(), **TOL)


def test_paged_gather_bitwise_matches_jax():
    rng = np.random.default_rng(24)
    B, H, S, hd, bt = 3, 2, 256, 16, 64
    nbs = S // bt
    arena = rng.standard_normal((B, H, S, hd)).astype(np.float32)
    pool = rng.standard_normal((5, H, bt, hd)).astype(np.float32)
    tbl = rng.integers(0, B * nbs + 5, (4, nbs)).astype(np.int32)  # arena and pool ids
    got = P.paged_gather(_t(arena), _t(pool), _t(tbl)).numpy()
    want = np.asarray(A.paged_gather(jnp.asarray(arena), jnp.asarray(pool), jnp.asarray(tbl)))
    np.testing.assert_array_equal(got, want)
    # a table prefix, with nbs naming the full blocks per slot
    got = P.paged_gather(_t(arena), _t(pool), _t(tbl[:, :2]), nbs=nbs).numpy()
    want = np.asarray(A.paged_gather(
        jnp.asarray(arena), jnp.asarray(pool), jnp.asarray(tbl[:, :2]), nbs=nbs))
    np.testing.assert_array_equal(got, want)


# -- flash prefill -------------------------------------------------------------


@pytest.mark.parametrize(
    "S,lens,window,softcap,scale",
    [
        (64, [0, 37, 64], 0, 0.0, 0.0),  # empty, partial, full rows
        (64, [5, 64, 50], 16, 0.0, 0.0),  # sliding window
        (64, [64, 1, 33], 0, 30.0, 0.2),  # softcap + scale override
        (256, [128, 129, 200], 0, 0.0, 0.0),  # block-boundary fills
    ],
)
def test_flash_prefill_matches_pallas(S, lens, window, softcap, scale):
    rng = np.random.default_rng(3)
    B, H, Hkv, hd = 3, 4, 2, 64
    q = rng.standard_normal((B, H, S, hd)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, hd)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, hd)).astype(np.float32)
    ln = np.asarray(lens, np.int32)
    out_j = np.asarray(A.flash_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ln),
        window=window, softcap=softcap, scale=scale, interpret=True,
    ))
    out_t = P.flash_prefill_attention(
        _t(q), _t(k), _t(v), _t(ln), window=window, softcap=softcap, scale=scale
    ).numpy()
    np.testing.assert_allclose(out_t, out_j, **TOL)
    if 0 in lens:  # rows with no valid key emit exactly 0, not NaN
        assert not out_t[lens.index(0)].any()


# -- ragged prefill ------------------------------------------------------------


@pytest.mark.parametrize("fill", [0.0, 0.3, 0.9])
def test_ragged_prefill_matches_pallas(fill):
    rng = np.random.default_rng(31)
    L, B, Hkv, G, hd, S = 2, 6, 2, 2, 64, 128
    R, T = 3, 32
    lens = [10, 0, 14]  # row 1 empty; 24 real tokens < T: remainder pads
    total = sum(lens)
    offsets = np.zeros(R + 1, np.int32)
    offsets[1:] = np.cumsum(lens)
    rowids = np.concatenate(
        [np.full(n, r, np.int32) for r, n in enumerate(lens)]
        + [np.full(T - total, R, np.int32)]
    )
    base = int(fill * (S - 16))
    # row 0: past inside a block; row 2: none at fill 0, else a deep past
    starts = np.asarray([base + 5, 0, base], np.int32)
    slots = np.asarray([4, 2, 0], np.int32)
    ck = rng.standard_normal((L, B, Hkv, S, hd)).astype(np.float32)
    cv = rng.standard_normal((L, B, Hkv, S, hd)).astype(np.float32)
    q = rng.standard_normal((T, Hkv, G, hd)).astype(np.float32)
    ks = rng.standard_normal((T, Hkv, hd)).astype(np.float32)
    vs = rng.standard_normal((T, Hkv, hd)).astype(np.float32)
    sc = hd**-0.5
    out_j = np.asarray(A.ragged_prefill_attend_bf16(
        jnp.asarray(q), jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(ck),
        jnp.asarray(cv), 1, jnp.asarray(rowids), jnp.asarray(offsets),
        jnp.asarray(slots), jnp.asarray(starts), scale=sc, impl="kernel",
        interpret=True, block_q=16,
    ))
    out_t = P.ragged_prefill_attend_bf16(
        _t(q), _t(ks), _t(vs), _t(ck), _t(cv), 1, _t(rowids), _t(offsets),
        _t(slots), _t(starts), scale=sc,
    ).numpy()
    np.testing.assert_allclose(out_t, out_j, **TOL)


@pytest.mark.parametrize("bt", [32, 64])
@pytest.mark.parametrize("fill", [0.4, 0.9])
def test_ragged_prefill_paged_matches_pallas(fill, bt):
    """The scrambled tables of `test_kernel_parity.py:_ragged_case`: slot
    4's prefix resolves through pool rows and slot 2's arena home, slot 0's
    through a pool row and slot 5's home."""
    rng = np.random.default_rng(31)
    L, B, Hkv, G, hd, S, pxb = 2, 6, 2, 2, 64, 128, 4
    R, T = 3, 32
    lens = [10, 0, 14]  # row 1 empty; 24 real tokens < T: remainder pads
    total = sum(lens)
    offsets = np.zeros(R + 1, np.int32)
    offsets[1:] = np.cumsum(lens)
    rowids = np.concatenate(
        [np.full(n, r, np.int32) for r, n in enumerate(lens)]
        + [np.full(T - total, R, np.int32)]
    )
    base = int(fill * (S - 16))
    starts = np.asarray([base + 5, 0, max(1, base)], np.int32)
    slots = np.asarray([4, 2, 0], np.int32)
    nbs = S // bt
    tbl = np.arange(B * nbs, dtype=np.int32).reshape(B, nbs)
    tbl[4, 0] = B * nbs + 1
    tbl[4, 1] = 2 * nbs + 1
    if nbs > 2:
        tbl[4, 2] = B * nbs + 3
    tbl[0, 0] = B * nbs + 0
    tbl[0, 1] = 5 * nbs + 1
    ck = rng.standard_normal((L, B, Hkv, S, hd)).astype(np.float32)
    cv = rng.standard_normal((L, B, Hkv, S, hd)).astype(np.float32)
    pk = rng.standard_normal((L, pxb, Hkv, bt, hd)).astype(np.float32)
    pv = rng.standard_normal((L, pxb, Hkv, bt, hd)).astype(np.float32)
    q = rng.standard_normal((T, Hkv, G, hd)).astype(np.float32)
    ks = rng.standard_normal((T, Hkv, hd)).astype(np.float32)
    vs = rng.standard_normal((T, Hkv, hd)).astype(np.float32)
    sc = hd**-0.5
    out_j = np.asarray(A.ragged_prefill_attend_bf16(
        jnp.asarray(q), jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(ck),
        jnp.asarray(cv), 1, jnp.asarray(rowids), jnp.asarray(offsets),
        jnp.asarray(slots), jnp.asarray(starts), scale=sc, impl="kernel",
        interpret=True, block_q=16, block_tables=jnp.asarray(tbl),
        pool_k=jnp.asarray(pk), pool_v=jnp.asarray(pv),
    ))
    out_t = P.ragged_prefill_attend_bf16(
        _t(q), _t(ks), _t(vs), _t(ck), _t(cv), 1, _t(rowids), _t(offsets),
        _t(slots), _t(starts), scale=sc, block_tables=_t(tbl), pool_k=_t(pk), pool_v=_t(pv),
    ).numpy()
    np.testing.assert_allclose(out_t, out_j, **TOL)


# -- int8 (fused cache) ------------------------------------------------------


def _fused_q8(pay: np.ndarray, s: np.ndarray, packed: bool) -> dict:
    """A fused cache {"q", "s"} (numpy) from K|V payload and scales, with the
    packed pseudo-head when `packed`."""
    from llm_mcp_tpu.models.quant import pack_scales

    if packed:
        pay = np.concatenate([pay, np.asarray(pack_scales(jnp.asarray(s), pay.shape[-1]))], 2)
    return {"q": pay, "s": s}


def _jq(c: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in c.items()}


def _tq(c: dict) -> dict:
    return {k: _t(v) for k, v in c.items()}


def _rand_q8(rng, shape_pay):
    pay = rng.integers(-127, 128, shape_pay, dtype=np.int8)
    s = (rng.random(shape_pay[:4], dtype=np.float32) * 0.02).astype(np.float32)  # as JAX's tests
    return pay, s


@pytest.mark.parametrize("scale_dtype", ["f32", "bf16"])
def test_append_kv_q8_bitwise(scale_dtype):
    """hd = 128, S = 128: JAX's kernel path (interpret mode). Payload heads,
    the packed pseudo-head and the plain scales, bit for bit, with a
    parked row and permuted slot_ids."""
    rng = np.random.default_rng(14)
    L, B, Hkv, S, hd = 2, 3, 2, 128, 128
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[
        scale_dtype]

    def both(x):  # the same values as a JAX array and a tensor of the scale dtype
        j = jnp.asarray(x).astype(jdt)
        return j, _t(np.asarray(j.astype(jnp.float32))).to(tdt)

    pay, s = _rand_q8(rng, (L, B, 2 * Hkv, S, hd))
    js, ts = both(s)
    cache = _fused_q8(pay, np.asarray(js.astype(jnp.float32)), packed=False)
    from llm_mcp_tpu.models.quant import pack_scales

    jc = {"q": jnp.concatenate([jnp.asarray(pay), pack_scales(js, hd)], 2), "s": js}
    tc = {"q": _t(np.asarray(jc["q"])), "s": ts}
    jk_new, tk_new = both(rng.standard_normal((L, B, Hkv, hd)))
    jv_new, tv_new = both(rng.standard_normal((L, B, Hkv, hd)))
    lens = np.asarray([0, S, 100], np.int32)  # row 1 parked: writes nothing
    ids = np.asarray([2, 0, 1], np.int32)
    jk, jv = A.append_kv_q8(jc, {}, jk_new, jv_new, jnp.asarray(lens),
                            slot_ids=jnp.asarray(ids), interpret=True)
    tk, tv = P.append_kv_q8(tc, {}, tk_new, tv_new, _t(lens), slot_ids=_t(ids))
    assert tk is tc and tv == jv == {}
    np.testing.assert_array_equal(tk["q"].numpy(), np.asarray(jk["q"]))
    np.testing.assert_array_equal(tk["s"].float().numpy(), np.asarray(jk["s"].astype(jnp.float32)))
    assert not np.array_equal(tk["q"][:, :, : 2 * Hkv].numpy(), cache["q"])  # rows were written


def _q8_decode_inputs(rng, B, Hkv, G, hd, S, fill):
    q = rng.standard_normal((B, Hkv, G, hd)).astype(np.float32)
    nk = rng.standard_normal((B, Hkv, hd)).astype(np.float32)
    nv = rng.standard_normal((B, Hkv, hd)).astype(np.float32)
    # fills scattered around the target, as tests/test_kernel_parity.py
    lens = ((int(fill * (S - 2)) + rng.integers(0, S // 8, B)) % (S - 1)).astype(np.int32)
    return q, nk, nv, lens


@pytest.mark.parametrize("fill", [0.0, 0.4, 0.9])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("arm,S", [("whole", 128), ("blocked", 512)])
def test_decode_attend_q8_matches_pallas(monkeypatch, arm, S, packed, fill):
    """The plain int8 decode (the wrapper's CPU path) against JAX's whole-S
    arm (group S = 128) and blocked arm (group 256 of S = 512), p = 1
    (packed pseudo-head) and p = 0 layouts, permuted cache rows."""
    monkeypatch.setenv("LLM_MCP_TPU_Q8_DECODE", arm)
    A.decode_attend_q8.clear_cache()  # the arm is read at trace time
    rng = np.random.default_rng(7)
    L, B, Hkv, G, hd = 2, 3, 2, 2, 32
    cache = _fused_q8(*_rand_q8(rng, (L, B, 2 * Hkv, S, hd)), packed)
    q, nk, nv, lens = _q8_decode_inputs(rng, B, Hkv, G, hd, S, fill)
    ids = rng.permutation(B).astype(np.int32)
    jargs = (jnp.asarray(q), jnp.asarray(nk), jnp.asarray(nv), _jq(cache), {}, jnp.int32(1),
             jnp.asarray(lens))
    out_j = np.asarray(A.decode_attend_q8(*jargs, slot_ids=jnp.asarray(ids), interpret=True))
    assert P.q8_group(S) == (S if arm == "whole" else 256)
    out_t = P.decode_attend_q8(_t(q), _t(nk), _t(nv), _tq(cache), {}, 1, _t(lens),
                               slot_ids=_t(ids)).numpy()
    np.testing.assert_allclose(out_t, out_j, **Q8_TOL)
    exact = np.asarray(A._decode_attend_q8_fallback(*jargs, hd**-0.5, jnp.asarray(ids)))
    assert np.abs(out_t - exact).max() < 0.05
    # `pytest -s -k q8` reads the measured errors (PERF.md quotes them)
    print(f"q8 decode {arm} packed={packed} fill={fill}: |port - pallas| "
          f"{np.abs(out_t - out_j).max():.3g}, |port - exact f32| {np.abs(out_t - exact).max():.3g}")


def _paged_case_q8(rng, L, B, Hkv, S, hd, bt, nshared, packed):
    """`_paged_case` for the fused cache: (ref, arena, pool, tables), with
    the shared blocks' arena donors and the foreign home's own block
    scrambled (payload and scales) after the pool copy."""
    nbs = S // bt
    pay, s = _rand_q8(rng, (L, B, 2 * Hkv, S, hd))
    for j in range(nshared):
        pay[:, :, :, j * bt:(j + 1) * bt] = pay[:, :1, :, j * bt:(j + 1) * bt]
        s[:, :, :, j * bt:(j + 1) * bt] = s[:, :1, :, j * bt:(j + 1) * bt]
    tbl = np.arange(B * nbs, dtype=np.int32).reshape(B, nbs)
    tbl[:, :nshared] = B * nbs + np.arange(nshared, dtype=np.int32)
    ppay = np.zeros((L, max(nshared, 1), 2 * Hkv, bt, hd), np.int8)
    ps = np.zeros((L, max(nshared, 1), 2 * Hkv, bt), np.float32)
    for j in range(nshared):
        ppay[:, j] = pay[:, 0, :, j * bt:(j + 1) * bt]
        ps[:, j] = s[:, 0, :, j * bt:(j + 1) * bt]
    if nshared < nbs:  # slot 1's block nshared lives in slot 2's home
        j = nshared
        pay[:, 1, :, j * bt:(j + 1) * bt] = pay[:, 2, :, j * bt:(j + 1) * bt]
        s[:, 1, :, j * bt:(j + 1) * bt] = s[:, 2, :, j * bt:(j + 1) * bt]
        tbl[1, j] = 2 * nbs + j
    ref = _fused_q8(pay.copy(), s.copy(), packed)
    scr = [(slice(None), slice(None), slice(None), slice(j * bt, (j + 1) * bt))
           for j in range(nshared)]
    if nshared < nbs:
        scr.append((slice(None), 1, slice(None), slice(nshared * bt, (nshared + 1) * bt)))
    for ix in scr:
        pay[ix] = rng.integers(-127, 128, pay[ix].shape, dtype=np.int8)
        s[ix] = rng.random(s[ix].shape, dtype=np.float32)
    return ref, _fused_q8(pay, s, packed), _fused_q8(ppay, ps, packed), tbl


@pytest.mark.parametrize("fill", [0.0, 0.4, 0.9])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("bt", [32, 64])
def test_decode_attend_q8_paged_matches_pallas(monkeypatch, bt, packed, fill):
    """The paged int8 decode against JAX's paged arm (group bt): scrambled
    arena donors under pool-resident blocks and a foreign arena home; also
    equal to the contiguous plain math (same group) on the rows the tables
    stand for."""
    monkeypatch.setenv("LLM_MCP_TPU_Q8_DECODE", "paged")
    A.decode_attend_q8.clear_cache()
    rng = np.random.default_rng(22)
    L, B, Hkv, G, S, hd = 2, 3, 2, 2, 256, 32
    nshared = min(S // bt, round(fill * S / bt))
    ref, arena, pool, tbl = _paged_case_q8(rng, L, B, Hkv, S, hd, bt, nshared, packed)
    q, nk, nv, lens = _q8_decode_inputs(rng, B, Hkv, G, hd, S, fill)
    ids = rng.permutation(B).astype(np.int32)
    out_j = np.asarray(A.decode_attend_q8(
        jnp.asarray(q), jnp.asarray(nk), jnp.asarray(nv), _jq(arena), {}, jnp.int32(1),
        jnp.asarray(lens), slot_ids=jnp.asarray(ids), block_tables=jnp.asarray(tbl),
        pool_k=_jq(pool), interpret=True,
    ))
    out_t = P.decode_attend_q8(
        _t(q), _t(nk), _t(nv), _tq(arena), {}, 1, _t(lens), slot_ids=_t(ids),
        block_tables=_t(tbl), pool_k=_tq(pool),
    ).numpy()
    np.testing.assert_allclose(out_t, out_j, **Q8_TOL)
    want = P.decode_attend_q8_plain(_t(q), _t(nk), _t(nv), _tq(ref), 1, _t(lens), _t(ids),
                                    group=bt).numpy()
    np.testing.assert_allclose(out_t, want, **TOL)
    exact = np.asarray(A._decode_attend_q8_fallback(
        jnp.asarray(q), jnp.asarray(nk), jnp.asarray(nv), _jq(ref), {}, jnp.int32(1),
        jnp.asarray(lens), hd**-0.5, jnp.asarray(ids)))
    assert np.abs(out_t - exact).max() < 0.05
    print(f"q8 decode paged bt={bt} packed={packed} fill={fill}: |port - pallas| "
          f"{np.abs(out_t - out_j).max():.3g}, |port - exact f32| {np.abs(out_t - exact).max():.3g}")


def _ragged_layout(R, T, lens):
    total = sum(lens)
    offsets = np.zeros(R + 1, np.int32)
    offsets[1:] = np.cumsum(lens)
    rowids = np.concatenate([np.full(n, r, np.int32) for r, n in enumerate(lens)]
                            + [np.full(T - total, R, np.int32)])
    return offsets, rowids


@pytest.mark.parametrize("fill", [0.0, 0.3, 0.9])
def test_ragged_prefill_q8_matches_pallas(fill):
    rng = np.random.default_rng(31)
    L, B, Hkv, G, hd, S = 2, 6, 2, 2, 64, 128
    R, T = 3, 32
    offsets, rowids = _ragged_layout(R, T, [10, 0, 14])
    base = int(fill * (S - 16))
    starts = np.asarray([base + 5, 0, base], np.int32)
    slots = np.asarray([4, 2, 0], np.int32)
    cache = _fused_q8(*_rand_q8(rng, (L, B, 2 * Hkv, S, hd)), True)
    q = rng.standard_normal((T, Hkv, G, hd)).astype(np.float32)
    ks = rng.standard_normal((T, Hkv, hd)).astype(np.float32)
    vs = rng.standard_normal((T, Hkv, hd)).astype(np.float32)
    out_j = np.asarray(A.ragged_prefill_attend_q8(
        jnp.asarray(q), jnp.asarray(ks), jnp.asarray(vs), _jq(cache), 1, jnp.asarray(rowids),
        jnp.asarray(offsets), jnp.asarray(slots), jnp.asarray(starts), impl="kernel",
        interpret=True, block_q=16,
    ))
    out_t = P.ragged_prefill_attend_q8(
        _t(q), _t(ks), _t(vs), _tq(cache), 1, _t(rowids), _t(offsets), _t(slots), _t(starts),
    ).numpy()
    np.testing.assert_allclose(out_t, out_j, **TOL)


@pytest.mark.parametrize("bt", [32, 64])
@pytest.mark.parametrize("fill", [0.4, 0.9])
def test_ragged_prefill_q8_paged_matches_pallas(fill, bt):
    """The scrambled tables of the bf16 paged ragged test over the fused
    cache: payload and scales both come through the tables."""
    rng = np.random.default_rng(31)
    L, B, Hkv, G, hd, S, pxb = 2, 6, 2, 2, 64, 128, 4
    R, T = 3, 32
    offsets, rowids = _ragged_layout(R, T, [10, 0, 14])
    base = int(fill * (S - 16))
    starts = np.asarray([base + 5, 0, max(1, base)], np.int32)
    slots = np.asarray([4, 2, 0], np.int32)
    nbs = S // bt
    tbl = np.arange(B * nbs, dtype=np.int32).reshape(B, nbs)
    tbl[4, 0] = B * nbs + 1
    tbl[4, 1] = 2 * nbs + 1
    if nbs > 2:
        tbl[4, 2] = B * nbs + 3
    tbl[0, 0] = B * nbs + 0
    tbl[0, 1] = 5 * nbs + 1
    cache = _fused_q8(*_rand_q8(rng, (L, B, 2 * Hkv, S, hd)), True)
    pool = _fused_q8(*_rand_q8(rng, (L, pxb, 2 * Hkv, bt, hd)), True)
    q = rng.standard_normal((T, Hkv, G, hd)).astype(np.float32)
    ks = rng.standard_normal((T, Hkv, hd)).astype(np.float32)
    vs = rng.standard_normal((T, Hkv, hd)).astype(np.float32)
    out_j = np.asarray(A.ragged_prefill_attend_q8(
        jnp.asarray(q), jnp.asarray(ks), jnp.asarray(vs), _jq(cache), 1, jnp.asarray(rowids),
        jnp.asarray(offsets), jnp.asarray(slots), jnp.asarray(starts), impl="kernel",
        interpret=True, block_q=16, block_tables=jnp.asarray(tbl), pool=_jq(pool),
    ))
    out_t = P.ragged_prefill_attend_q8(
        _t(q), _t(ks), _t(vs), _tq(cache), 1, _t(rowids), _t(offsets), _t(slots), _t(starts),
        block_tables=_t(tbl), pool=_tq(pool),
    ).numpy()
    np.testing.assert_allclose(out_t, out_j, **TOL)
