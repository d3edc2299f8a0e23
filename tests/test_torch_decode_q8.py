"""The int8 GQA decode kernel's plan and schedule against the JAX package.

`decode_attend_q8` (`llm_mcp_tpu_torch/kernels/csrc/decode_attend.cu`)
splits a row into 256-key CTAs, gives each of four warps 64 keys in two
32-key copy stages, and exchanges each warp's max and each stage's max of
p * vss once a split, so that a requantization group's scale sees the whole
group however many warps or stages it spans; a whole-row group (JAX's
whole-S body, where no int8 block divides S) takes its scale from a score
pass over every split. The kernel runs only on the card
(`tests/test_torch_cuda.py`); here, on the CPU:

  - `q8_decode_plan` (group, split, splits) at every length and block size
    the engine serves, and its refusals;
  - the exact arm's plain version (`group = 0`, taken where no int8 group
    divides S and the row is past JAX's whole-S budget) against JAX's
    `_decode_attend_q8_fallback`, at 2e-5;
  - a float64 emulation of the kernel's schedule (splits, warps, stages,
    the exchange, the split max as reference, the merge in warp order,
    then the combine over splits; for the whole row the score pass's
    per-split maxima and the row max as every split's reference) against
    `decode_attend_q8_plain` and the Pallas bodies in interpret mode with
    the same group, at 2e-3 (Q8_TOL: a probability on a rounding edge can
    land on the neighbouring int8 step); and the same emulation with a
    scale taken over one warp's, one stage's or (whole row) one split's
    keys, which must miss the plain version.

Inputs are made with numpy from a seed and fed to both sides.
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
SPLIT, WARP_KEYS, STAGE = 256, 64, 32  # the kernel's split, keys a warp, keys a stage
INV127 = np.float32(1.0 / 127.0)
# (head_dim, Hkv, H) of published models: JAX's whole-S budget is 2849 keys
# at Llama-3.1-8B's, 744 at Llama-2-7B's (32 KV heads); 41391 at tiny-llm's
LLAMA31_8B, LLAMA2_7B, TINY = (128, 8, 32), (128, 32, 32), (32, 2, 4)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _case(seed, B, Hkv, G, S, hd, packed, lens):
    """Random fused cache (numpy payload and f32 scales, with the packed
    pseudo-head when `packed`), queries, this step's K/V, lengths and a
    permutation of the cache rows."""
    from llm_mcp_tpu.models.quant import pack_scales

    rng = np.random.default_rng(seed)
    L = 2
    pay = rng.integers(-127, 128, (L, B, 2 * Hkv, S, hd), dtype=np.int8)
    s = (rng.random((L, B, 2 * Hkv, S), dtype=np.float32) * 0.02).astype(np.float32)
    if packed:
        pay = np.concatenate([pay, np.asarray(pack_scales(jnp.asarray(s), hd))], 2)
    q = rng.standard_normal((B, Hkv, G, hd)).astype(np.float32)
    nk = rng.standard_normal((B, Hkv, hd)).astype(np.float32)
    nv = rng.standard_normal((B, Hkv, hd)).astype(np.float32)
    ids = rng.permutation(B).astype(np.int32)
    return {"q": pay, "s": s}, q, nk, nv, np.asarray(lens, np.int32), ids


def _port(cache, q, nk, nv, lens, ids, group, **kw):
    return P.decode_attend_q8_plain(_t(q), _t(nk), _t(nv), {k: _t(v) for k, v in cache.items()},
                                    1, _t(lens), _t(ids), 0.0, group, **kw).numpy()


# -- the plan ------------------------------------------------------------------


@pytest.mark.parametrize("bt", [32, 64, 128, 256])
@pytest.mark.parametrize("S", [1000, 4072, 4096])
def test_q8_decode_plan_serves_every_engine_length(monkeypatch, S, bt):
    """An int8 engine at max_seq_len S and TPU_KV_BLOCK_TOKENS = bt decodes
    through tables of bt-token blocks where bt divides S, else through the
    contiguous cache; the plan takes either (the card never refuses what
    the engine serves): group bt through tables; contiguous, JAX's group:
    `q8_group(S)` where an int8 block divides S, else the whole row where S
    fits JAX's whole-S budget at the model's widths (tiny-llm's at 1000 and
    4072; Llama-3.1-8B's at 1000), else 0, the exact arm (Llama-3.1-8B at
    4072)."""
    from llm_mcp_tpu_torch.executor import GenerationEngine

    monkeypatch.setenv("TPU_KV_BLOCK_TOKENS", str(bt))
    eng = GenerationEngine("tiny-llm", dtype=torch.float32, device="cpu", max_slots=2,
                           max_seq_len=S, prompt_cache_mb=1, quant="int8", kv_quant="int8")
    try:
        cfg = eng.cfg
        widths = (cfg.resolved_head_dim, cfg.n_kv_heads, cfg.n_heads)
        assert widths == TINY
        nbs = None if eng._phys is None else S // bt
        assert (nbs is not None) == (S % bt == 0)
        group, split, nsplit = P.q8_decode_plan(S, *widths, nbs)
        assert group == (bt if nbs else P.q8_contig_group(S, *widths))
        assert (split, nsplit) == (SPLIT, -(-S // SPLIT))
        assert group in (0, S) or split % group == 0
        if S != 4096:
            assert P.q8_decode_plan(S, *widths) == (S, SPLIT, -(-S // SPLIT))
            assert P.q8_decode_plan(S, *LLAMA31_8B) == (
                (S if S == 1000 else 0), SPLIT, -(-S // SPLIT))
    finally:
        eng.shutdown()


@pytest.mark.parametrize("S,nbs", [(4096, 256), (1008, 63), (4096, 8), (2048, 1)])
def test_q8_decode_plan_refuses_groups_it_cannot_split(S, nbs):
    """Tables of 16- or 48-token blocks, or of blocks past a split, would
    need a scale from part of a copy stage or a group wider than a split:
    refused, not approximated (JAX's `paged_ok` takes bt in {32, 64, 128,
    256} alone)."""
    with pytest.raises(ValueError, match="group"):
        P.q8_decode_plan(S, *LLAMA31_8B, nbs)


# -- the exact arm -------------------------------------------------------------


@pytest.mark.parametrize("packed", [True, False])
def test_decode_attend_q8_exact_group_matches_fallback(packed):
    """At S = 4072 at Llama-3.1-8B's widths (no int8 group divides S, and
    the row is past JAX's whole-S budget of 2849 keys) the wrapper's CPU
    path is the plain version with group 0, and that is JAX's exact f32
    fallback: q and p in f32, no requantization; a parked row is left out
    (its output is discarded)."""
    S = 4072
    hd, Hkv, H = LLAMA31_8B
    cache, q, nk, nv, lens, ids = _case(61 + packed, 5, Hkv, H // Hkv, S, hd, packed,
                                        [0, 255, 256, S - 1, S])
    assert P.q8_group(S) == 0 and S > A.decode_pallas_max_seq(hd, Hkv, H, quantized=True)
    assert P.q8_decode_plan(S, *LLAMA31_8B)[0] == 0
    jout = np.asarray(A._decode_attend_q8_fallback(
        jnp.asarray(q), jnp.asarray(nk), jnp.asarray(nv), {k: jnp.asarray(v) for k, v in
                                                           cache.items()}, {}, jnp.int32(1),
        jnp.asarray(lens), hd ** -0.5, jnp.asarray(ids)))
    tout = P.decode_attend_q8(_t(q), _t(nk), _t(nv), {k: _t(v) for k, v in cache.items()}, {},
                              1, _t(lens), slot_ids=_t(ids)).numpy()
    live = lens < S
    np.testing.assert_allclose(tout[live], jout[live], **TOL)
    np.testing.assert_allclose(tout, _port(cache, q, nk, nv, lens, ids, 0), atol=0, rtol=0)


# -- the schedule ----------------------------------------------------------------


def emulate_q8_schedule(cache, q, nk, nv, lens, ids, group, scale_from="group"):
    """The CUDA kernel's schedule in float64 (f32 inputs): per 256-key split
    its scores, each 64-key warp's max m and each 32-key stage's max a of
    e^(s - m) * vss off w; the split max M; each stage's group scale from
    the max of a e^(m - M) over the stages of its group (`scale_from`
    "warp": only those of its own warp; "stage": its own); p8 per stage
    with that scale, the integer products flushed per stage times psc and
    the warps' partials summed in order; p_w * new_v; then the splits
    combined as the combine kernel does. The whole row (group = S, not a
    multiple of the stage): the score pass's (m_j, a_j) of every split j
    first, then each split with the row max M = max m_j as its reference
    and psc from max a_j e^(m_j - M) over the row ("split": over its own
    split's stages only)."""
    Hkv = cache["s"].shape[2] // 2
    B, _, G, hd = q.shape
    pay = cache["q"][1][ids]
    ss = cache["s"][1][ids].astype(np.float64)
    S = pay.shape[2]
    k8, v8 = pay[:, :Hkv].astype(np.float64), pay[:, Hkv:2 * Hkv].astype(np.float64)
    scale = hd**-0.5
    row = group == S and S % STAGE != 0  # the whole-row arm
    out = np.zeros((B, Hkv, G, hd))
    for b in range(B):
        w = int(lens[b])
        we = w if 0 <= w < S else 0
        for h in range(Hkv):
            kss, vss = ss[b, h], ss[b, Hkv + h]
            qf = q[b, h].astype(np.float64)
            s_new = qf @ nk[b, h] * scale
            if group:
                qsc = np.maximum(np.abs(q[b, h]).max(-1) * INV127, np.float32(1e-30))
                qm = np.round(q[b, h] / qsc[:, None]).astype(np.float64)
            nw, nst = SPLIT // WARP_KEYS, SPLIT // STAGE
            scored = []  # each split's keys, scores, stage maxima and max (the score pass)
            for lo in range(0, we + 1, SPLIT):
                hi = min(lo + SPLIT, we + 1)
                keys = np.arange(lo, lo + SPLIT)
                valid = keys < hi
                kk = np.minimum(keys, S - 1)
                if group:
                    s = (qm @ k8[b, h, kk].T) * (scale * qsc.astype(np.float64))[:, None]
                else:
                    s = (qf @ k8[b, h, kk].T) * scale
                s = s * kss[kk]
                s[:, keys == we] = s_new[:, None]
                s = np.where(valid, s, -1e30)
                off_w = valid & (keys != we)
                mw = s.reshape(G, nw, WARP_KEYS).max(-1)  # [G, warps]
                m_of_stage = np.repeat(mw, WARP_KEYS // STAGE, axis=1)  # [G, stages]
                e = np.exp(s - np.repeat(m_of_stage, STAGE, axis=1))
                a = np.where(off_w, e * vss[kk], 0.0).reshape(G, nst, STAGE).max(-1)
                scored.append((lo, hi, keys, valid, kk, s, off_w, m_of_stage, a, mw.max(-1)))
            if row:  # the row max and the row's max of p * vss against it
                M_row = np.max([sc[-1] for sc in scored], axis=0)
                a_row = np.max([(sc[8] * np.exp(sc[7] - M_row[:, None])).max(-1)
                                for sc in scored], axis=0)
            parts = []
            for lo, hi, keys, valid, kk, s, off_w, m_of_stage, a, M in scored:
                if row:
                    own = (a * np.exp(m_of_stage - M_row[:, None])).max(-1)
                    M = M_row
                p = np.where(valid, np.exp(s - M[:, None]), 0.0)
                pv = np.where(off_w, p * vss[kk], 0.0)
                acc = np.zeros((G, hd))
                for x in range(nw):  # the warps, in order
                    for z in range(x * WARP_KEYS // STAGE, (x + 1) * WARP_KEYS // STAGE):
                        sel = slice(z * STAGE, (z + 1) * STAGE)
                        if row:
                            gmax = own if scale_from == "split" else a_row
                            psc = np.maximum(gmax * float(INV127), 1e-30)
                            p8 = np.minimum(np.round(pv[:, sel] / psc[:, None]), 127)
                            acc += (p8 @ v8[b, h, kk[sel]]) * psc[:, None]
                        elif group:
                            gz = group // STAGE
                            zs = range(z // gz * gz, z // gz * gz + gz)
                            if scale_from == "warp":
                                zs = [y for y in zs if y * STAGE // WARP_KEYS == x]
                            elif scale_from == "stage":
                                zs = [z]
                            gmax = np.max([a[:, y] * np.exp(m_of_stage[:, y] - M) for y in zs],
                                          axis=0)
                            psc = np.maximum(gmax * float(INV127), 1e-30)
                            p8 = np.minimum(np.round(pv[:, sel] / psc[:, None]), 127)
                            acc += (p8 @ v8[b, h, kk[sel]]) * psc[:, None]
                        else:
                            acc += pv[:, sel] @ v8[b, h, kk[sel]]
                if lo <= we < hi:
                    acc += p[:, keys == we] * nv[b, h].astype(np.float64)[None, :]
                parts.append((M, p.sum(-1), acc))
            Mx = np.max([m for m, _, _ in parts], axis=0)
            num = sum(np.exp(m - Mx)[:, None] * acc for m, _, acc in parts)
            den = sum(np.exp(m - Mx) * l for m, l, _ in parts)
            out[b, h] = num / den[:, None]
    return out


# (S, group, widths the plan is asked at): groups of one stage, one warp,
# two warps, the whole split, the whole row (S not a multiple of the stage
# and inside JAX's whole-S budget), and the exact arm (past the budget);
# w on every stage, warp and split edge, and parked
SCHEDULE_CASES = [(608, 32, TINY), (576, 64, TINY), (640, 128, TINY), (1024, 256, TINY),
                  (1000, 0, LLAMA2_7B), (1000, 1000, LLAMA31_8B), (4072, 0, LLAMA31_8B)]


def _edge_lens(S):
    return [0, 31, 32, 63, 64, 255, 256, 257, S - 1, S]


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("S,group,widths", SCHEDULE_CASES)
def test_q8_decode_schedule_matches_plain(S, group, widths, packed):
    """The kernel's schedule, emulated in float64, equals the plain version
    with the same group (which requantizes each group over the whole row
    at once, against the row max): a group's scale is known across warps
    and stages before any p8 is formed, the whole row's across splits
    (from the score pass), and the split partials, each relative to its
    own reference max, combine to the row. The plan gives the group at
    the named model's widths (the emulation's data is narrower)."""
    assert P.q8_decode_plan(S, *widths)[0] == group
    cache, q, nk, nv, lens, ids = _case(70 + S + packed, 10, 2, 4, S, 32, packed, _edge_lens(S))
    got = emulate_q8_schedule(cache, q, nk, nv, lens, ids, group)
    want = _port(cache, q, nk, nv, lens, ids, group)
    np.testing.assert_allclose(got, want, **(Q8_TOL if group else TOL))
    np.testing.assert_allclose(got[lens >= S], np.broadcast_to(
        nv[lens >= S][:, :, None], got[lens >= S].shape), atol=1e-6)


@pytest.mark.parametrize("arm,S", [("blocked", 512), ("blocked", 640), ("blocked", 576),
                                   ("blocked", 608), ("paged", 512)])
def test_q8_decode_schedule_matches_pallas(monkeypatch, arm, S):
    """The emulated schedule against JAX's Pallas bodies in interpret mode
    with the same group: the blocked arm at 256-, 128-, 64- and 32-key
    blocks, the paged arm at 64-token blocks (through identity tables: the
    group is bt; a live row's output)."""
    monkeypatch.setenv("LLM_MCP_TPU_Q8_DECODE", arm)
    A.decode_attend_q8.clear_cache()  # the arm is read at trace time
    cache, q, nk, nv, lens, ids = _case(80 + S, 4, 2, 2, S, 32, True,
                                        [0, 257, S - 1, S // 2 + 3])
    kw = {}
    group = P.q8_group(S)
    if arm == "paged":
        bt = group = 64
        tbl = np.arange(4 * (S // bt), dtype=np.int32).reshape(4, S // bt)
        pool = {"q": cache["q"][:, :1, :, :bt].copy(), "s": cache["s"][:, :1, :, :bt].copy()}
        kw = dict(block_tables=jnp.asarray(tbl), pool_k={k: jnp.asarray(v)
                                                         for k, v in pool.items()})
    jout = np.asarray(A.decode_attend_q8(
        jnp.asarray(q), jnp.asarray(nk), jnp.asarray(nv), {k: jnp.asarray(v) for k, v in
                                                           cache.items()}, {}, jnp.int32(1),
        jnp.asarray(lens), slot_ids=jnp.asarray(ids), interpret=True, **kw))
    got = emulate_q8_schedule(cache, q, nk, nv, lens, ids, group)
    np.testing.assert_allclose(got, jout, **Q8_TOL)


@pytest.mark.parametrize("S,group,scale_from", [
    (1024, 256, "warp"), (1024, 256, "stage"), (640, 128, "warp"), (640, 128, "stage"),
    (576, 64, "stage"), (1000, 1000, "split")])
def test_q8_decode_schedule_with_a_partial_scale_misses_plain(S, group, scale_from):
    """The faults the schedule guards against: a group's scale taken over
    one warp's keys or one stage's keys (where the group spans more), or
    the whole row's over one split's keys, gives other p8 and misses the
    plain version by more than Q8_TOL, so the matching emulation above
    pins the whole-group and whole-row rules."""
    cache, q, nk, nv, lens, ids = _case(90 + S, 10, 2, 4, S, 32, True, _edge_lens(S))
    got = emulate_q8_schedule(cache, q, nk, nv, lens, ids, group, scale_from)
    want = _port(cache, q, nk, nv, lens, ids, group)
    assert np.abs(got - want).max() > Q8_TOL["atol"]
