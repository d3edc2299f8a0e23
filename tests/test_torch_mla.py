"""Parity of the port's MLA path (`llm_mcp_tpu_torch/models/mla.py` and the
MLA kernels' plain versions in `kernels/attention.py`) with the JAX
package on `tiny-v2` (dense layer 0, MoE layers with shared experts, yarn
rope) and `tiny-mla` (dense).

One JAX parameter tree (f32) goes through `params_from_numpy`; caches,
tokens and kernel inputs are made with numpy from a seed. The JAX side runs
its Pallas kernels in interpret mode:

  - `decode_attend_q8_mla` against the Pallas body with the same
    requantization group: whole row (`mla_whole_s_fits` true), blocked
    (it patched to false: 512/128-key blocks), paged
    (`LLM_MCP_TPU_Q8_DECODE=paged`: bt-key blocks); within 2e-3 absolute
    (Q8_TOL; both quantize p to int8, and a probability at a rounding edge
    may land on the neighbouring int8 step), live rows only (a parked row's
    output is discarded); and group 0 against JAX's exact fallback at 1e-5;
  - `ragged_prefill_attend_mla` against `impl="kernel", interpret=True`,
    bf16 (f32 here) and int8 latents, contiguous and paged, within 1e-4
    (the JAX test's own bar);
  - the model functions: logits within 1e-4, written latents within 1e-5;
    int8 latents as payload within one step on at most Q8_PAYLOAD_FRAC of
    the elements and scales within 3e-6 relative (the two sides' norm, yarn
    rope and f32 epilogues round differently in the last bits, and a
    latent's max with them). The int8 decode step runs JAX's kernel arm (`attn_impl="pallas"`: pre-append cache, exact
    current token), which the port serves.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_mcp_tpu.kernels.attention as A
from llm_mcp_tpu.models import llama as JL
from llm_mcp_tpu.models import mla as JMLA
from llm_mcp_tpu.models import quant as JQ
from llm_mcp_tpu.models.configs import get_config as jax_get_config
from llm_mcp_tpu.ops.rope import rope_tables as jax_rope_tables
from llm_mcp_tpu_torch.executor.physical import pool_like
from llm_mcp_tpu_torch.kernels import attention as P
from llm_mcp_tpu_torch.models import llama as TL
from llm_mcp_tpu_torch.models import mla as TMLA
from llm_mcp_tpu_torch.models import quant as TQ
from llm_mcp_tpu_torch.models.configs import get_config
from llm_mcp_tpu_torch.models.weights import params_from_numpy
from llm_mcp_tpu_torch.ops.rope import rope_tables

Q8_TOL = dict(atol=2e-3, rtol=0)
RAGGED_TOL = 1e-4
LOGIT_TOL = dict(atol=1e-4, rtol=0)
CACHE_TOL = dict(atol=1e-5, rtol=0)
Q8_PAYLOAD_FRAC = 1e-3


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _tree_t(tree):
    return {k: _t(v) for k, v in tree.items()} if isinstance(tree, dict) else _t(tree)


def _tree_j(tree):
    return ({k: jnp.asarray(v) for k, v in tree.items()} if isinstance(tree, dict)
            else jnp.asarray(tree))


@pytest.fixture(scope="module", params=["tiny-v2", "tiny-mla"])
def shared(request):
    name = request.param
    jcfg = jax_get_config(name)
    jparams = JL.init_llama_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jparams)
    cfg = get_config(name)
    return jcfg, jparams, cfg, params_from_numpy(tree, cfg, "cpu", torch.float32), tree


# -- config and rope -----------------------------------------------------------


@pytest.mark.parametrize("name", ["deepseek-v2-lite", "tiny-v2", "tiny-mla", "mla-8b"])
def test_mla_configs_match_jax(name):
    j, t = jax_get_config(name), get_config(name)
    for f in ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads", "ffn_hidden",
              "rope_theta", "norm_eps", "rope_type", "rope_factor", "rope_orig_max",
              "yarn_beta_fast", "yarn_beta_slow", "yarn_mscale", "yarn_mscale_all_dim",
              "q_lora_rank", "kv_lora_rank", "qk_rope_head_dim", "qk_nope_head_dim",
              "v_head_dim", "n_experts", "experts_per_tok", "capacity_factor",
              "n_shared_experts", "moe_ffn_hidden", "first_dense_layers", "norm_topk_prob",
              "routed_scaling_factor", "tie_embeddings", "yarn_attn_mscale", "attn_scale"):
        assert getattr(t, f) == getattr(j, f), f
    assert TMLA.mla_scale(t) == JMLA.mla_scale(j)


@pytest.mark.parametrize("name,dim", [("deepseek-v2-lite", 64), ("tiny-v2", 16)])
def test_yarn_rope_tables_match_jax(name, dim):
    """Yarn frequencies with their magnitude correction, over the original
    context and far past it (f32 on both sides; cos/sin of the same f32
    angles, within 2 ulp of the tables' magnitude)."""
    pos = np.arange(0, 40_000, 37, dtype=np.int32)
    jc, js = jax_rope_tables(jax_get_config(name), dim, jnp.asarray(pos))
    tc, ts = rope_tables(get_config(name), dim, _t(pos))
    assert tc.dtype == torch.float32
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=4e-7, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=4e-7, rtol=0)


def test_q_lora_rank_is_refused():
    import dataclasses

    cfg = dataclasses.replace(get_config("tiny-v2"), q_lora_rank=16)
    g = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="q_lora_rank"):
        TL.init_llama_params(cfg, g, torch.float32)
    with pytest.raises(ValueError, match="q_lora_rank"):
        TQ.init_llama_params_quantized(cfg, g, torch.float32)


# -- the decode kernel's plain version ----------------------------------------


def _mla_cache(rng, L, B, S, R, dr):
    def plane(w):
        return {"q": rng.integers(-127, 128, (L, B, 1, S, w), dtype=np.int8),
                "s": (rng.random((L, B, 1, S), dtype=np.float32) * 0.02)}
    return plane(R), plane(dr)


def _decode_inputs(rng, B, H, R, dr):
    return (rng.standard_normal((B, H, R)).astype(np.float32),
            rng.standard_normal((B, H, dr)).astype(np.float32),
            rng.standard_normal((B, R)).astype(np.float32),
            rng.standard_normal((B, dr)).astype(np.float32))


def _lens(rng, fill, B, S):
    lens = np.clip((rng.random(B) * fill * S).astype(np.int32), 0, S - 1)
    lens[0] = S  # one row parked
    lens[-1] = int(fill * S) - 1 if fill else 0
    return lens


@pytest.mark.parametrize("fill", [0.0, 0.4, 0.9])
@pytest.mark.parametrize("arm,S", [("whole", 128), ("blocked", 1024), ("blocked", 384)])
def test_decode_attend_q8_mla_matches_pallas(monkeypatch, arm, S, fill):
    rng = np.random.default_rng(41)
    L, B, R, dr, H = 2, 3, 64, 32, 4
    if arm == "blocked":  # the whole-S arm off: blocks of 512 (S = 1024) or 128 (S = 384)
        monkeypatch.setattr(A, "mla_whole_s_fits", lambda *a, **k: False)
        monkeypatch.setattr(P, "mla_whole_s_fits", lambda *a, **k: False)
    group = S if arm == "whole" else A.mla_block_size(S)
    assert P.mla_decode_group(S, R, dr, H) == group
    cc, cr = _mla_cache(rng, L, B, S, R, dr)
    qt, qr, nc, nr = _decode_inputs(rng, B, H, R, dr)
    lens = _lens(rng, fill, B, S)
    ids = rng.permutation(B).astype(np.int32)
    sc = (R + dr) ** -0.5
    jout = A.decode_attend_q8_mla(
        jnp.asarray(qt), jnp.asarray(qr), jnp.asarray(nc), jnp.asarray(nr), _tree_j(cc),
        _tree_j(cr), jnp.int32(1), jnp.asarray(lens), slot_ids=jnp.asarray(ids), scale=sc,
        interpret=True,
    )
    tout = P.decode_attend_q8_mla(
        _t(qt), _t(qr), _t(nc), _t(nr), _tree_t(cc), _tree_t(cr), 1, _t(lens),
        slot_ids=_t(ids), scale=sc,
    )
    live = lens < S
    err = np.abs(tout.numpy()[live] - np.asarray(jout)[live]).max()
    print(f"decode_attend_q8_mla {arm} S={S} fill={fill}: max err {err:.3g}")
    np.testing.assert_allclose(tout.numpy()[live], np.asarray(jout)[live], **Q8_TOL)
    # a parked row attends its new vectors alone: its output is new_c
    np.testing.assert_allclose(tout.numpy()[0], np.broadcast_to(nc[0], (H, R)), atol=1e-6)


def _paged_planes(rng, cc, cr, B, S, bt, pxb):
    """Pools of fresh values and tables mixing pool rows, foreign arena
    homes and identity homes: both sides read the same bytes through them."""
    nbs = S // bt
    L = cc["q"].shape[0]
    pc = {"q": rng.integers(-127, 128, (L, pxb, 1, bt, cc["q"].shape[-1]), dtype=np.int8),
          "s": rng.random((L, pxb, 1, bt), dtype=np.float32) * 0.02}
    pr = {"q": rng.integers(-127, 128, (L, pxb, 1, bt, cr["q"].shape[-1]), dtype=np.int8),
          "s": rng.random((L, pxb, 1, bt), dtype=np.float32) * 0.02}
    tbl = np.arange(B * nbs, dtype=np.int32).reshape(B, nbs)
    for b in range(B):
        for j in range(nbs):
            u = rng.random()
            if u < 0.4:
                tbl[b, j] = B * nbs + rng.integers(pxb)
            elif u < 0.6:
                tbl[b, j] = ((b + 1) % B) * nbs + j
    return pc, pr, tbl


@pytest.mark.parametrize("fill", [0.4, 0.9])
@pytest.mark.parametrize("bt", [32, 64])
def test_decode_attend_q8_mla_paged_matches_pallas(monkeypatch, bt, fill):
    monkeypatch.setenv("LLM_MCP_TPU_Q8_DECODE", "paged")
    rng = np.random.default_rng(42)
    L, B, S, R, dr, H, pxb = 2, 3, 256, 64, 32, 4, 3
    cc, cr = _mla_cache(rng, L, B, S, R, dr)
    pc, pr, tbl = _paged_planes(rng, cc, cr, B, S, bt, pxb)
    qt, qr, nc, nr = _decode_inputs(rng, B, H, R, dr)
    lens = _lens(rng, fill, B, S)
    ids = rng.permutation(B).astype(np.int32)
    sc = (R + dr) ** -0.5
    jout = A.decode_attend_q8_mla(
        jnp.asarray(qt), jnp.asarray(qr), jnp.asarray(nc), jnp.asarray(nr), _tree_j(cc),
        _tree_j(cr), jnp.int32(1), jnp.asarray(lens), slot_ids=jnp.asarray(ids),
        block_tables=jnp.asarray(tbl), pool_c=_tree_j(pc), pool_r=_tree_j(pr), scale=sc,
        interpret=True,
    )
    assert P.mla_decode_group(S, R, dr, H, S // bt) == bt
    tout = P.decode_attend_q8_mla(
        _t(qt), _t(qr), _t(nc), _t(nr), _tree_t(cc), _tree_t(cr), 1, _t(lens),
        slot_ids=_t(ids), block_tables=_t(tbl), pool_c=_tree_t(pc), pool_r=_tree_t(pr),
        scale=sc,
    )
    live = lens < S
    err = np.abs(tout.numpy()[live] - np.asarray(jout)[live]).max()
    print(f"decode_attend_q8_mla paged bt={bt} fill={fill}: max err {err:.3g}")
    np.testing.assert_allclose(tout.numpy()[live], np.asarray(jout)[live], **Q8_TOL)


def test_decode_attend_q8_mla_exact_group_matches_fallback():
    """group 0 (past the blocked arm's cap, or an unfit block size through
    tables) is JAX's exact f32 fallback, paged or not: paged through the
    wrapper (16-token blocks are too small for JAX's paged arm), contiguous
    through the plain version (the wrapper picks it only past 64 blocks)."""
    rng = np.random.default_rng(43)
    L, B, S, R, dr, H, pxb = 2, 3, 256, 64, 32, 4, 3
    cc, cr = _mla_cache(rng, L, B, S, R, dr)
    pc, pr, tbl = _paged_planes(rng, cc, cr, B, S, 16, pxb)
    qt, qr, nc, nr = _decode_inputs(rng, B, H, R, dr)
    lens = _lens(rng, 0.7, B, S)
    ids = rng.permutation(B).astype(np.int32)
    sc = (R + dr) ** -0.5
    for paged in (False, True):
        kw = dict(block_tables=tbl, pool_c=pc, pool_r=pr) if paged else {}
        jout = A._decode_attend_q8_mla_fallback(
            jnp.asarray(qt), jnp.asarray(qr), jnp.asarray(nc), jnp.asarray(nr), _tree_j(cc),
            _tree_j(cr), jnp.int32(0), jnp.asarray(lens), sc, jnp.asarray(ids),
            **{k: _tree_j(v) for k, v in kw.items()},
        )
        targs = (_t(qt), _t(qr), _t(nc), _t(nr), _tree_t(cc), _tree_t(cr), 0, _t(lens))
        if paged:
            assert P.mla_decode_group(S, R, dr, H, tbl.shape[1]) == 0
            tout = P.decode_attend_q8_mla(*targs, slot_ids=_t(ids), scale=sc,
                                          **{k: _tree_t(v) for k, v in kw.items()})
        else:
            tout = P.decode_attend_q8_mla_plain(*targs, _t(ids), sc, 0)
        live = lens < S
        np.testing.assert_allclose(tout.numpy()[live], np.asarray(jout)[live], atol=1e-5, rtol=1e-5)
    assert P.mla_decode_group(65_536, R, dr, H) == 0  # past the blocked arm's cap
    assert P.mla_decode_group(4096, 512, 64, 16) == 4096  # the served shape: whole row
    assert P.mla_decode_group(4096, 512, 64, 16, nbs=64) == 64
    assert P.mla_decode_group(4096, 512, 64, 16, nbs=128) == 0  # bt 32: 128 blocks


# -- the decode kernel's split ---------------------------------------------------


@pytest.mark.parametrize("S,nbs,group", [
    (4096, None, 4096),  # the whole row, as served at V2-Lite: one group over 32 splits
    (16384, None, 512),  # the blocked arm's 512-key groups: four splits each
    (4096, 64, 64),  # 64-token tables: two groups inside each split
    (16384, 256, 0),  # 64-token tables past 64 blocks: the exact group
    (65536, None, 0),  # past the blocked arm's 64 blocks: the exact group
    (1024, 4, 256),  # 256-token tables: a group over two splits
])
def test_mla_decode_plan_splits_every_group(S, nbs, group):
    """The MLA decode wrapper's plan at V2-Lite's widths (16 heads, R =
    512, dr = 64): every row splits into MLA_DECODE_SPLIT-key CTAs whatever
    its group (the whole-row group too), and the f32 workspace holds each
    split's partial context, the scores and each split's (m, l, a)."""
    H, R, dr, Ba = 16, 512, 64, 8
    assert P.mla_decode_group(S, R, dr, H, nbs) == group
    nsplit, ws = P.mla_decode_plan(S, group, Ba, H)
    assert P.MLA_DECODE_SPLIT == 128
    assert nsplit == -(-S // 128)
    assert ws == Ba * nsplit * H * R + Ba * H * nsplit * 128 + Ba * nsplit * 3 * H


@pytest.mark.parametrize("S,group", [(640, 16), (640, 48), (4096, 96), (1024, 200)])
def test_mla_decode_plan_refuses_groups_it_cannot_split(S, group):
    """A group that neither holds whole splits nor fits whole in one (in
    steps of at least 32 keys) would need a scale from part of a split:
    refused, not approximated."""
    with pytest.raises(ValueError, match="group"):
        P.mla_decode_plan(S, group, 4, 16)
    assert P.mla_decode_plan(16, 16, 4, 16)[0] == 1  # the whole of a short row is fine


def _emulate_split_schedule(qt, qr, nc, nr, lat, ls, rop, rs, lens, scale, group, split):
    """The CUDA kernel's schedule in float64 (inputs f32, latents as
    gathered rows [Ba, S, ...]): per split of `split` keys its scores and
    (m, l, a) = (max, sum of e^(s - m), max of e^(s - m) * ls off w); the
    row max M; a group's max of p * ls over every split it covers (from
    their a) or, for a group of 32..split keys inside a split, from its own
    keys; p8 per split with that scale; the integer partial p8 . lat of
    each group times its psc, summed over the splits; p_w * c_new; over l."""
    inv127 = np.float32(1.0 / 127.0)
    Ba, H, R = qt.shape
    S = lat.shape[1]
    local = 32 <= group <= split and split % group == 0
    out = np.zeros((Ba, H, R))
    for b in range(Ba):
        w = int(lens[b])
        we = w if 0 <= w < S else 0
        s_new = (qt[b].astype(np.float64) @ nc[b] + qr[b].astype(np.float64) @ nr[b]) * scale
        if group:
            qsc = np.maximum(np.abs(qt[b]).max(-1) * inv127, np.float32(1e-30))
            q = np.round(qt[b] / qsc[:, None]).astype(np.float64)
        splits = []
        for k0 in range(0, we + 1, split):
            keys = np.arange(k0, min(we + 1, k0 + split))
            lf, rf = lat[b, keys].astype(np.float64), rop[b, keys].astype(np.float64)
            if group:
                sl = (q @ lf.T) * (scale * qsc.astype(np.float64))[:, None] * ls[b, keys]
                s = sl + (qr[b].astype(np.float64) @ rf.T) * rs[b, keys] * scale
            else:
                s = ((qt[b].astype(np.float64) @ lf.T) * ls[b, keys]
                     + (qr[b].astype(np.float64) @ rf.T) * rs[b, keys]) * scale
            at_w = keys == we
            s[:, at_w] = s_new[:, None]
            m = s.max(-1)
            e = np.exp(s - m[:, None])
            a = np.where(at_w, 0.0, e * ls[b, keys]).max(-1)
            splits.append((keys, s, m, e.sum(-1), a))
        M = np.max([m for _, _, m, _, _ in splits], axis=0)
        ctx = np.zeros((H, R))
        for z, (keys, s, m, _, _) in enumerate(splits):
            pv = np.where(keys == we, 0.0, np.exp(s - M[:, None]) * ls[b, keys])
            if not group:
                ctx += pv @ lat[b, keys].astype(np.float64)
                continue
            if local:
                gids = (keys - keys[0]) // group
            else:
                g0 = 0 if group >= S else keys[0] // group * (group // split)
                zs = range(g0, len(splits)) if group >= S else range(g0, min(
                    g0 + group // split, len(splits)))
                span = np.max([np.exp(splits[i][2] - M) * splits[i][4] for i in zs], axis=0)
                gids = np.zeros(len(keys), int)
            for gi in np.unique(gids):
                sel = gids == gi
                gmax = pv[:, sel].max(-1) if local else span
                psc = np.maximum(gmax * float(inv127), 1e-30)
                p8 = np.round(pv[:, sel] / psc[:, None])
                assert p8.max() <= 127
                ctx += (p8 @ lat[b, keys[sel]].astype(np.float64)) * psc[:, None]
        l = sum(np.exp(m - M) * ls_ for _, _, m, ls_, _ in splits)
        out[b] = (ctx + np.exp(s_new - M)[:, None] * nc[b]) / l[:, None]
    return out


@pytest.mark.parametrize("S,group", [
    (640, 640),  # the whole row over five splits
    (1024, 512),  # two 512-key groups, four splits each
    (640, 32), (640, 64),  # table groups inside a split
    (1024, 256),  # a table group over two splits
    (640, 0),  # the exact group
])
def test_mla_decode_split_schedule_matches_plain(S, group):
    """The kernel's split rule, emulated in float64 at the wrapper's split
    size, equals `decode_attend_q8_mla_plain` (which requantizes each
    group over the whole row at once) within Q8_TOL: a group's scale is
    known row-wide before any p8 is formed, and the integer partials of
    the splits add up. Rows whose w sits on a split boundary, one before
    and one after it, one key, a full row, and a parked row."""
    rng = np.random.default_rng(44 + S + group)
    L, B, R, dr, H = 2, 7, 64, 32, 4
    cc, cr = _mla_cache(rng, L, B, S, R, dr)
    qt, qr, nc, nr = _decode_inputs(rng, B, H, R, dr)
    lens = np.asarray([128, 127, 129, 0, S - 1, S, 300], np.int32)
    ids = rng.permutation(B).astype(np.int32)
    sc = (R + dr) ** -0.5
    ref = P.decode_attend_q8_mla_plain(
        _t(qt), _t(qr), _t(nc), _t(nr), _tree_t(cc), _tree_t(cr), 1, _t(lens), _t(ids), sc,
        group).numpy()
    got = _emulate_split_schedule(
        qt, qr, nc, nr, cc["q"][1, ids, 0], cc["s"][1, ids, 0], cr["q"][1, ids, 0],
        cr["s"][1, ids, 0], lens, sc, group, P.MLA_DECODE_SPLIT)
    np.testing.assert_allclose(got, ref, **Q8_TOL)
    np.testing.assert_allclose(got[5], np.broadcast_to(nc[5], (H, R)), atol=1e-6)


# -- the ragged kernel's plain version -----------------------------------------


def _ragged_case(rng, fill, S, B):
    """Three descriptor rows packed into T = 32 with a pad tail."""
    ns = [9, 12, 5]
    starts = [int(fill * S) // 2, 0, int(fill * S)]
    starts = [min(s, S - n) for s, n in zip(starts, ns)]
    T, R = 32, len(ns)
    rowids = np.asarray(sum(([r] * n for r, n in enumerate(ns)), []) + [R] * (T - sum(ns)),
                        np.int32)
    offsets = np.asarray([sum(ns[:r]) for r in range(R + 1)], np.int32)
    slots = np.asarray([4, 1, 2], np.int32)
    return T, sum(ns), rowids, offsets, slots, np.asarray(starts, np.int32)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("fill", [0.4, 0.9])
def test_ragged_prefill_attend_mla_matches_pallas(fill, paged, quant):
    rng = np.random.default_rng(44)
    L, S, bt, B, Rl, dr, H, pxb = 2, 128, 32, 6, 32, 16, 4, 3
    T, total, rowids, offsets, slots, starts = _ragged_case(rng, fill, S, B)
    if quant:
        cc, cr = _mla_cache(rng, L, B, S, Rl, dr)
        pc, pr, tbl = _paged_planes(rng, cc, cr, B, S, bt, pxb)
    else:
        cc = rng.standard_normal((L, B, 1, S, Rl)).astype(np.float32)
        cr = rng.standard_normal((L, B, 1, S, dr)).astype(np.float32)
        pc = rng.standard_normal((L, pxb, 1, bt, Rl)).astype(np.float32)
        pr = rng.standard_normal((L, pxb, 1, bt, dr)).astype(np.float32)
        _, _, tbl = _paged_planes(rng, *_mla_cache(rng, L, B, S, Rl, dr), B, S, bt, pxb)
    qt = rng.standard_normal((T, H, Rl)).astype(np.float32)
    qr = rng.standard_normal((T, H, dr)).astype(np.float32)
    cs = rng.standard_normal((T, Rl)).astype(np.float32)
    krs = rng.standard_normal((T, dr)).astype(np.float32)
    sc = (Rl + dr) ** -0.5
    pg = dict(block_tables=tbl, pool_c=pc, pool_r=pr) if paged else {}
    jout = A.ragged_prefill_attend_mla(
        jnp.asarray(qt), jnp.asarray(qr), jnp.asarray(cs), jnp.asarray(krs), _tree_j(cc),
        _tree_j(cr), 1, jnp.asarray(rowids), jnp.asarray(offsets), jnp.asarray(slots),
        jnp.asarray(starts), scale=sc, impl="kernel", interpret=True, block_q=16,
        **{k: _tree_j(v) for k, v in pg.items()},
    )
    tout = P.ragged_prefill_attend_mla(
        _t(qt), _t(qr), _t(cs), _t(krs), _tree_t(cc), _tree_t(cr), 1, _t(rowids), _t(offsets),
        _t(slots), _t(starts), scale=sc, **{k: _tree_t(v) for k, v in pg.items()},
    )
    err = np.abs(tout.numpy()[:total] - np.asarray(jout)[:total]).max()
    assert err < RAGGED_TOL, err
    assert torch.isfinite(tout).all()


# -- the model functions ---------------------------------------------------------


def _assert_latents(got, want, tol=CACHE_TOL):
    """Written latents: f32 arrays within tol; int8 planes as payload within
    one step on at most Q8_PAYLOAD_FRAC of the elements, scales 3e-6
    relative (a latent's max differs in the last bits through the norm and
    yarn rope, and the scale with it)."""
    if isinstance(want, dict):
        gq, wq = got["q"].numpy().astype(np.int32), np.asarray(want["q"]).astype(np.int32)
        d = np.abs(gq - wq)
        assert d.max() <= 1 and (d > 0).mean() <= Q8_PAYLOAD_FRAC, (d.max(), (d > 0).mean())
        np.testing.assert_allclose(got["s"].numpy(), np.asarray(want["s"]), rtol=3e-6, atol=0)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("quant_kv", [False, True])
def test_mla_prefill_matches_jax(shared, quant_kv):
    jcfg, jparams, cfg, tparams, _ = shared
    rng = np.random.default_rng(5)
    B, S = 3, 32
    tokens = rng.integers(3, 259, (B, S)).astype(np.int32)
    lengths = np.asarray([32, 17, 1], np.int32)
    jl, jc, jr = JL.llama_prefill(jcfg, jparams, jnp.asarray(tokens), jnp.asarray(lengths),
                                  quant_kv=quant_kv)
    tl, tc, tr = TL.llama_prefill(cfg, tparams, _t(tokens), _t(lengths), quant_kv=quant_kv)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _assert_latents(tc, jc)
    _assert_latents(tr, jr)


def _caches(rng, cfg, B, S, quantized):
    L, R, dr = cfg.n_layers, cfg.kv_lora_rank, cfg.qk_rope_head_dim
    if quantized:
        return _mla_cache(rng, L, B, S, R, dr)
    return (rng.standard_normal((L, B, 1, S, R)).astype(np.float32),
            rng.standard_normal((L, B, 1, S, dr)).astype(np.float32))


def _pools(rng, cfg, cc, cr, B, S, bt, pxb, quantized):
    if quantized:
        return _paged_planes(rng, cc, cr, B, S, bt, pxb)
    pc = rng.standard_normal((cfg.n_layers, pxb, 1, bt, cfg.kv_lora_rank)).astype(np.float32)
    pr = rng.standard_normal((cfg.n_layers, pxb, 1, bt, cfg.qk_rope_head_dim)).astype(np.float32)
    _, _, tbl = _paged_planes(rng, *_mla_cache(rng, 1, B, S, 1, 1), B, S, bt, pxb)
    return pc, pr, tbl


def _copy(tree):
    return {k: v.copy() for k, v in tree.items()} if isinstance(tree, dict) else tree.copy()


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("paged", [False, True])
def test_mla_prefill_chunk_ragged_matches_jax(shared, monkeypatch, quantized, paged):
    monkeypatch.setenv("LLM_MCP_TPU_RAGGED_IMPL", "kernel")
    jcfg, jparams, cfg, tparams, _ = shared
    rng = np.random.default_rng(6)
    B, S, bt, pxb = 4, 128, 32, 3
    cc, cr = _caches(rng, cfg, B, S, quantized)
    lens = [12, 9, 0]  # row 2 unused: 21 real tokens, 11 pads
    T, R = 32, 3
    starts = np.asarray([40, 0, 0], np.int32)
    slots = np.asarray([2, 0, 3], np.int32)
    rowids = np.asarray([0] * 12 + [1] * 9 + [R] * 11, np.int32)
    positions = np.asarray(list(range(40, 52)) + list(range(9)) + [S] * 11, np.int32)
    last_idx = np.asarray([11, 20, 0], np.int32)
    tokens = rng.integers(3, 259, (T,)).astype(np.int32)
    jpg = tpg = None
    if paged:
        pc, pr, tbl = _pools(rng, cfg, cc, cr, B, S, bt, pxb, quantized)
        jpg = {"tbl": jnp.asarray(tbl), "k": _tree_j(pc), "v": _tree_j(pr)}
        tpg = {"tbl": _t(tbl), "k": _tree_t(pc), "v": _tree_t(pr)}
    args = [tokens, rowids, positions, slots, starts, last_idx]
    jl, jc, jr = JL.llama_prefill_chunk_ragged(
        jcfg, jparams, _tree_j(cc), _tree_j(cr), *map(jnp.asarray, args), paged=jpg)
    tl, tc, tr = TL.llama_prefill_chunk_ragged(
        cfg, tparams, _tree_t(_copy(cc)), _tree_t(_copy(cr)), *map(_t, args), paged=tpg)
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], **LOGIT_TOL)
    _assert_latents(tc, jc)
    _assert_latents(tr, jr)


@pytest.mark.parametrize("quantized,paged", [(False, False), (False, True), (True, False),
                                             (True, True)])
def test_mla_decode_step_matches_jax(shared, monkeypatch, quantized, paged):
    """bf16 latents: JAX's XLA arm (append, then attend); int8: its kernel
    arm (`attn_impl="pallas"`; `paged` forced for the block-table arm)."""
    if paged:
        monkeypatch.setenv("LLM_MCP_TPU_Q8_DECODE", "paged")
    jcfg, jparams, cfg, tparams, _ = shared
    rng = np.random.default_rng(7)
    B, S, bt, pxb = 4, 128, 32, 3
    cc, cr = _caches(rng, cfg, B, S, quantized)
    tokens = rng.integers(3, 259, (B,)).astype(np.int32)
    lengths = np.asarray([5, 77, S, 63], np.int32)  # row 2 parked
    ids = np.asarray([2, 0, 1, 3], np.int32)
    jpg = tpg = None
    if paged:
        pc, pr, tbl = _pools(rng, cfg, cc, cr, B, S, bt, pxb, quantized)
        jpg = {"tbl": jnp.asarray(tbl), "k": _tree_j(pc), "v": _tree_j(pr)}
        tpg = {"tbl": _t(tbl), "k": _tree_t(pc), "v": _tree_t(pr)}
    jl, jc, jr = JL.llama_decode_step(
        jcfg, jparams, _tree_j(cc), _tree_j(cr), jnp.asarray(tokens), jnp.asarray(lengths),
        attn_impl="pallas", slot_ids=jnp.asarray(ids), paged=jpg)
    tl, tc, tr = TL.llama_decode_step(
        cfg, tparams, _tree_t(_copy(cc)), _tree_t(_copy(cr)), _t(tokens), _t(lengths),
        slot_ids=_t(ids), paged=tpg)
    live = lengths < S
    tol = dict(atol=2e-3, rtol=0) if quantized else LOGIT_TOL
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live], **tol)
    assert np.isfinite(tl.numpy()).all()
    _assert_latents(tc, jc)
    _assert_latents(tr, jr)


# -- trees, quantization and pools ---------------------------------------------


def test_params_from_numpy_on_v2_trees():
    """bf16-structure and int8 (direct init; quantized then fused) V2
    trees convert with every key and shape checked, and still raise on an
    unknown key, a missing key and a wrong shape."""
    jcfg, cfg = jax_get_config("tiny-v2"), get_config("tiny-v2")
    trees = {
        "plain": JL.init_llama_params(jcfg, jax.random.PRNGKey(1), dtype=jnp.float32),
        "int8_direct": JQ.init_llama_params_quantized(jcfg, jax.random.PRNGKey(2),
                                                       scale_dtype=jnp.float32),
    }
    trees["int8_fused"] = JQ.fuse_layer_weights(JQ.quantize_params(trees["plain"]))
    for name, jt in trees.items():
        tree = jax.tree.map(np.asarray, jt)
        tp = params_from_numpy(tree, cfg, "cpu", torch.float32)
        assert set(tp) == set(tree), name
        flat_t = jax.tree_util.tree_leaves_with_path(tree)
        assert len(flat_t) == len(jax.tree_util.tree_leaves(
            jax.tree.map(lambda x: x.numpy(), tp))), name
        if name != "plain":
            assert tp["layers"]["w_ukv"]["q"].dtype == torch.int8
            assert tp["layers"]["w1e"].dtype == torch.float32  # routed banks stay
        if name == "int8_fused":
            assert "w13" in tp["dense_layers"] and "w1" not in tp["dense_layers"]
    tree = jax.tree.map(np.asarray, trees["plain"])
    bad = dict(tree, layers=dict(tree["layers"], wq=np.zeros((2, 128, 128), np.float32)))
    with pytest.raises(KeyError, match="wq"):
        params_from_numpy(bad, cfg)
    missing = dict(tree, dense_layers={k: v for k, v in tree["dense_layers"].items()
                                       if k != "kv_norm"})
    with pytest.raises(KeyError, match="kv_norm"):
        params_from_numpy(missing, cfg)
    wrong = dict(tree, layers=dict(tree["layers"], w1e=tree["layers"]["w1e"][:, :3]))
    with pytest.raises(ValueError, match="w1e"):
        params_from_numpy(wrong, cfg)


def test_quant_tree_ops_cover_the_dense_prologue():
    """quantize_params, fuse_layer_weights and gemm_layout go over both
    stacks; the routed banks stay unquantized; the direct int8 init has
    the quantized tree's structure."""
    cfg = get_config("tiny-v2")
    g = torch.Generator().manual_seed(0)
    plain = TL.init_llama_params(cfg, g, torch.float32)
    q = TQ.gemm_layout(TQ.fuse_layer_weights(TQ.quantize_params(plain)))
    direct = TQ.gemm_layout(TQ.fuse_layer_weights(TQ.init_llama_params_quantized(cfg, g)))
    for tree in (q, direct):
        for stack in ("layers", "dense_layers"):
            for k in ("wq_mla", "w_dkv", "w_ukv", "wo_mla"):
                w = tree[stack][k]
                assert TQ.is_quantized(w) and w["q"].stride(1) == 1, (stack, k)
        assert TQ.is_quantized(tree["dense_layers"]["w13"])
        assert TQ.is_quantized(tree["layers"]["w1s"])
        assert not TQ.is_quantized(tree["layers"]["w1e"])
        assert not TQ.is_quantized(tree["layers"]["router"])
    shapes = TL.param_shapes(cfg, fused=True)
    assert shapes["dense_layers"]["w13"] == (1, cfg.dim, 2 * cfg.ffn_hidden)


def test_pool_like_maps_the_latent_planes():
    """The prefix pool of an MLA cache: each int8 plane's {"q", "s"} dict
    leaf by leaf, bf16 latents as arrays."""
    cfg = get_config("tiny-v2")
    for quantized in (False, True):
        cache = TL.init_kv_cache(cfg, 4, 128, torch.float32, quantized=quantized)
        pk, pv = pool_like(cache["k"], 5, 32), pool_like(cache["v"], 5, 32)
        if quantized:
            assert pk["q"].shape == (3, 5, 1, 32, 32) and pk["q"].dtype == torch.int8
            assert pk["s"].shape == (3, 5, 1, 32) and pv["s"].shape == (3, 5, 1, 32)
            assert pv["q"].shape == (3, 5, 1, 32, 16)
        else:
            assert pk.shape == (3, 5, 1, 32, 32) and pv.shape == (3, 5, 1, 32, 16)
