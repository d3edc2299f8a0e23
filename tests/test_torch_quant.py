"""Parity of the port's int8 weights and KV quantization (`models/quant.py`,
`models/llama.py:quantize_kv`/`fuse_prompt_kv`, `models/weights.py`) with
the JAX package, on the same numpy inputs.

What runs inside `jax.jit` in the JAX package (`qdot`, `quantize_kv`,
`fuse_prompt_kv`) is compared with its jitted form, as the engine runs it:
there XLA turns the division by the constant 127 into a multiplication by
its float32 reciprocal, which the port reproduces (`quant.INV127`).
`quantize_weight` runs eagerly in the JAX engine and is compared eagerly.
Everything here is bitwise except the logits head (a float matmul summed
in another order: 1e-5 relative).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_mcp_tpu.models import llama as JL
from llm_mcp_tpu.models import quant as JQ
from llm_mcp_tpu.models.configs import get_config as jax_get_config
from llm_mcp_tpu_torch.models import llama as TL
from llm_mcp_tpu_torch.models import quant as TQ
from llm_mcp_tpu_torch.models.configs import get_config
from llm_mcp_tpu_torch.models.weights import params_from_numpy

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _pair(x: np.ndarray, name: str):
    """The same values as a JAX array and a torch tensor of dtype `name`."""
    jdt, tdt = DTYPES[name]
    j = jnp.asarray(x).astype(jdt)
    return j, _t(np.asarray(j.astype(jnp.float32))).to(tdt)


def _np(x) -> np.ndarray:
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("axis", [-2, -1])
def test_quantize_weight_bitwise(axis):
    w = np.random.default_rng(0).standard_normal((3, 64, 48)).astype(np.float32)
    w[1, :, 5] = 0.0  # an all-zero channel takes scale 1
    j = JQ.quantize_weight(jnp.asarray(w), axis=axis)
    t = TQ.quantize_weight(_t(w), axis=axis)
    np.testing.assert_array_equal(t["q"].numpy(), np.asarray(j["q"]))
    np.testing.assert_array_equal(t["s"].numpy(), np.asarray(j["s"]))
    one = TQ.quantize_weight(_t(w[2]), axis=axis)  # a single slice
    np.testing.assert_array_equal(one["q"].numpy(), t["q"][2].numpy())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_qdot_bitwise(dtype):
    rng = np.random.default_rng(1)
    w = JQ.quantize_weight(jnp.asarray(rng.standard_normal((64, 40)).astype(np.float32)))
    jx, tx = _pair(rng.standard_normal((5, 7, 64)).astype(np.float32) * 3, dtype)
    jw = {"q": w["q"], "s": w["s"].astype(DTYPES[dtype][0])}
    tw = {"q": _t(w["q"]), "s": _pair(np.asarray(w["s"]), dtype)[1]}
    want = jax.jit(JQ.qdot)(jx, jw)
    got = TQ.qdot(tx, tw)
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_array_equal(_np(got), _np(want))
    # a plain weight is a plain product
    plain = rng.standard_normal((64, 40)).astype(np.float32)
    np.testing.assert_allclose(TQ.qdot(_t(np.asarray(jx, np.float32)), _t(plain)).numpy(),
                               np.asarray(jx, np.float32) @ plain, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tied", [True, False])
def test_embed_lookup_and_logits_head(tied):
    rng = np.random.default_rng(2)
    V, D = 96, 32
    table = rng.standard_normal((V, D) if tied else (D, V)).astype(np.float32)
    jq = JQ.quantize_weight(jnp.asarray(table), axis=-1 if tied else -2)
    tq = {"q": _t(jq["q"]), "s": _t(jq["s"])}
    h = rng.standard_normal((4, D)).astype(np.float32)
    want = JQ.logits_head(jq, jnp.asarray(h), tied=tied)
    got = TQ.logits_head(tq, _t(h), tied=tied)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    if tied:
        toks = np.asarray([[0, 5, 95], [7, 7, 1]], np.int32)
        np.testing.assert_array_equal(
            TQ.embed_lookup(tq, _t(toks)).numpy(),
            np.asarray(JQ.embed_lookup(jq, jnp.asarray(toks))))


def test_fuse_layer_weights_is_exact():
    """The fused products' columns are the separate products' bit for bit,
    in the port and as in JAX's fused tree."""
    jcfg, cfg = jax_get_config("tiny-llm"), get_config("tiny-llm")
    jp = JQ.init_llama_params_quantized(jcfg, jax.random.PRNGKey(3), scale_dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu", torch.float32)
    fused = TQ.fuse_layer_weights(tp)
    jfused = JQ.fuse_layer_weights(jp)
    for k in ("wqkv", "w13"):
        for part in ("q", "s"):
            np.testing.assert_array_equal(fused["layers"][k][part].numpy(),
                                          np.asarray(jfused["layers"][k][part]))
    x = _t(np.random.default_rng(3).standard_normal((6, cfg.dim)).astype(np.float32))
    lp, lf = TL._layer(tp, 1), TL._layer(fused, 1)
    for a, b in zip(TL._qkv(cfg, lp, x), TL._qkv(cfg, lf, x)):
        assert torch.equal(a, b)
    h = x * 0.5
    assert torch.equal(TL._ffn_residual(cfg, lp, h), TL._ffn_residual(cfg, lf, h))
    with pytest.raises(ValueError, match="mixed"):
        TQ._concat_w([tp["layers"]["wq"], torch.zeros(2, 2)])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_kv_and_fuse_prompt_kv_bitwise(dtype):
    rng = np.random.default_rng(4)
    kh = rng.standard_normal((2, 3, 2, 16, 32)).astype(np.float32)
    vh = rng.standard_normal((2, 3, 2, 16, 32)).astype(np.float32)
    kh[0, 1, 0, 3] = 0.0  # an all-zero row: scale 0, payload 0
    jk, tk = _pair(kh, dtype)
    jv, tv = _pair(vh, dtype)
    want = jax.jit(JL.quantize_kv)(jk)
    got = TL.quantize_kv(tk)
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(_np(got["s"]), _np(want["s"]))
    assert not got["q"][0, 1, 0, 3].any()
    want = jax.jit(JL.fuse_prompt_kv)(jk, jv)
    got = TL.fuse_prompt_kv(tk, tv)
    assert got["q"].shape[-3] == 2 * 2 + 1  # the packed pseudo-head fits
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(_np(got["s"]), _np(want["s"]))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_pack_and_unpack_scales_byte_identical(dtype):
    rng = np.random.default_rng(5)
    js, ts = _pair(rng.random((2, 3, 6, 16)).astype(np.float32), dtype)
    got = TQ.pack_scales(ts, 64)
    want = JQ.pack_scales(js, 64)
    assert got.dtype == torch.int8 and tuple(got.shape) == (2, 3, 1, 16, 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = TQ.unpack_scales(got[..., 0, :, :], 6, DTYPES[dtype][1])
    assert torch.equal(back, ts)
    np.testing.assert_array_equal(
        _np(back), _np(JQ.unpack_scales(want[..., 0, :, :], 6, DTYPES[dtype][0])))


@pytest.mark.parametrize("hkv,hd,dtype", [(8, 128, "bf16"), (8, 128, "f32"), (2, 32, "f32"),
                                          (32, 128, "bf16"), (33, 128, "bf16"), (4, 16, "f32")])
def test_scale_pack_width_matches_jax(hkv, hd, dtype):
    jdt, tdt = DTYPES[dtype]
    assert TQ.scale_pack_width(hkv, hd, tdt) == JQ.scale_pack_width(hkv, hd, jdt)


def test_params_from_numpy_takes_jax_int8_trees_exactly():
    """The JAX package's int8 tree (direct init, then fused, and the
    quantized f32 tree) crosses over unchanged: int8 payloads exact,
    scales to the dtype asked for; a wrong payload dtype raises."""
    jcfg, cfg = jax_get_config("tiny-llm"), get_config("tiny-llm")
    jp = JQ.init_llama_params_quantized(jcfg, jax.random.PRNGKey(6), scale_dtype=jnp.float32)
    for tree in (jp, JQ.fuse_layer_weights(jp),
                 JQ.quantize_params(JL.init_llama_params(jcfg, jax.random.PRNGKey(7),
                                                         dtype=jnp.float32))):
        npt = jax.tree.map(np.asarray, tree)
        tp = params_from_numpy(npt, cfg, "cpu", torch.float32)
        flat_j = jax.tree_util.tree_flatten_with_path(npt)[0]
        for path, leaf in flat_j:
            node = tp
            for k in path:
                node = node[k.key]
            assert node.dtype == (torch.int8 if leaf.dtype == np.int8 else torch.float32)
            np.testing.assert_array_equal(node.numpy(), leaf)
    npt = jax.tree.map(np.asarray, jp)
    bad = dict(npt, embed={"q": npt["embed"]["q"].astype(np.int16), "s": npt["embed"]["s"]})
    with pytest.raises(ValueError, match="int8"):
        params_from_numpy(bad, cfg)


def test_quantize_params_and_direct_init_match_jax_trees():
    """`quantize_params` on one f32 tree equals JAX's bit for bit, and the
    direct int8 init builds the same tree (keys, shapes, dtypes, constant
    scales) as JAX's, with payloads in [-127, 127]."""
    jcfg, cfg = jax_get_config("tiny-llm"), get_config("tiny-llm")
    jf = JL.init_llama_params(jcfg, jax.random.PRNGKey(8), dtype=jnp.float32)
    tf = params_from_numpy(jax.tree.map(np.asarray, jf), cfg, "cpu", torch.float32)
    jq, tq = JQ.quantize_params(jf), TQ.quantize_params(tf)
    assert TQ.quantize_params(tq)["embed"] is tq["embed"]  # no double quantization
    jl, tl_ = jax.tree.leaves(jq), jax.tree.leaves(tq)
    assert len(jl) == len(tl_)
    for a, b in zip(jl, tl_):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    jd = JQ.init_llama_params_quantized(jcfg, jax.random.PRNGKey(9), scale_dtype=jnp.float32)
    td = TQ.init_llama_params_quantized(cfg, torch.Generator().manual_seed(9),
                                        scale_dtype=torch.float32)
    jflat = dict(jax.tree_util.tree_flatten_with_path(jd)[0])
    tflat = dict(jax.tree_util.tree_flatten_with_path(td)[0])
    assert sorted(map(str, jflat)) == sorted(map(str, tflat))
    for path, a in jflat.items():
        b = tflat[path]
        assert tuple(b.shape) == a.shape and (b.dtype == torch.int8) == (a.dtype == jnp.int8)
        if a.dtype == jnp.int8:
            assert int(b.min()) >= -127 and int(b.max()) <= 127
        else:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)


def test_gemm_layout_keeps_values_and_products():
    """K-contiguous payloads hold the same values, and `qdot` over them is
    bit for bit the product over the row-major ones."""
    jcfg, cfg = jax_get_config("tiny-llm"), get_config("tiny-llm")
    jp = JQ.init_llama_params_quantized(jcfg, jax.random.PRNGKey(10), scale_dtype=jnp.float32)
    fused = TQ.fuse_layer_weights(params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu",
                                                    torch.float32))
    laid = TQ.gemm_layout(fused)
    x = _t(np.random.default_rng(11).standard_normal((5, cfg.dim)).astype(np.float32))
    for k in ("wqkv", "wo", "w13", "w2"):
        a, b = fused["layers"][k], laid["layers"][k]
        assert b["q"].stride(1) == 1 and torch.equal(a["q"], b["q"]) and b["s"] is a["s"]
        if k in ("wqkv", "w13"):
            assert torch.equal(TQ.qdot(x, {n: t[1] for n, t in a.items()}),
                               TQ.qdot(x, {n: t[1] for n, t in b.items()}))
    assert TQ.gemm_layout(laid)["layers"]["wo"]["q"] is laid["layers"]["wo"]["q"]
    assert laid["layers"]["attn_norm"] is fused["layers"]["attn_norm"]
