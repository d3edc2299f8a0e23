"""Parity of the port's DeepSeek MoE FFN (`llm_mcp_tpu_torch/models/moe.py`)
with the JAX package's `models/moe.py`.

One JAX parameter tree of `tiny-v2` (f32) goes through `params_from_numpy`
to the port; activations are made with numpy from a seed. The routing must
drop exactly the tokens JAX drops: the dispatch tensors are compared bit
for bit (the same capacity, the same positional cumsum priority choice by
choice, pad rows excluded through `valid`, the same top-k order), the gates
and outputs in f32 within 1e-5 (the expert products sum in another order).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_mcp_tpu.models import moe as JM
from llm_mcp_tpu.models.configs import get_config as jax_get_config
from llm_mcp_tpu.models.llama import init_llama_params
from llm_mcp_tpu.models.quant import quantize_params as jax_quantize_params
from llm_mcp_tpu_torch.models import moe as TM
from llm_mcp_tpu_torch.models.configs import get_config
from llm_mcp_tpu_torch.models.weights import params_from_numpy

OUT_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def v2():
    jcfg = jax_get_config("tiny-v2")
    jparams = init_llama_params(jcfg, jax.random.PRNGKey(3), dtype=jnp.float32)
    cfg = get_config("tiny-v2")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu", torch.float32)
    return jcfg, jparams, cfg, tparams


def _layer(tree, li):
    return jax.tree.map(lambda a: a[li], tree)


def _tlayer(tree, li):
    return {k: {n: t[li] for n, t in v.items()} if isinstance(v, dict) else v[li]
            for k, v in tree.items()}


@pytest.mark.parametrize("T", [1, 7, 16, 100])
def test_expert_capacity_matches_jax(v2, T):
    jcfg, _, cfg, _ = v2
    assert TM.expert_capacity(cfg, T) == JM.expert_capacity(jcfg, T)
    lite = get_config("deepseek-v2-lite")
    assert TM.expert_capacity(lite, T) == JM.expert_capacity(jax_get_config("deepseek-v2-lite"), T)


@pytest.mark.parametrize("capacity,with_valid", [(3, False), (3, True), (24, True)])
def test_moe_dispatch_matches_jax(v2, capacity, with_valid):
    """Capacity 3 of 24 tokens drops tokens (4 experts, 2 choices each);
    24 is dropless. Pad rows excluded through `valid` take no capacity."""
    jcfg, _, cfg, _ = v2
    rng = np.random.default_rng(0)
    T, E = 24, cfg.n_experts
    logits = rng.standard_normal((T, E)).astype(np.float32)
    valid = rng.random(T) > 0.3 if with_valid else None
    jd, jc = JM.moe_dispatch(jcfg, jnp.asarray(logits), capacity,
                             valid=None if valid is None else jnp.asarray(valid))
    td, tc = TM.moe_dispatch(cfg, torch.from_numpy(logits), capacity,
                             valid=None if valid is None else torch.from_numpy(valid))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-7, rtol=1e-6)
    kept = td.sum(dim=(1, 2))
    if capacity < T:  # some token lost an expert
        assert (kept < cfg.experts_per_tok).any()
    if valid is not None:
        assert (kept[~torch.from_numpy(valid)] == 0).all()


@pytest.mark.parametrize("case", ["prefill_drops", "decode_dropless", "valid_mask"])
def test_moe_ffn_matches_jax(v2, case):
    jcfg, jparams, cfg, tparams = v2
    rng = np.random.default_rng(1)
    T = 32
    # a shared component skews the routing, so the capacity factor's C drops
    x = (rng.standard_normal((T, cfg.dim)) + 2.0 * rng.standard_normal(cfg.dim)).astype(np.float32)
    cap = T if case == "decode_dropless" else None
    valid = (np.arange(T) < 20) if case == "valid_mask" else None
    jlp, tlp = _layer(jparams["layers"], 1), _tlayer(tparams["layers"], 1)
    jy = JM.moe_ffn(jcfg, jlp, jnp.asarray(x), capacity=cap,
                    valid=None if valid is None else jnp.asarray(valid))
    ty = TM.moe_ffn(cfg, tlp, torch.from_numpy(x), capacity=cap,
                    valid=None if valid is None else torch.from_numpy(valid))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **OUT_TOL)
    if case == "prefill_drops":  # the capacity factor's C drops tokens at T = 32
        C = TM.expert_capacity(cfg, T)
        logits = torch.from_numpy(x) @ tlp["router"]
        d, _ = TM.moe_dispatch(cfg, logits, C)
        assert C < T and (d.sum(dim=(1, 2)) < cfg.experts_per_tok).any()


def test_moe_ffn_int8_shared_experts_match_jax(v2):
    """The shared experts through `qdot` at int8 (routed banks stay f32)."""
    jcfg, jparams, cfg, _ = v2
    jq = jax_quantize_params(jparams)
    assert isinstance(jq["layers"]["w1s"], dict) and not isinstance(jq["layers"]["w1e"], dict)
    tq = params_from_numpy(jax.tree.map(np.asarray, jq), cfg, "cpu", torch.float32)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((16, cfg.dim)).astype(np.float32)
    jy = JM.moe_ffn(jcfg, _layer(jq["layers"], 0), jnp.asarray(x), capacity=16)
    ty = TM.moe_ffn(cfg, _tlayer(tq["layers"], 0), torch.from_numpy(x), capacity=16)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4, rtol=1e-4)


def test_init_moe_layer_params_shapes(v2):
    jcfg, jparams, cfg, _ = v2
    g = torch.Generator().manual_seed(0)
    L = cfg.n_layers - cfg.first_dense_layers
    p = TM.init_moe_layer_params(cfg, g, torch.float32, L)
    for k, t in p.items():
        assert tuple(t.shape) == tuple(jparams["layers"][k].shape), k
        fan_in = t.shape[-2]
        assert abs(float(t.std()) - fan_in**-0.5) < 0.2 * fan_in**-0.5, k
