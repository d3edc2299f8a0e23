"""Mixture-of-Experts FFN with GShard-style capacity dispatch (counterpart
of `llm_mcp_tpu/models/moe.py`).

The routing is the JAX package's, so the two drop exactly the same tokens:
top-k experts per token from a float32 softmax over the router logits;
each expert takes at most C tokens, assigned by a cumulative count over
the flattened tokens, choice by choice (every token's first choice before
any token's second); a token past an expert's capacity loses that expert
(its gate mass is lost, the residual carries it). Rows outside `valid`
(padding) take no capacity. The dispatch is two one-hot products against a
[T, E, C] tensor and the experts are one batched product over the stacked
banks [E, D, F], as JAX computes them in XLA; a grouped expert GEMM is
later work. DeepSeek's shared experts are a dense gated MLP added to the
routed output, through `qdot` like any dense linear.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from .configs import ModelConfig
from .quant import qdot


def expert_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Per-expert token capacity for a T-token step: ceil(T * k / E *
    capacity_factor), at least 1 and at most T."""
    c = math.ceil(n_tokens * cfg.experts_per_tok / cfg.n_experts * cfg.capacity_factor)
    return max(1, min(c, n_tokens))


def moe_dispatch(
    cfg: ModelConfig,
    router_logits: torch.Tensor,  # [T, E]
    capacity: int,
    valid: torch.Tensor | None = None,  # [T] bool: rows that take part
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dispatch [T, E, C] 0/1, combine [T, E, C] gates), both float32."""
    T, E = router_logits.shape
    k = cfg.experts_per_tok
    probs = torch.softmax(router_logits.float(), dim=-1)
    top_g, top_i = torch.topk(probs, k, dim=-1)  # descending, as lax.top_k
    if cfg.norm_topk_prob and k > 1:
        top_g = top_g / top_g.sum(dim=-1, keepdim=True)
    elif cfg.routed_scaling_factor != 1.0:
        top_g = top_g * cfg.routed_scaling_factor
    # JAX loops over the k choices, each position a cumulative count of its
    # expert's earlier assignments (all of the previous choices', then this
    # choice's tokens up to this one): one cumulative count over the
    # choice-major [k*T] order is the same number
    ck = top_i.T.reshape(-1)  # [k*T]: choice j of token t at j*T + t
    mask = F.one_hot(ck, E).to(torch.int32)  # [k*T, E]
    if valid is not None:
        mask = mask * valid.to(torch.int32).repeat(k)[:, None]
    # the scan runs along the inner axis, [E, k*T]: fast on the card
    pos = torch.cumsum(mask.T, dim=1).T - 1  # [k*T, E]
    pos = pos.gather(1, ck[:, None])[:, 0]  # each choice's slot in its expert
    keep = (pos < capacity) & (mask.gather(1, ck[:, None])[:, 0] > 0)
    # a token's k choices are k distinct experts: no two land on one entry
    idx = (ck * capacity + pos.clamp(0, capacity - 1)).reshape(k, T).T  # [T, k]
    keepf = keep.reshape(k, T).T.float()
    dispatch = torch.zeros((T, E * capacity), dtype=torch.float32, device=router_logits.device)
    combine = torch.zeros_like(dispatch)
    dispatch.scatter_(1, idx, keepf)
    combine.scatter_(1, idx, keepf * top_g)
    return dispatch.reshape(T, E, capacity), combine.reshape(T, E, capacity)


def moe_ffn(
    cfg: ModelConfig,
    lp: dict[str, Any],
    x: torch.Tensor,  # [T, D]
    capacity: int | None = None,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Sparse FFN over flattened tokens: [T, D] -> [T, D]. lp holds this
    layer's "router" [D, E] and routed banks "w1e"/"w3e" [E, D, F], "w2e"
    [E, F, D], and with shared experts "w1s"/"w3s" [D, Fs], "w2s" [Fs, D]
    (plain or int8). `capacity=T` is dropless (decode); the default is the
    capacity factor's (prefill)."""
    T = x.shape[0]
    C = capacity if capacity is not None else expert_capacity(cfg, T)
    logits = x @ lp["router"]
    dispatch, combine = moe_dispatch(cfg, logits, C, valid=valid)
    xe = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), x)  # [E, C, D]
    gate = F.silu(torch.bmm(xe, lp["w1e"]))
    up = torch.bmm(xe, lp["w3e"])
    ye = torch.bmm(gate * up, lp["w2e"])  # [E, C, D]
    y = torch.einsum("tec,ecd->td", combine.to(x.dtype), ye)
    if "w1s" in lp:
        sg = F.silu(qdot(x, lp["w1s"]))
        y = y + qdot(sg * qdot(x, lp["w3s"]), lp["w2s"])
    return y


def moe_shapes(cfg: ModelConfig, L: int) -> dict[str, tuple]:
    """Shapes of the stacked [L, ...] MoE weights of `init_moe_layer_params`."""
    D, E = cfg.dim, cfg.n_experts
    Fm = cfg.moe_ffn_hidden or cfg.ffn_hidden
    out = {
        "router": (L, D, E),
        "w1e": (L, E, D, Fm),
        "w3e": (L, E, D, Fm),
        "w2e": (L, E, Fm, D),
    }
    if cfg.n_shared_experts:
        Fs = cfg.n_shared_experts * Fm
        out.update({"w1s": (L, D, Fs), "w3s": (L, D, Fs), "w2s": (L, Fs, D)})
    return out


def init_moe_layer_params(
    cfg: ModelConfig,
    generator: torch.Generator,
    dtype: torch.dtype,
    n_layers: int,
    device: str | torch.device = "cpu",
) -> dict[str, torch.Tensor]:
    """Random stacked MoE weights, fan-in scaled normals from `generator`,
    made one layer and one expert bank at a time on `device` (the routed
    banks of DeepSeek-V2-Lite are 28.8 GB in bf16)."""
    out = {}
    for name, shape in moe_shapes(cfg, n_layers).items():
        fan_in = shape[-2]
        t = torch.empty(shape, dtype=dtype, device=device)
        for dst in t.reshape(-1, *shape[-2:]):  # one [in, out] matrix at a time
            r = torch.randn(dst.shape, generator=generator, dtype=torch.float32, device=device)
            dst.copy_(r * fan_in**-0.5)
        out[name] = t
    return out
