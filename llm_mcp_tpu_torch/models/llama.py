"""Llama-family causal decoder in PyTorch (counterpart of
`llm_mcp_tpu/models/llama.py`).

Plain functions on tensors and a parameter dictionary with the JAX
package's layout, so the two compute the same thing from the same weights:

  params["embed"]            [V, D]
  params["layers"][name]     [L, ...] stacked per-layer weights
  params["final_norm"]       [D]
  params["lm_head"]          [D, V] (absent when embeddings are tied)
  KV cache k, v              [L, B, Hkv, S, hd] (heads before sequence)

bf16 weights and activations, float32 softmax and logits. Attention goes
through the kernels of `kernels/attention.py`: flash prefill for fresh
prompts, ragged prefill for packed chunks, decode attention over the
pre-append cache and one post-layer append for decode steps. The cache is
updated in place (the JAX functions return new arrays); the functions
return it all the same, so call sites read like their JAX counterparts.

`paged={"tbl", "k", "v"}` (the physical block tables [B, nbs] and the
prefix pool [L, PXB, Hkv, bt, hd] of `executor/physical.py`) makes the
attention reads go through the tables. Writes stay table-free: they land
at private positions, which are identity-homed in the arena.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from ..kernels.attention import (
    append_kv_bf16,
    decode_attend_bf16,
    flash_prefill_attention,
    ragged_prefill_attend_bf16,
)
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope, rope_tables
from .configs import ModelConfig

Params = dict[str, Any]

LAYER_KEYS = ("attn_norm", "ffn_norm", "wq", "wk", "wv", "wo", "w1", "w3", "w2")


def param_shapes(cfg: ModelConfig) -> dict[str, Any]:
    """Expected shape of every parameter, in the parameter tree's layout."""
    hd = cfg.resolved_head_dim
    L, D, H, Hkv, Fh, V = (
        cfg.n_layers, cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.ffn_hidden, cfg.vocab_size,
    )
    shapes: dict[str, Any] = {
        "embed": (V, D),
        "final_norm": (D,),
        "layers": {
            "attn_norm": (L, D),
            "ffn_norm": (L, D),
            "wq": (L, D, H * hd),
            "wk": (L, D, Hkv * hd),
            "wv": (L, D, Hkv * hd),
            "wo": (L, H * hd, D),
            "w1": (L, D, Fh),
            "w3": (L, D, Fh),
            "w2": (L, Fh, D),
        },
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (D, V)
    return shapes


def init_llama_params(
    cfg: ModelConfig,
    generator: torch.Generator,
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cpu",
) -> Params:
    """Random weights with fan-in scaling from `generator` (seeded by the
    caller), made one layer at a time on `device` so the float32 draw never
    exceeds one layer's slice. Norm weights start at 1."""
    shapes = param_shapes(cfg)

    def w(shape, fan_in):
        t = torch.empty(shape, dtype=dtype, device=device)
        for dst in t if len(shape) == 3 else [t]:  # one layer at a time
            r = torch.randn(dst.shape, generator=generator, dtype=torch.float32, device=device)
            dst.copy_(r * fan_in**-0.5)
        return t

    D = cfg.dim
    ls = shapes["layers"]
    layers = {
        "attn_norm": torch.ones(ls["attn_norm"], dtype=dtype, device=device),
        "ffn_norm": torch.ones(ls["ffn_norm"], dtype=dtype, device=device),
        "wq": w(ls["wq"], D),
        "wk": w(ls["wk"], D),
        "wv": w(ls["wv"], D),
        "wo": w(ls["wo"], ls["wo"][1]),
        "w1": w(ls["w1"], D),
        "w3": w(ls["w3"], D),
        "w2": w(ls["w2"], cfg.ffn_hidden),
    }
    params: Params = {
        "embed": w(shapes["embed"], D),
        "layers": layers,
        "final_norm": torch.ones(shapes["final_norm"], dtype=dtype, device=device),
    }
    if "lm_head" in shapes:
        params["lm_head"] = w(shapes["lm_head"], D)
    return params


def init_kv_cache(
    cfg: ModelConfig,
    batch: int,
    max_seq: int,
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cpu",
) -> dict[str, torch.Tensor]:
    """Zeroed KV cache buffers {"k", "v"}, each [L, B, Hkv, S, hd]."""
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_seq, cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def _paged_kw(paged: dict | None) -> dict:
    """The attention wrappers' paged arguments from a `paged` operand."""
    if paged is None:
        return {}
    return {"block_tables": paged["tbl"], "pool_k": paged["k"], "pool_v": paged["v"]}


def _layer(params: Params, li: int) -> Params:
    return {k: v[li] for k, v in params["layers"].items()}


def _norm(cfg: ModelConfig, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return rms_norm(x, w, cfg.norm_eps)


def _qkv(cfg: ModelConfig, lp: Params, x: torch.Tensor):
    """Q/K/V projections on [..., D] activations; flat outputs."""
    return x @ lp["wq"], x @ lp["wk"], x @ lp["wv"]


def _attn_residual(cfg: ModelConfig, lp: Params, ctx: torch.Tensor, h: torch.Tensor):
    return h + ctx @ lp["wo"]


def _ffn_residual(cfg: ModelConfig, lp: Params, h: torch.Tensor) -> torch.Tensor:
    x = _norm(cfg, h, lp["ffn_norm"])
    gate = F.silu(x @ lp["w1"])
    up = x @ lp["w3"]
    return h + (gate * up) @ lp["w2"]


def _embed_in(cfg: ModelConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()]


def _logits(cfg: ModelConfig, params: Params, h: torch.Tensor) -> torch.Tensor:
    h = _norm(cfg, h, params["final_norm"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (h @ head).float()


def prefill_layer(
    cfg: ModelConfig,
    lp: Params,
    h: torch.Tensor,  # [B, S, D]
    cos: torch.Tensor,
    sin: torch.Tensor,
    lengths: torch.Tensor,  # [B] int32
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """One decoder layer over full prompts; returns (h, (k, v)) with k/v in
    cache layout [B, Hkv, S, hd]."""
    B, S, _ = h.shape
    hd = cfg.resolved_head_dim
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    x = _norm(cfg, h, lp["attn_norm"])
    q, k, v = _qkv(cfg, lp, x)
    q = apply_rope(q.reshape(B, S, H, hd), cos, sin)
    k = apply_rope(k.reshape(B, S, Hkv, hd), cos, sin)
    v = v.reshape(B, S, Hkv, hd)
    kh = k.transpose(1, 2).contiguous()  # [B, Hkv, S, hd]
    vh = v.transpose(1, 2).contiguous()
    ctx = flash_prefill_attention(
        q.transpose(1, 2).contiguous(), kh, vh, lengths, scale=cfg.attn_scale
    )
    ctx = ctx.transpose(1, 2).reshape(B, S, H * hd)
    h = _attn_residual(cfg, lp, ctx, h)
    h = _ffn_residual(cfg, lp, h)
    return h, (kh, vh)


@torch.no_grad()
def llama_prefill(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,  # [B, S] int32 (right-padded prompts)
    lengths: torch.Tensor,  # [B] int32 true prompt lengths
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal self-attention over fresh prompts (no past KV). Returns
    (last_logits [B, V] f32, k [L, B, Hkv, S, hd], v [...])."""
    B, S = tokens.shape
    h = _embed_in(cfg, params, tokens)
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)[None, :]
    cos, sin = rope_tables(cfg, cfg.resolved_head_dim, positions)
    ks, vs = [], []
    for li in range(cfg.n_layers):
        h, (kh, vh) = prefill_layer(cfg, _layer(params, li), h, cos, sin, lengths)
        ks.append(kh)
        vs.append(vh)
    # empty rows (length 0) read position 0, as JAX's clamping gather does
    last_idx = torch.clamp(lengths.long() - 1, min=0)
    last = h[torch.arange(B, device=h.device), last_idx]
    return _logits(cfg, params, last), torch.stack(ks), torch.stack(vs)


@torch.no_grad()
def llama_prefill_chunk_ragged(
    cfg: ModelConfig,
    params: Params,
    cache_k: torch.Tensor,  # [L, B, Hkv, S, hd] — updated in place
    cache_v: torch.Tensor,
    tokens: torch.Tensor,  # [T] int32 — packed chunks, rows back to back
    rowids: torch.Tensor,  # [T] int32 — descriptor row per token, sorted; pads = R
    positions: torch.Tensor,  # [T] int32 — cache position per token; pads = S
    slots: torch.Tensor,  # [R] int32 — engine slot per descriptor row
    starts: torch.Tensor,  # [R] int32 — cached-prefix length per row
    last_idx: torch.Tensor,  # [R] int32 — packed index of each row's last token
    paged: dict | None = None,  # {"tbl","k","v"} physical paging operand
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ragged chunked prefill: each layer attends every row's
    cached prefix plus its own causal segment, then writes the chunk's K/V
    at (slot, position). Reads come before writes in every layer. Pad
    tokens carry position S and write nothing (JAX drops those scatters;
    here they are masked out). Returns (logits [R, V] f32, cache_k,
    cache_v)."""
    L, B, _, S, hd = cache_k.shape
    Hkv, H = cfg.n_kv_heads, cfg.n_heads
    G = H // Hkv
    T = tokens.shape[0]
    R = slots.shape[0]
    dev = tokens.device
    rid = rowids.long()
    # packed row boundaries from the sorted rowids: offsets[r] = first packed
    # index of row r; offsets[R] = number of real tokens
    bounds = torch.arange(1, R + 1, device=dev)
    offsets = torch.cat(
        [torch.zeros(1, dtype=torch.int32, device=dev),
         (rid[None, :] < bounds[:, None]).sum(dim=1).to(torch.int32)]
    )
    # write targets: real tokens inside the cache (one host sync per call)
    keep = torch.nonzero((rid < R) & (positions < S)).squeeze(1)
    wslot = slots.long()[rid.clamp(max=R - 1)][keep]
    wpos = positions.long()[keep]

    h = _embed_in(cfg, params, tokens)  # [T, D]
    cos, sin = rope_tables(cfg, hd, positions)  # [T, hd/2]
    for li in range(L):
        lp = _layer(params, li)
        x = _norm(cfg, h, lp["attn_norm"])
        q, k, v = _qkv(cfg, lp, x)
        q = apply_rope(q.reshape(T, H, hd), cos, sin)
        k = apply_rope(k.reshape(T, Hkv, hd), cos, sin)
        v = v.reshape(T, Hkv, hd)
        ctx = ragged_prefill_attend_bf16(
            q.reshape(T, Hkv, G, hd).contiguous(), k.contiguous(), v.contiguous(),
            cache_k, cache_v, li, rowids, offsets, slots, starts, scale=cfg.attn_scale,
            **_paged_kw(paged),
        )
        h = _attn_residual(cfg, lp, ctx.reshape(T, H * hd), h)
        h = _ffn_residual(cfg, lp, h)
        # writes last: this layer's reads above saw the pre-write cache;
        # positional and table-free (private positions are identity-homed)
        cache_k[li][wslot, :, wpos] = k[keep].to(cache_k.dtype)
        cache_v[li][wslot, :, wpos] = v[keep].to(cache_v.dtype)
    last = h[torch.clamp(last_idx.long(), 0, T - 1)]  # [R, D]
    return _logits(cfg, params, last), cache_k, cache_v


@torch.no_grad()
def llama_decode_step(
    cfg: ModelConfig,
    params: Params,
    cache_k: torch.Tensor,  # [L, B, Hkv, S, hd] — updated in place
    cache_v: torch.Tensor,
    tokens: torch.Tensor,  # [Ba] int32 — last emitted token per row
    lengths: torch.Tensor,  # [Ba] int32 — position to write per row
    slot_ids: torch.Tensor | None = None,  # [Ba] int32 cache rows (None = 1:1)
    paged: dict | None = None,  # {"tbl","k","v"} physical paging operand
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One batched autoregressive step, with the structure of JAX's
    `_decode_step_bf16`: every layer reads the cache unchanged and
    `decode_attend_bf16` takes position lengths[b] from the step's exact
    K/V; the per-layer K/V rows stack up and ONE `append_kv_bf16` writes
    them after the last layer. Rows parked at lengths >= S write nothing.
    Returns (logits [Ba, V] f32, cache_k, cache_v)."""
    L, B, Hkv, S, hd = cache_k.shape
    Ba = tokens.shape[0]
    H = cfg.n_heads
    h = _embed_in(cfg, params, tokens)  # [Ba, D]
    cos, sin = rope_tables(cfg, hd, lengths)  # [Ba, hd/2]
    knew, vnew = [], []
    for li in range(L):
        lp = _layer(params, li)
        x = _norm(cfg, h, lp["attn_norm"])
        q, k, v = _qkv(cfg, lp, x)
        q = apply_rope(q.reshape(Ba, 1, H, hd), cos[:, None], sin[:, None])[:, 0]
        k = apply_rope(k.reshape(Ba, 1, Hkv, hd), cos[:, None], sin[:, None])[:, 0]
        v = v.reshape(Ba, Hkv, hd)
        ctx = decode_attend_bf16(
            q.reshape(Ba, Hkv, H // Hkv, hd).contiguous(), k.contiguous(), v.contiguous(),
            cache_k, cache_v, li, lengths, slot_ids=slot_ids, scale=cfg.attn_scale,
            **_paged_kw(paged),
        )
        h = _attn_residual(cfg, lp, ctx.reshape(Ba, H * hd), h)
        h = _ffn_residual(cfg, lp, h)
        knew.append(k)
        vnew.append(v)
    append_kv_bf16(
        cache_k, cache_v, torch.stack(knew), torch.stack(vnew), lengths, slot_ids=slot_ids
    )
    return _logits(cfg, params, h), cache_k, cache_v
