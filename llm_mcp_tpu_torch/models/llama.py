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

int8, as in the JAX package: a weight leaf may be `{"q", "s"}`
(`quant.py`; products through `qdot`, w8a8), the layers may carry the
fused `wqkv`/`w13`, and the KV cache may be the fused int8 form of
`init_kv_cache(quantized=True)`, `k = {"q", "s"}` with `v = {}`: then
prefill quantizes each layer's K/V into cache entries (`fuse_prompt_kv`),
ragged chunks read through `ragged_prefill_attend_q8` and write fused rows,
and decode steps take `_decode_step_q8`.

`paged={"tbl", "k", "v"}` (the physical block tables [B, nbs] and the
prefix pool [L, PXB, Hkv, bt, hd] of `executor/physical.py`) makes the
attention reads go through the tables. Writes stay table-free: they land
at private positions, which are identity-homed in the arena.

Tensor parallelism (`parallel/`): a rank runs these functions on its own
slice of the tree (JAX's Megatron specs, `parallel/sharding.py`) with a
config at its local head counts, inside `parallel.mesh.tp_scope`. The
collectives sit where GSPMD puts JAX's: the row-sharded `wo` and `w2`
products are summed over tp (`quant.qdot_rows`), the vocab-parallel
embedding is summed and the head's logits gathered (`_embed_in`,
`_logits`). Attention runs the port's kernels on the rank's local heads
(H/tp and Hkv/tp, G unchanged): JAX forces its XLA path under a mesh only
because an unwrapped `pallas_call` cannot take GSPMD arrays, and a rank's
shards here are plain local tensors.

MLA configs (kv_lora_rank > 0, the DeepSeek-V2 family) dispatch from each
entry point to `mla.py`, as in JAX; `_ffn_residual` runs a layer with a
"router" through `moe.moe_ffn` (Mixtral's layers and DeepSeek's MoE stack).

The family seams are JAX's: `_qkv` adds Qwen2's q/k/v biases and Qwen3's
per-head q/k norms, `_norm` Gemma's (1 + w) weights, the residuals Gemma-2's
post-norms, `_embed_in` its sqrt(dim) scale and `_logits` its logit
softcap. Prefill passes each layer's window (`layer_windows`), the score
softcap and `cfg.attn_scale` to the flash kernel. Windowed and softcapped
families never take the ragged chunk (the engine stages bucketed
`llama_prefill_chunk_batch` groups for them, which mask windows and cap
scores) nor the decode kernels: their decode step is `_decode_step_plain`,
JAX's XLA branch, in plain torch.

`llama_encode` runs the decoder as a text encoder (Qwen3-Embedding): the
prefill layers without a cache, pooled at each row's last token.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from ..kernels.attention import (
    decode_attend_bf16,
    decode_attend_q8,
    flash_prefill_attention,
    paged_gather,
    ragged_prefill_attend_bf16,
    ragged_prefill_attend_q8,
)
from ..ops.norms import rms_norm
from .quant import (
    INV127,
    embed_lookup_tp,
    logits_head_tp,
    pack_scales,
    qdot,
    qdot_rows,
    scale_pack_width,
)
from ..ops.rope import apply_rope, rope_tables
from .configs import ModelConfig

Params = dict[str, Any]

LAYER_KEYS = ("attn_norm", "ffn_norm", "wq", "wk", "wv", "wo", "w1", "w3", "w2")


def param_shapes(cfg: ModelConfig, fused: bool = False) -> dict[str, Any]:
    """Expected shape of every parameter, in the parameter tree's layout;
    with `fused`, the single-device layout of `quant.fuse_layer_weights`
    (`wqkv`, `w13` in place of wq/wk/wv and w1/w3). MLA configs
    (kv_lora_rank > 0) take `mla.mla_param_shapes`, encoders
    `embedder.embedder_param_shapes`."""
    if cfg.kv_lora_rank:
        from .mla import mla_param_shapes

        return mla_param_shapes(cfg, fused)
    if cfg.arch == "encoder":
        from .embedder import embedder_param_shapes

        return embedder_param_shapes(cfg)
    hd = cfg.resolved_head_dim
    L, D, H, Hkv, Fh, V = (
        cfg.n_layers, cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.ffn_hidden, cfg.vocab_size,
    )
    ls: dict[str, Any] = {
        "attn_norm": (L, D),
        "ffn_norm": (L, D),
        "wq": (L, D, H * hd),
        "wk": (L, D, Hkv * hd),
        "wv": (L, D, Hkv * hd),
        "wo": (L, H * hd, D),
    }
    if cfg.qkv_bias:
        ls.update(bq=(L, H * hd), bk=(L, Hkv * hd), bv=(L, Hkv * hd))
    if cfg.qk_norm:
        ls.update(q_norm=(L, hd), k_norm=(L, hd))
    if cfg.post_norms:
        ls.update(post_attn_norm=(L, D), post_ffn_norm=(L, D))
    if cfg.n_experts:  # Mixtral: routed banks in place of the dense FFN
        from .moe import moe_shapes

        ls.update(moe_shapes(cfg, L))
    else:
        ls.update(w1=(L, D, Fh), w3=(L, D, Fh), w2=(L, Fh, D))
    shapes: dict[str, Any] = {"embed": (V, D), "final_norm": (D,), "layers": ls}
    if fused:
        ls["wqkv"] = (L, D, (H + 2 * Hkv) * hd)
        for k in ("wq", "wk", "wv"):
            del ls[k]
        if cfg.qkv_bias:
            ls["bqkv"] = (L, (H + 2 * Hkv) * hd)
            for k in ("bq", "bk", "bv"):
                del ls[k]
        if "w1" in ls:
            ls["w13"] = (L, D, 2 * Fh)
            del ls["w1"], ls["w3"]
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
    exceeds one layer's slice. Norm weights start at 1 - norm_weight_offset
    (the identity scale of Gemma's (1 + w) norms too), biases at 0, the
    q/k norms at 1; Mixtral's routed banks come from
    `moe.init_moe_layer_params`. MLA configs take `mla.init_mla_params`."""
    if cfg.kv_lora_rank:
        from .mla import init_mla_params

        return init_mla_params(cfg, generator, dtype, device)
    shapes = param_shapes(cfg)

    def w(shape, fan_in):
        t = torch.empty(shape, dtype=dtype, device=device)
        for dst in t if len(shape) == 3 else [t]:  # one layer at a time
            r = torch.randn(dst.shape, generator=generator, dtype=torch.float32, device=device)
            dst.copy_(r * fan_in**-0.5)
        return t

    D = cfg.dim
    ls = shapes["layers"]

    def norm(shape):
        return torch.full(shape, 1.0 - cfg.norm_weight_offset, dtype=dtype, device=device)

    layers: Params = {}
    for name, shape in ls.items():
        if name in ("attn_norm", "ffn_norm", "post_attn_norm", "post_ffn_norm"):
            layers[name] = norm(shape)
        elif name in ("q_norm", "k_norm"):
            layers[name] = torch.ones(shape, dtype=dtype, device=device)
        elif name in ("bq", "bk", "bv"):
            layers[name] = torch.zeros(shape, dtype=dtype, device=device)
        elif name in ("wq", "wk", "wv", "wo", "w1", "w3", "w2"):
            layers[name] = w(shape, shape[1])
    if cfg.n_experts:
        from .moe import init_moe_layer_params

        layers.update(init_moe_layer_params(cfg, generator, dtype, cfg.n_layers, device))
    params: Params = {
        "embed": w(shapes["embed"], D),
        "layers": layers,
        "final_norm": norm(shapes["final_norm"]),
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
    quantized: bool = False,
) -> dict[str, Any]:
    """Zeroed KV cache buffers {"k", "v"}, each [L, B, Hkv, S, hd]; with
    `quantized` the fused int8 layout of the JAX package:

        k = {"q": int8 [L, B, 2*Hkv + p, S, hd], "s": dtype [L, B, 2*Hkv, S]}
        v = {}  (V rides k's head axis)

    Payload heads [0, Hkv) are K, [Hkv, 2*Hkv) V, and with p = 1
    (`scale_pack_width`) head 2*Hkv carries each position's scales
    bit-packed, so a decode kernel reads payload and scales of a position
    from one row block; "s" holds the same scales for every other reader.
    MLA configs hold latents instead (`mla.init_mla_cache`)."""
    if cfg.kv_lora_rank:
        from .mla import init_mla_cache

        return init_mla_cache(cfg, batch, max_seq, dtype, device, quantized)
    L, Hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    if quantized:
        p = scale_pack_width(Hkv, hd, dtype)
        return {
            "k": {
                "q": torch.zeros((L, batch, 2 * Hkv + p, max_seq, hd), dtype=torch.int8,
                                 device=device),
                "s": torch.zeros((L, batch, 2 * Hkv, max_seq), dtype=dtype, device=device),
            },
            "v": {},
        }
    shape = (L, batch, Hkv, max_seq, hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def quantize_kv(kv: torch.Tensor, scale_dtype: torch.dtype | None = None) -> dict:
    """K or V rows to the int8 cache form over the last (head_dim) axis:
    `s = max|x| * INV127` per row, `q = round(x / max(s, 1e-30))` (half
    to even), 0 where s == 0; the scales are cast to `scale_dtype` after
    the payload is divided by the float32 s."""
    f = kv.float()
    s = f.abs().amax(dim=-1) * INV127
    q = torch.where(
        s[..., None] > 0, torch.round(f / torch.clamp(s, min=1e-30)[..., None]),
        torch.zeros_like(f),
    ).to(torch.int8)
    return {"q": q, "s": s.to(scale_dtype or kv.dtype)}


def fuse_prompt_kv(kh: torch.Tensor, vh: torch.Tensor, scale_dtype=None) -> dict:
    """Prompt K/V rows [..., Hkv, S, hd] to the fused cache entry: one int8
    payload (K heads | V heads | the packed-scale pseudo-head when it
    fits) plus the plain scales [..., 2*Hkv, S]."""
    hd, Hkv = kh.shape[-1], kh.shape[-3]
    kq = quantize_kv(kh, scale_dtype=scale_dtype)
    vq = quantize_kv(vh, scale_dtype=scale_dtype)
    s = torch.cat([kq["s"], vq["s"]], dim=-2)
    pay = torch.cat([kq["q"], vq["q"]], dim=-3)
    if scale_pack_width(Hkv, hd, s.dtype):
        pay = torch.cat([pay, pack_scales(s, hd)], dim=-3)
    return {"q": pay, "s": s}


def _cache_shape(cache) -> tuple[int, ...]:
    return tuple(cache["q"].shape if isinstance(cache, dict) else cache.shape)


def _paged_kw(paged: dict | None) -> dict:
    """The bf16 attention wrappers' paged arguments from a `paged` operand."""
    if paged is None:
        return {}
    return {"block_tables": paged["tbl"], "pool_k": paged["k"], "pool_v": paged["v"]}


def _layer(params: Params, li: int) -> Params:
    return {
        k: {n: t[li] for n, t in v.items()} if isinstance(v, dict) else v[li]
        for k, v in params["layers"].items()
    }


def _norm(cfg: ModelConfig, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """RMSNorm with the family's weight: w, or Gemma's (1 + w) (the offset
    added in w's dtype, as in JAX)."""
    if cfg.norm_weight_offset:
        w = w + cfg.norm_weight_offset
    return rms_norm(x, w, cfg.norm_eps)


def _act(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu is the tanh approximation by default
    return F.gelu(x, approximate="tanh") if cfg.act == "gelu" else F.silu(x)


def _softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap if cap else x


def _qkv(cfg: ModelConfig, lp: Params, x: torch.Tensor):
    """Q/K/V projections on [..., D] activations, with Qwen2's biases and
    Qwen3's per-head RMSNorm over head_dim (before rope); flat outputs.
    The fused `wqkv` (and `bqkv`) is one product whose columns are the
    separate ones'."""
    hd = cfg.resolved_head_dim
    if "wqkv" in lp:
        nq, nk = cfg.n_heads * hd, cfg.n_kv_heads * hd
        qkv = qdot(x, lp["wqkv"])
        if cfg.qkv_bias:
            qkv = qkv + lp["bqkv"]
        q, k, v = qkv[..., :nq], qkv[..., nq: nq + nk], qkv[..., nq + nk:]
    else:
        q, k, v = qdot(x, lp["wq"]), qdot(x, lp["wk"]), qdot(x, lp["wv"])
        if cfg.qkv_bias:
            q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    if cfg.qk_norm:
        q = rms_norm(q.reshape(*q.shape[:-1], -1, hd), lp["q_norm"], cfg.norm_eps).reshape(q.shape)
        k = rms_norm(k.reshape(*k.shape[:-1], -1, hd), lp["k_norm"], cfg.norm_eps).reshape(k.shape)
    return q, k, v


def _attn_residual(cfg: ModelConfig, lp: Params, ctx: torch.Tensor, h: torch.Tensor):
    out = qdot_rows(ctx, lp["wo"])
    if cfg.post_norms:
        out = _norm(cfg, out, lp["post_attn_norm"])
    return h + out


def _ffn_residual(
    cfg: ModelConfig,
    lp: Params,
    h: torch.Tensor,
    moe_capacity: int = 0,
    moe_valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """The FFN half of a layer on [..., D] activations. It dispatches on the
    layer's own weights: a layer with a "router" is MoE (`moe.moe_ffn` over
    the flattened tokens; `moe_capacity` > 0 sets the capacity, decode
    passes the batch: dropless; `moe_valid` marks the tokens that route),
    DeepSeek's dense prologue layers have a gated MLP. Gemma-2's
    post-FFN norm applies before the residual add."""
    x = _norm(cfg, h, lp["ffn_norm"])
    if "router" in lp:
        from .moe import moe_ffn

        flat = x.reshape(-1, x.shape[-1])
        valid = None if moe_valid is None else moe_valid.reshape(-1)
        out = moe_ffn(cfg, lp, flat, capacity=moe_capacity or None, valid=valid).reshape(h.shape)
    elif "w13" in lp:
        g13 = qdot(x, lp["w13"])
        Fh = g13.shape[-1] // 2
        out = qdot_rows(_act(cfg, g13[..., :Fh]) * g13[..., Fh:], lp["w2"])
    else:
        out = qdot_rows(_act(cfg, qdot(x, lp["w1"])) * qdot(x, lp["w3"]), lp["w2"])
    if cfg.post_norms:
        out = _norm(cfg, out, lp["post_ffn_norm"])
    return h + out


def layer_windows(cfg: ModelConfig) -> list[int]:
    """Each layer's attention window (0: global). `sliding_pattern` 1: every
    layer slides (Mistral); p: every p-th layer is global (Gemma-2, p = 2)."""
    p = max(cfg.sliding_pattern, 1)
    return [cfg.sliding_window if cfg.sliding_window and (p == 1 or li % p != p - 1) else 0
            for li in range(cfg.n_layers)]


def plain_attention(cfg: ModelConfig) -> bool:
    """Whether decode steps and chunks take the plain-torch paths: windows
    and score softcaps are in no decode or ragged kernel, as in JAX (whose
    decode takes XLA and whose engine stages bucketed chunks for them)."""
    return bool(cfg.sliding_window or cfg.attn_softcap)


def _embed_in(cfg: ModelConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    h = embed_lookup_tp(params["embed"], tokens)
    if cfg.embed_scale:  # Gemma: sqrt(dim), rounded to the activation dtype first
        h = h * float(torch.tensor(cfg.dim**0.5, dtype=h.dtype))
    return h


def _logits(cfg: ModelConfig, params: Params, h: torch.Tensor) -> torch.Tensor:
    h = _norm(cfg, h, params["final_norm"])
    src = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return _softcap(logits_head_tp(src, h, tied=cfg.tie_embeddings), cfg.logit_softcap)


def prefill_layer(
    cfg: ModelConfig,
    lp: Params,
    h: torch.Tensor,  # [B, S, D]
    cos: torch.Tensor,
    sin: torch.Tensor,
    lengths: torch.Tensor,  # [B] int32
    window: int = 0,  # this layer's sliding window (0: global)
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """One decoder layer over full prompts; returns (h, (k, v)) with k/v in
    cache layout [B, Hkv, S, hd]. The flash kernel takes the layer's
    window, the score softcap and `cfg.attn_scale`; MoE routes only the
    tokens inside each prompt."""
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
        q.transpose(1, 2).contiguous(), kh, vh, lengths, window=window,
        softcap=cfg.attn_softcap, scale=cfg.attn_scale,
    )
    ctx = ctx.transpose(1, 2).reshape(B, S, H * hd)
    h = _attn_residual(cfg, lp, ctx, h)
    valid = torch.arange(S, device=h.device)[None, :] < lengths.long()[:, None]
    h = _ffn_residual(cfg, lp, h, moe_valid=valid if "router" in lp else None)
    return h, (kh, vh)


@torch.no_grad()
def llama_prefill(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,  # [B, S] int32 (right-padded prompts)
    lengths: torch.Tensor,  # [B] int32 true prompt lengths
    quant_kv: bool = False,
) -> tuple[torch.Tensor, Any, Any]:
    """Causal self-attention over fresh prompts (no past KV). Returns
    (last_logits [B, V] f32, k [L, B, Hkv, S, hd], v [...]); with
    `quant_kv` each layer's K/V is quantized as it is made into the fused
    cache entry form, k = {"q": [L, B, 2*Hkv+p, S, hd], "s": [L, B, 2*Hkv, S]}
    and v = {}, so the bf16 prompt KV of all layers never exists at once.
    MLA configs take `mla.mla_prefill`."""
    if cfg.kv_lora_rank:
        from .mla import mla_prefill

        return mla_prefill(cfg, params, tokens, lengths, quant_kv=quant_kv)
    B, S = tokens.shape
    h = _embed_in(cfg, params, tokens)
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)[None, :]
    cos, sin = rope_tables(cfg, cfg.resolved_head_dim, positions)
    ks, vs = [], []
    for li, win in enumerate(layer_windows(cfg)):
        h, (kh, vh) = prefill_layer(cfg, _layer(params, li), h, cos, sin, lengths, win)
        if quant_kv:
            ks.append(fuse_prompt_kv(kh, vh))
        else:
            ks.append(kh)
            vs.append(vh)
    # a row of length 0 reads the last position: JAX's take_along_axis at
    # index -1 wraps to S - 1
    last_idx = (lengths.long() - 1) % S
    last = h[torch.arange(B, device=h.device), last_idx]
    if quant_kv:
        return _logits(cfg, params, last), {
            "q": torch.stack([k["q"] for k in ks]), "s": torch.stack([k["s"] for k in ks])
        }, {}
    return _logits(cfg, params, last), torch.stack(ks), torch.stack(vs)


@torch.no_grad()
def llama_encode(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,  # [B, S] int32 (right-padded)
    lengths: torch.Tensor,  # [B] int32 true lengths
) -> torch.Tensor:
    """The causal decoder as a text encoder (Qwen3-Embedding: a Qwen3
    causal LM pooled at its last token): the hidden state at each row's
    last position, final-normed, in float32 and L2-normalized, [B, D].
    Each layer is `prefill_layer` (the flash kernel on the card, once per
    layer); its K/V are dropped as soon as it returns, since nothing is
    cached."""
    B, S = tokens.shape
    h = _embed_in(cfg, params, tokens)
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)[None, :]
    cos, sin = rope_tables(cfg, cfg.resolved_head_dim, positions)
    for li, win in enumerate(layer_windows(cfg)):
        h, _ = prefill_layer(cfg, _layer(params, li), h, cos, sin, lengths, win)
    last = h[torch.arange(B, device=h.device), (lengths.long() - 1) % S]
    e = _norm(cfg, last, params["final_norm"]).float()
    return e / torch.clamp(torch.linalg.vector_norm(e, dim=-1, keepdim=True), min=1e-9)


def ragged_write_targets(rowids, positions, slots, S: int) -> tuple:
    """(keep, wslot, wpos) of a packed ragged group: the packed indices of
    the tokens that write the cache (real rows, positions inside it) and
    the slot and position each writes. On the card, one host sync."""
    R = slots.shape[0]
    rid = rowids.long()
    keep = torch.nonzero((rid < R) & (positions < S)).squeeze(1)
    return keep, slots.long()[rid.clamp(max=R - 1)][keep], positions.long()[keep]


@torch.no_grad()
def llama_prefill_chunk_ragged(
    cfg: ModelConfig,
    params: Params,
    cache_k: Any,  # [L, B, Hkv, S, hd] or the fused int8 dict — updated in place
    cache_v: Any,
    tokens: torch.Tensor,  # [T] int32 — packed chunks, rows back to back
    rowids: torch.Tensor,  # [T] int32 — descriptor row per token, sorted; pads = R
    positions: torch.Tensor,  # [T] int32 — cache position per token; pads = S
    slots: torch.Tensor,  # [R] int32 — engine slot per descriptor row
    starts: torch.Tensor,  # [R] int32 — cached-prefix length per row
    last_idx: torch.Tensor,  # [R] int32 — packed index of each row's last token
    paged: dict | None = None,  # {"tbl","k","v"} physical paging operand
    writes: tuple | None = None,  # (keep, wslot, wpos): see ragged_write_targets
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ragged chunked prefill: each layer attends every row's
    cached prefix plus its own causal segment, then writes the chunk's K/V
    at (slot, position). Reads come before writes in every layer. Pad
    tokens carry position S and write nothing (JAX drops those scatters;
    here they are masked out). A fused int8 cache is read through
    `ragged_prefill_attend_q8` and written as `fuse_prompt_kv` rows.
    `writes` are the cache writes' targets when the caller has them (the
    engine builds them on the host); else they are found on the device,
    at one host sync. Returns (logits [R, V] f32, cache_k, cache_v). MLA
    configs take `mla.mla_prefill_chunk_ragged`. Windowed and softcapped
    families raise, as in JAX: the engine stages bucketed chunks for them."""
    if cfg.kv_lora_rank:
        from .mla import mla_prefill_chunk_ragged

        return mla_prefill_chunk_ragged(cfg, params, cache_k, cache_v, tokens, rowids,
                                        positions, slots, starts, last_idx, paged=paged,
                                        writes=writes)
    if plain_attention(cfg):
        raise NotImplementedError(
            "ragged prefill covers global-attention, no-softcap families; the engine stages "
            "bucketed chunks for the others"
        )
    quantized = isinstance(cache_k, dict)
    L, B, _, S, hd = _cache_shape(cache_k)
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
    keep, wslot, wpos = (ragged_write_targets(rowids, positions, slots, S) if writes is None
                         else (w.long() for w in writes))

    h = _embed_in(cfg, params, tokens)  # [T, D]
    cos, sin = rope_tables(cfg, hd, positions)  # [T, hd/2]
    for li in range(L):
        lp = _layer(params, li)
        x = _norm(cfg, h, lp["attn_norm"])
        q, k, v = _qkv(cfg, lp, x)
        q = apply_rope(q.reshape(T, H, hd), cos, sin)
        k = apply_rope(k.reshape(T, Hkv, hd), cos, sin)
        v = v.reshape(T, Hkv, hd)
        qg, k, v = q.reshape(T, Hkv, G, hd).contiguous(), k.contiguous(), v.contiguous()
        if quantized:
            ctx = ragged_prefill_attend_q8(
                qg, k, v, cache_k, li, rowids, offsets, slots, starts, scale=cfg.attn_scale,
                block_tables=None if paged is None else paged["tbl"],
                pool=None if paged is None else paged["k"],
            )
        else:
            ctx = ragged_prefill_attend_bf16(
                qg, k, v, cache_k, cache_v, li, rowids, offsets, slots, starts,
                scale=cfg.attn_scale, **_paged_kw(paged),
            )
        h = _attn_residual(cfg, lp, ctx.reshape(T, H * hd), h)
        h = _ffn_residual(cfg, lp, h, moe_valid=rid < R if "router" in lp else None)
        # writes last: this layer's reads above saw the pre-write cache;
        # positional and table-free (private positions are identity-homed)
        if quantized:
            rows = fuse_prompt_kv(k[keep].transpose(0, 1), v[keep].transpose(0, 1),
                                  scale_dtype=cache_k["s"].dtype)
            cache_k["q"][li][wslot, :, wpos] = rows["q"].transpose(0, 1)
            cache_k["s"][li][wslot, :, wpos] = rows["s"].T
        else:
            cache_k[li][wslot, :, wpos] = k[keep].to(cache_k.dtype)
            cache_v[li][wslot, :, wpos] = v[keep].to(cache_v.dtype)
    last = h[torch.clamp(last_idx.long(), 0, T - 1)]  # [R, D]
    return _logits(cfg, params, last), cache_k, cache_v


def chunk_write_targets(slots, starts, C: int, B: int, S: int) -> tuple:
    """(keep, wslot, wpos) of a batch of [A, C] chunks: the flat indices
    (a * C + c) of the positions that write the cache (rows whose slot is
    below B, positions below S) and the slot and position each writes.
    On the card, one host sync."""
    pos = starts.long()[:, None] + torch.arange(C, device=slots.device)[None, :]
    live = (slots.long() < B)[:, None] & (pos < S)
    keep = torch.nonzero(live.reshape(-1)).squeeze(1)
    return keep, slots.long()[:, None].expand_as(pos).reshape(-1)[keep], pos.reshape(-1)[keep]


def past_rows(arena, pool, rows, tbl, Sk: int, nbs: int | None = None):
    """Each chunk row's past cache rows [0, Sk) of one layer: contiguous
    (arena [B, Hx, S, *rest] at `rows`), or through the block tables `tbl`
    [A, nsel] (`paged_gather`; pool [PXB, Hx, bt, *rest]). Returns
    [A, Hx, Sk, *rest]."""
    if tbl is None:
        return arena[rows, :, :Sk]
    return paged_gather(arena, pool, tbl, nbs=nbs)[:, :, :Sk]


@torch.no_grad()
def llama_prefill_chunk_batch(
    cfg: ModelConfig,
    params: Params,
    cache_k: Any,  # [L, B, Hkv, S, hd] or the fused int8 dict — updated in place
    cache_v: Any,
    tokens: torch.Tensor,  # [A, C] int32 — right-padded chunks, one per row
    slots: torch.Tensor,  # [A] int32 — engine slot per row (pads: B, writes nothing)
    starts: torch.Tensor,  # [A] int32 — absolute position of each chunk's first token
    nvalid: torch.Tensor,  # [A] int32 — valid tokens per chunk
    skey: int = 0,  # bound on the PAST key range (0 = whole S); >= max(starts)
    all_logits: bool = False,  # logits at every chunk position, not just the last
    paged: dict | None = None,  # {"tbl","k","v"} physical paging operand
    writes: tuple | None = None,  # (keep, wslot, wpos): see chunk_write_targets
) -> tuple[torch.Tensor, Any, Any]:
    """Batched chunked prefill, JAX's `llama_prefill_chunk_batch`: one
    chunk of C tokens for each of A slots, each attending its slot's past
    rows [0, starts) and itself causally under one joint softmax.

    Every layer reads first and writes after: the past rows come from the
    cache as the layer found it (through the block tables with `paged`;
    dequantized after the dot over the fused int8 cache), while the chunk's
    own K/V come straight from the projection, exact even over an int8
    cache. Then the chunk's C rows are written at [starts, starts + C)
    (fused int8 rows over an int8 cache), the positions past `nvalid` too,
    as JAX writes them; later steps overwrite them. Windows (each layer's
    `layer_windows` entry) and the score softcap apply as in JAX. Plain
    torch, as JAX computes it outside any Pallas kernel. Pad rows carry slot B: they
    read slot B - 1 and write nothing. `writes` are the write targets when
    the caller has them (else found on the device at one host sync).
    Returns (logits [A, V] f32 at each row's last valid position, or
    [A, C, V] at every position with `all_logits` (the speculative verify
    scores each draft against the position before it), cache_k, cache_v).
    MLA configs take `mla.mla_prefill_chunk_batch`."""
    if cfg.kv_lora_rank:
        from .mla import mla_prefill_chunk_batch

        return mla_prefill_chunk_batch(cfg, params, cache_k, cache_v, tokens, slots, starts,
                                       nvalid, skey=skey, all_logits=all_logits, paged=paged,
                                       writes=writes)
    quantized = isinstance(cache_k, dict)
    L, B, _, S, hd = _cache_shape(cache_k)
    Hkv, H = cfg.n_kv_heads, cfg.n_heads
    G = H // Hkv
    A, C = tokens.shape
    Sk = min(skey, S) if skey else S
    dev = tokens.device
    rows = slots.long().clamp(max=B - 1)
    starts_l = starts.long()
    keep, wslot, wpos = (chunk_write_targets(slots, starts, C, B, S) if writes is None
                         else (w.long() for w in writes))
    tbl = nbs = None
    if paged is not None:
        nbs = paged["tbl"].shape[1]
        tbl = paged["tbl"].index_select(0, rows)[:, :max(1, -(-Sk // (S // nbs)))]

    h = _embed_in(cfg, params, tokens)  # [A, C, D]
    q_pos = starts_l[:, None] + torch.arange(C, device=dev)[None, :]  # [A, C]
    cos, sin = rope_tables(cfg, hd, q_pos)
    key_pos = torch.arange(Sk, device=dev)
    past_mask = (key_pos[None, None, :] < starts_l[:, None, None]).expand(A, C, Sk)
    c_idx = torch.arange(C, device=dev)
    self_mask = (c_idx[None, :] <= c_idx[:, None])[None].expand(A, C, C)
    neg = torch.tensor(-1e30, dtype=torch.float32, device=dev)
    for li, win in enumerate(layer_windows(cfg)):
        lp = _layer(params, li)
        x = _norm(cfg, h, lp["attn_norm"])
        q, k, v = _qkv(cfg, lp, x)
        q = apply_rope(q.reshape(A, C, H, hd), cos, sin)
        k = apply_rope(k.reshape(A, C, Hkv, hd), cos, sin)
        v = v.reshape(A, C, Hkv, hd)
        kh = k.transpose(1, 2)  # [A, Hkv, C, hd]
        vh = v.transpose(1, 2)
        qg = q.reshape(A, C, Hkv, G, hd)

        # reads first: the past rows from the cache as this layer found it
        if quantized:
            pk = None if paged is None else paged["k"]
            pays = past_rows(cache_k["q"][li], None if pk is None else pk["q"][li], rows, tbl,
                             Sk, nbs)[:, : 2 * Hkv]  # [A, 2*Hkv, Sk, hd] int8
            srows = past_rows(cache_k["s"][li], None if pk is None else pk["s"][li], rows, tbl,
                              Sk, nbs).float()  # [A, 2*Hkv, Sk]
            krows, vrows = pays[:, :Hkv], pays[:, Hkv:]
            ksr, vsr = srows[:, :Hkv], srows[:, Hkv:]
        else:
            krows = past_rows(cache_k[li], None if paged is None else paged["k"][li], rows, tbl,
                              Sk, nbs)
            vrows = past_rows(cache_v[li], None if paged is None else paged["v"][li], rows, tbl,
                              Sk, nbs)
        s_past = torch.einsum("achgd,ahsd->ahgcs", qg, krows.to(h.dtype)).float()
        if quantized:
            s_past = s_past * ksr[:, :, None, None, :]  # dequantized after the dot
        s_self = torch.einsum("achgd,ahtd->ahgct", qg, kh).float()
        s_past = _softcap(s_past * cfg.attn_scale, cfg.attn_softcap)
        s_self = _softcap(s_self * cfg.attn_scale, cfg.attn_softcap)
        pm, sm = past_mask, self_mask
        if win:  # q_pos - k_pos < window, in both segments
            pm = pm & (q_pos[:, :, None] - key_pos[None, None, :] < win)
            sm = sm & (c_idx[None, :] - c_idx[:, None] > -win)[None]
        s_past = torch.where(pm[:, None, None], s_past, neg)
        s_self = torch.where(sm[:, None, None], s_self, neg)
        probs = torch.softmax(torch.cat([s_past, s_self], dim=-1), dim=-1)
        p_past, p_self = probs[..., :Sk], probs[..., Sk:]
        if quantized:
            p_past = p_past * vsr[:, :, None, None, :]
        ctx = (torch.einsum("ahgcs,ahsd->achgd", p_past.to(h.dtype), vrows.to(h.dtype))
               + torch.einsum("ahgct,ahtd->achgd", p_self.to(h.dtype), vh))
        h = _attn_residual(cfg, lp, ctx.reshape(A, C, H * hd), h)
        h = _ffn_residual(cfg, lp, h, moe_valid=c_idx[None, :] < nvalid.long()[:, None])

        # writes last, positional and table-free (private positions are
        # identity-homed)
        if quantized:
            fused = fuse_prompt_kv(kh, vh, scale_dtype=cache_k["s"].dtype)
            cache_k["q"][li][wslot, :, wpos] = fused["q"].transpose(1, 2).reshape(
                A * C, -1, hd)[keep]
            cache_k["s"][li][wslot, :, wpos] = fused["s"].transpose(1, 2).reshape(A * C, -1)[keep]
        else:
            cache_k[li][wslot, :, wpos] = k.reshape(A * C, Hkv, hd)[keep].to(cache_k.dtype)
            cache_v[li][wslot, :, wpos] = v.reshape(A * C, Hkv, hd)[keep].to(cache_v.dtype)
    if all_logits:
        return _logits(cfg, params, h), cache_k, cache_v  # [A, C, V]
    last = h[torch.arange(A, device=dev), (nvalid.long() - 1).clamp(0, C - 1)]
    return _logits(cfg, params, last), cache_k, cache_v


def _decode_step_q8(
    cfg: ModelConfig,
    params: Params,
    cache_k: dict,  # fused int8 cache — updated in place
    cache_v: dict,  # {}
    tokens: torch.Tensor,
    lengths: torch.Tensor,
    slot_ids: torch.Tensor | None = None,
    paged: dict | None = None,
    arrivals: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict, dict]:
    """Decode step over the fused int8 cache, JAX's `_decode_step_q8`:
    `decode_attend_q8` per layer over the cache as the step found it
    (position lengths[b] from the exact K/V), which also quantizes and
    writes that layer's new row (`append=True`): the bytes of JAX's one
    `append_kv_q8` after the last layer, since layer li's rows are read by
    layer li's call alone, before its write. `arrivals`: the caller's
    split-arrival buffer for the kernel (`decode_attend_q8`)."""
    _, _, _, S, hd = _cache_shape(cache_k)
    Ba = tokens.shape[0]
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    h = _embed_in(cfg, params, tokens)  # [Ba, D]
    cos, sin = rope_tables(cfg, hd, lengths)  # [Ba, hd/2]
    for li in range(cfg.n_layers):
        lp = _layer(params, li)
        x = _norm(cfg, h, lp["attn_norm"])
        q, k, v = _qkv(cfg, lp, x)
        q = apply_rope(q.reshape(Ba, 1, H, hd), cos[:, None], sin[:, None])[:, 0]
        k = apply_rope(k.reshape(Ba, 1, Hkv, hd), cos[:, None], sin[:, None])[:, 0]
        v = v.reshape(Ba, Hkv, hd)
        ctx = decode_attend_q8(
            q.reshape(Ba, Hkv, H // Hkv, hd).contiguous(), k.contiguous(), v.contiguous(),
            cache_k, cache_v, li, lengths, slot_ids=slot_ids, scale=cfg.attn_scale,
            block_tables=None if paged is None else paged["tbl"],
            pool_k=None if paged is None else paged["k"], append=True, arrivals=arrivals,
        )
        h = _attn_residual(cfg, lp, ctx.reshape(Ba, H * hd), h)
        h = _ffn_residual(cfg, lp, h, moe_capacity=Ba)  # dropless at decode
    return _logits(cfg, params, h), cache_k, cache_v


def _decode_step_plain(
    cfg: ModelConfig,
    params: Params,
    cache_k: Any,  # [L, B, Hkv, S, hd] or the fused int8 dict — updated in place
    cache_v: Any,
    tokens: torch.Tensor,
    lengths: torch.Tensor,
    slot_ids: torch.Tensor | None = None,
    paged: dict | None = None,
) -> tuple[torch.Tensor, Any, Any]:
    """Decode step of the windowed and softcapped families, JAX's XLA
    branch of `llama_decode_step` in plain torch: each layer first writes
    the step's K/V at position lengths[b] (quantized into a fused row over
    an int8 cache), then attends positions <= lengths[b] of its cache row
    (through the block tables with `paged`), inside the layer's window,
    with the score softcap. Rows parked at lengths >= S write back what
    their position S - 1 holds (JAX drops those writes; a host-free mask
    here, so the step can be captured). Reads nothing on the host."""
    quantized = isinstance(cache_k, dict)
    _, B, _, S, hd = _cache_shape(cache_k)
    Ba = tokens.shape[0]
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    G = H // Hkv
    dev = tokens.device
    rows = torch.arange(B, device=dev) if slot_ids is None else slot_ids.long()
    lens = lengths.long()
    live = lens < S
    wpos = lens.clamp(max=S - 1)
    key_pos = torch.arange(S, device=dev)[None, :]
    tbl = None if paged is None else paged["tbl"].index_select(0, rows)
    h = _embed_in(cfg, params, tokens)  # [Ba, D]
    cos, sin = rope_tables(cfg, hd, lengths)

    def write(arena, new):  # arena [B, Hx, S, *rest], new [Ba, Hx, *rest]
        old = arena[rows, :, wpos]
        keep = live.reshape(Ba, *([1] * (new.dim() - 1)))
        arena[rows, :, wpos] = torch.where(keep, new.to(arena.dtype), old)

    def rows_of(arena, pool):  # each row's [Hx, S, *rest], through the tables
        return arena[rows] if tbl is None else paged_gather(arena, pool, tbl)

    for li, win in enumerate(layer_windows(cfg)):
        lp = _layer(params, li)
        x = _norm(cfg, h, lp["attn_norm"])
        q, k, v = _qkv(cfg, lp, x)
        q = apply_rope(q.reshape(Ba, 1, H, hd), cos[:, None], sin[:, None])[:, 0]
        k = apply_rope(k.reshape(Ba, 1, Hkv, hd), cos[:, None], sin[:, None])[:, 0]
        v = v.reshape(Ba, Hkv, hd)
        qg = q.reshape(Ba, Hkv, G, hd)
        if quantized:
            kq = quantize_kv(k, scale_dtype=cache_k["s"].dtype)
            vq = quantize_kv(v, scale_dtype=cache_k["s"].dtype)
            s_new = torch.cat([kq["s"], vq["s"]], dim=1)  # [Ba, 2*Hkv]
            pay = torch.cat([kq["q"], vq["q"]], dim=1)  # [Ba, 2*Hkv, hd]
            if cache_k["q"].shape[2] > 2 * Hkv:  # the packed pseudo-head too
                pay = torch.cat([pay, pack_scales(s_new[..., None], hd)[..., 0, :]], dim=1)
            write(cache_k["q"][li], pay)
            write(cache_k["s"][li], s_new)
            pk = None if paged is None else paged["k"]
            payl = rows_of(cache_k["q"][li], None if pk is None else pk["q"][li])
            ssl = rows_of(cache_k["s"][li], None if pk is None else pk["s"][li]).float()
            ck, cv = payl[:, :Hkv].to(h.dtype), payl[:, Hkv: 2 * Hkv].to(h.dtype)
            ks, vs = ssl[:, :Hkv], ssl[:, Hkv:]
        else:
            write(cache_k[li], k)
            write(cache_v[li], v)
            ck = rows_of(cache_k[li], None if paged is None else paged["k"][li])
            cv = rows_of(cache_v[li], None if paged is None else paged["v"][li])
        scores = torch.einsum("bhgd,bhsd->bhgs", qg, ck).float()
        if quantized:
            scores = scores * ks[:, :, None, :]
        scores = _softcap(scores * cfg.attn_scale, cfg.attn_softcap)
        m = key_pos <= lens[:, None]
        if win:
            m = m & (key_pos > lens[:, None] - win)
        probs = torch.softmax(torch.where(m[:, None, None, :], scores, -1e30), dim=-1)
        if quantized:
            probs = probs * vs[:, :, None, :]
        ctx = torch.einsum("bhgs,bhsd->bhgd", probs.to(h.dtype), cv).reshape(Ba, H * hd)
        h = _attn_residual(cfg, lp, ctx, h)
        h = _ffn_residual(cfg, lp, h, moe_capacity=Ba)
    return _logits(cfg, params, h), cache_k, cache_v


@torch.no_grad()
def llama_decode_step(
    cfg: ModelConfig,
    params: Params,
    cache_k: Any,  # [L, B, Hkv, S, hd] or the fused int8 dict — updated in place
    cache_v: Any,
    tokens: torch.Tensor,  # [Ba] int32 — last emitted token per row
    lengths: torch.Tensor,  # [Ba] int32 — position to write per row
    slot_ids: torch.Tensor | None = None,  # [Ba] int32 cache rows (None = 1:1)
    paged: dict | None = None,  # {"tbl","k","v"} physical paging operand
    arrivals: torch.Tensor | None = None,  # the int8 decode kernel's arrival buffer
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One batched autoregressive step, with the structure of JAX's
    `_decode_step_bf16`: every layer reads the cache as the step found it
    and `decode_attend_bf16` takes position lengths[b] from the step's
    exact K/V, and also writes that layer's K/V rows (`append=True`): the
    bytes of JAX's one `append_kv_bf16` after the last layer, since layer
    li's rows are read by layer li's call alone, before its write. Rows
    parked at lengths >= S write nothing.
    A fused int8 cache takes `_decode_step_q8`, MLA configs
    `mla.mla_decode_step`, windowed and softcapped families
    `_decode_step_plain`. Returns (logits [Ba, V] f32, cache_k, cache_v)."""
    if cfg.kv_lora_rank:
        from .mla import mla_decode_step

        return mla_decode_step(cfg, params, cache_k, cache_v, tokens, lengths, slot_ids, paged)
    if plain_attention(cfg):
        return _decode_step_plain(cfg, params, cache_k, cache_v, tokens, lengths, slot_ids,
                                  paged)
    if isinstance(cache_k, dict):
        return _decode_step_q8(cfg, params, cache_k, cache_v, tokens, lengths, slot_ids, paged,
                               arrivals)
    L, B, Hkv, S, hd = cache_k.shape
    Ba = tokens.shape[0]
    H = cfg.n_heads
    h = _embed_in(cfg, params, tokens)  # [Ba, D]
    cos, sin = rope_tables(cfg, hd, lengths)  # [Ba, hd/2]
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
            **_paged_kw(paged), append=True,
        )
        h = _attn_residual(cfg, lp, ctx.reshape(Ba, H * hd), h)
        h = _ffn_residual(cfg, lp, h, moe_capacity=Ba)  # dropless at decode
    return _logits(cfg, params, h), cache_k, cache_v
