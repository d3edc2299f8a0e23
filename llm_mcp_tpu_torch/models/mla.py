"""Multi-head Latent Attention, DeepSeek-V2 style (counterpart of
`llm_mcp_tpu/models/mla.py`).

The KV cache holds one shared latent (kv_lora_rank = R) and one shared
rope key (qk_rope_head_dim = dr) per token, in the engine's (k, v) pair
convention: k = latents [L, B, 1, S, R], v = rope keys [L, B, 1, S, dr]
(the fake one-head axis keeps every slot path of the engine unchanged).
At int8 each is its own {"q": int8, "s": [L, B, 1, S]} dict; unlike the
GQA cache the two are not fused.

  - Admission prefill (`mla_prefill`) runs EXPANDED, in query blocks:
    per-head K/V re-made from the latents once, scores for one block of
    queries at a time. Plain torch, as JAX leaves it to XLA.
  - Ragged chunks and decode run ABSORBED: q̃ = q_nope @ W_uk per head
    scores straight against the latents, and only the attended [H, R]
    context re-expands through W_uv. Ragged chunks go through
    `ragged_prefill_attend_mla`; int8 decode through `decode_attend_q8_mla`
    over the pre-append cache (position w takes the exact vectors), with
    one batched append after the layers; bf16 decode appends and then
    attends in plain torch, as JAX's XLA arm does.

With `first_dense_layers` (DeepSeek-V2), params["dense_layers"] holds the
dense-FFN layers before the MoE stack params["layers"]; they run first and
the cache's layer index counts across both. `q_lora_rank > 0` (the
low-rank query path) is refused, as in JAX.
"""

from __future__ import annotations

from typing import Any, Iterator

import torch

from ..kernels.attention import decode_attend_q8_mla, paged_gather, ragged_prefill_attend_mla
from ..ops.rope import apply_rope, rope_tables
from .configs import ModelConfig
from .llama import (
    _embed_in,
    _ffn_residual,
    _logits,
    _norm,
    chunk_write_targets,
    past_rows,
    quantize_kv,
    ragged_write_targets,
)
from .moe import init_moe_layer_params, moe_shapes
from .quant import qdot

Params = dict[str, Any]
NEG_INF = -1e30


def _dims(cfg: ModelConfig) -> tuple[int, int, int, int]:
    """(n_heads, qk_nope, qk_rope, v_dim)."""
    return cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim


def mla_scale(cfg: ModelConfig) -> float:
    """Softmax scale: (dn + dr)^-1/2 times yarn's magnitude correction."""
    return (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5 * cfg.yarn_attn_mscale


def _check_dense_q(cfg: ModelConfig) -> None:
    if cfg.q_lora_rank:
        raise ValueError(
            "q_lora_rank > 0 (low-rank query path) is not implemented; use the "
            "dense-q MLA variant (q_lora_rank=0, V2-Lite style)"
        )


def dense_depth(cfg: ModelConfig) -> int:
    """Layers of the dense prologue (params["dense_layers"])."""
    return cfg.first_dense_layers if cfg.n_experts else 0


def mla_attn_shapes(cfg: ModelConfig, L: int) -> dict[str, tuple]:
    """Stacked [L, ...] MLA attention weights (dense-q factorization)."""
    H, dn, dr, dv = _dims(cfg)
    D, R = cfg.dim, cfg.kv_lora_rank
    return {
        "wq_mla": (L, D, H * (dn + dr)),
        # one product makes (latent | shared rope key), HF kv_a_proj_with_mqa
        "w_dkv": (L, D, R + dr),
        "kv_norm": (L, R),
        # latent up-projection to per-head (k_nope | v)
        "w_ukv": (L, R, H * (dn + dv)),
        "wo_mla": (L, H * dv, D),
    }


def mla_param_shapes(cfg: ModelConfig, fused: bool = False) -> dict[str, Any]:
    """Shape of every parameter of an MLA tree; `fused`: w1|w3 as `w13`
    in the blocks that have a dense FFN (`quant.fuse_layer_weights`)."""
    D, Fh, V = cfg.dim, cfg.ffn_hidden, cfg.vocab_size
    k = dense_depth(cfg)

    def block(L: int, moe: bool) -> dict[str, tuple]:
        b = {"attn_norm": (L, D), "ffn_norm": (L, D), **mla_attn_shapes(cfg, L)}
        if moe:
            b.update(moe_shapes(cfg, L))
        elif fused:
            b["w13"] = (L, D, 2 * Fh)
            b["w2"] = (L, Fh, D)
        else:
            b.update({"w1": (L, D, Fh), "w3": (L, D, Fh), "w2": (L, Fh, D)})
        return b

    shapes: dict[str, Any] = {
        "embed": (V, D),
        "final_norm": (D,),
        "layers": block(cfg.n_layers - k, bool(cfg.n_experts)),
    }
    if k:
        shapes["dense_layers"] = block(k, False)
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (D, V)
    return shapes


def init_mla_params(
    cfg: ModelConfig,
    generator: torch.Generator,
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cpu",
) -> Params:
    """Random MLA decoder weights, fan-in scaled normals from `generator`,
    made one [in, out] matrix at a time on `device`; norm weights 1."""
    _check_dense_q(cfg)
    shapes = mla_param_shapes(cfg)

    def w(shape, fan_in=None):  # fan-in: the [in, out] matrix's in
        t = torch.empty(shape, dtype=dtype, device=device)
        for dst in t.reshape(-1, *shape[-2:]):
            r = torch.randn(dst.shape, generator=generator, dtype=torch.float32, device=device)
            dst.copy_(r * (fan_in or shape[-2]) ** -0.5)
        return t

    def block(spec: dict[str, tuple]) -> Params:
        out: Params = {}
        moe = moe_shapes(cfg, spec["attn_norm"][0]) if "router" in spec else {}
        for name, shape in spec.items():
            if name in ("attn_norm", "ffn_norm", "kv_norm"):
                out[name] = torch.ones(shape, dtype=dtype, device=device)
            elif name not in moe:
                out[name] = w(shape)
        if moe:  # the MoE weights, routed banks included
            out.update(init_moe_layer_params(cfg, generator, dtype, spec["attn_norm"][0], device))
        return out

    params: Params = {
        "embed": w(shapes["embed"], cfg.dim),
        "layers": block(shapes["layers"]),
        "final_norm": torch.ones(shapes["final_norm"], dtype=dtype, device=device),
    }
    if "dense_layers" in shapes:
        params["dense_layers"] = block(shapes["dense_layers"])
    if "lm_head" in shapes:
        params["lm_head"] = w(shapes["lm_head"])
    return params


def init_mla_cache(
    cfg: ModelConfig,
    batch: int,
    max_seq: int,
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cpu",
    quantized: bool = False,
) -> dict[str, Any]:
    """Zeroed latent cache: k = latents [L, B, 1, S, R], v = rope keys
    [L, B, 1, S, dr]; with `quantized` each an int8 payload and its
    per-token scales {"q", "s": [L, B, 1, S]}."""
    L, R, dr = cfg.n_layers, cfg.kv_lora_rank, cfg.qk_rope_head_dim

    def plane(width: int):
        if quantized:
            return {
                "q": torch.zeros((L, batch, 1, max_seq, width), dtype=torch.int8, device=device),
                "s": torch.zeros((L, batch, 1, max_seq), dtype=dtype, device=device),
            }
        return torch.zeros((L, batch, 1, max_seq, width), dtype=dtype, device=device)

    return {"k": plane(R), "v": plane(dr)}


def layer_params(params: Params) -> Iterator[Params]:
    """Each layer's weights in order: the dense prologue, then the stack."""
    for key in ("dense_layers", "layers"):
        blk = params.get(key)
        if blk is None:
            continue
        for i in range(blk["attn_norm"].shape[0]):
            yield {k: {n: t[i] for n, t in v.items()} if isinstance(v, dict) else v[i]
                   for k, v in blk.items()}


def _latents(cfg: ModelConfig, lp: Params, x: torch.Tensor):
    """x [..., D] -> (c_kv [..., R] normed, k_rope [..., dr] before rope)."""
    R = cfg.kv_lora_rank
    ckr = qdot(x, lp["w_dkv"])
    c = _norm(cfg, ckr[..., :R], lp["kv_norm"])
    return c, ckr[..., R:]


def _queries(cfg: ModelConfig, lp: Params, x: torch.Tensor):
    """x [..., D] -> (q_nope [..., H, dn], q_rope [..., H, dr])."""
    H, dn, dr, _ = _dims(cfg)
    q = qdot(x, lp["wq_mla"]).reshape(*x.shape[:-1], H, dn + dr)
    return q[..., :dn], q[..., dn:]


def _absorbed_w(cfg: ModelConfig, lp: Params, dtype: torch.dtype):
    """(W_uk [R, H, dn], W_uv [R, H, dv]) from the layer's up-projection,
    dequantized once per call when int8 (in `dtype`, as JAX does)."""
    H, dn, _, dv = _dims(cfg)
    w = lp["w_ukv"]
    if isinstance(w, dict):
        w = w["q"].to(dtype) * w["s"].to(dtype)
    w = w.reshape(cfg.kv_lora_rank, H, dn + dv)
    return w[:, :, :dn], w[:, :, dn:]


def _stack_cache(rows: list, quantized: bool):
    """Per-layer [B, S, w] rows (or their quantize_kv dicts) to the engine
    layout [L, B, 1, S, w]."""
    if quantized:
        return {"q": torch.stack([r["q"] for r in rows])[:, :, None],
                "s": torch.stack([r["s"] for r in rows])[:, :, None]}
    return torch.stack(rows)[:, :, None]


@torch.no_grad()
def mla_prefill(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,  # [B, S] int32 right-padded prompts
    lengths: torch.Tensor,  # [B] int32 true lengths
    quant_kv: bool = False,  # int8 latents, quantized inside the layer loop
) -> tuple[torch.Tensor, Any, Any]:
    """Causal prefill with query-blocked expanded attention: per-head K/V
    are re-made once (O(S) memory), scores exist for one block of queries
    at a time. Returns (last logits [B, V] f32, latents [L, B, 1, S, R],
    rope keys [L, B, 1, S, dr]), the cache rows of the prompts (after
    rope), int8 dicts with `quant_kv`."""
    H, dn, dr, dv = _dims(cfg)
    B, S = tokens.shape
    scale = mla_scale(cfg)
    dev = tokens.device
    h = _embed_in(cfg, params, tokens)  # [B, S, D]
    positions = torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    cos, sin = rope_tables(cfg, dr, positions)  # [1, S, dr/2]
    key_pos = torch.arange(S, device=dev)
    valid_k = key_pos[None, :] < lengths.long()[:, None]  # [B, S]
    QB = next(c for c in (256, 128, 64, 32, 16, 8, 4, 2, 1) if S % c == 0)
    cs, krs = [], []
    for lp in layer_params(params):
        x = _norm(cfg, h, lp["attn_norm"])
        qn, qr = _queries(cfg, lp, x)  # [B, S, H, dn/dr]
        qr = apply_rope(qr, cos, sin)
        c, kr = _latents(cfg, lp, x)  # [B, S, R], [B, S, dr]
        kr = apply_rope(kr[..., None, :], cos, sin)[..., 0, :]
        kv = qdot(c, lp["w_ukv"]).reshape(B, S, H, dn + dv)
        kn, v = kv[..., :dn], kv[..., dn:]
        ctx = torch.empty((B, S, H, dv), dtype=h.dtype, device=dev)
        for q0 in range(0, S, QB):
            qp = key_pos[q0: q0 + QB]
            scores = (
                torch.einsum("bqhd,bkhd->bhqk", qn[:, q0: q0 + QB], kn)
                + torch.einsum("bqhd,bkd->bhqk", qr[:, q0: q0 + QB], kr)
            ).float() * scale
            mask = (key_pos[None, :] <= qp[:, None])[None, None] & valid_k[:, None, None, :]
            scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
            probs = torch.softmax(scores, dim=-1).to(h.dtype)
            ctx[:, q0: q0 + QB] = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        h = h + qdot(ctx.reshape(B, S, H * dv), lp["wo_mla"])
        h = _ffn_residual(cfg, lp, h, moe_valid=valid_k)
        if quant_kv:
            cs.append(quantize_kv(c))
            krs.append(quantize_kv(kr))
        else:
            cs.append(c)
            krs.append(kr)
    last = torch.clamp(lengths.long() - 1, 0, S - 1)
    h_last = h[torch.arange(B, device=dev), last]
    return _logits(cfg, params, h_last), _stack_cache(cs, quant_kv), _stack_cache(krs, quant_kv)


@torch.no_grad()
def mla_prefill_chunk_ragged(
    cfg: ModelConfig,
    params: Params,
    cache_c: Any,  # latents [L, B, 1, S, R] or the int8 dict — updated in place
    cache_r: Any,  # rope keys [L, B, 1, S, dr] or the int8 dict — updated in place
    tokens: torch.Tensor,  # [T] int32 — packed chunks, rows back to back
    rowids: torch.Tensor,  # [T] int32 — descriptor row per token, sorted; pads = R
    positions: torch.Tensor,  # [T] int32 — cache position per token; pads = S
    slots: torch.Tensor,  # [R] int32
    starts: torch.Tensor,  # [R] int32 — cached-prefix length per row
    last_idx: torch.Tensor,  # [R] int32 — packed index of each row's last token
    paged: dict | None = None,  # {"tbl","k","v"}: tables, latent pool, rope pool
    writes: tuple | None = None,  # (keep, wslot, wpos): llama.ragged_write_targets
) -> tuple[torch.Tensor, Any, Any]:
    """Ragged chunked prefill, absorbed: each layer attends every row's
    cached prefix (latents and rope keys, through the tables when paged)
    and its own causal segment (the chunk's exact latents) through
    `ragged_prefill_attend_mla`, then writes the chunk's latents and rope
    keys at (slot, position), quantized at int8. Reads come before writes
    in every layer; pads (position S) write nothing. Returns (logits
    [R, V] f32 at each row's last token, cache_c, cache_r)."""
    H, dn, dr, dv = _dims(cfg)
    quantized = isinstance(cache_c, dict)
    S = (cache_c["q"] if quantized else cache_c).shape[3]
    T = tokens.shape[0]
    R = slots.shape[0]
    scale = mla_scale(cfg)
    dev = tokens.device
    rid = rowids.long()
    bounds = torch.arange(1, R + 1, device=dev)
    offsets = torch.cat(
        [torch.zeros(1, dtype=torch.int32, device=dev),
         (rid[None, :] < bounds[:, None]).sum(dim=1).to(torch.int32)]
    )
    keep, wslot, wpos = (ragged_write_targets(rowids, positions, slots, S) if writes is None
                         else (w.long() for w in writes))
    moe_valid = rid < R
    pk = None if paged is None else paged["k"]
    pr = None if paged is None else paged["v"]
    tbl = None if paged is None else paged["tbl"]

    h = _embed_in(cfg, params, tokens)  # [T, D]
    cos, sin = rope_tables(cfg, dr, positions)  # [T, dr/2]
    for li, lp in enumerate(layer_params(params)):
        x = _norm(cfg, h, lp["attn_norm"])
        qn, qr = _queries(cfg, lp, x)  # [T, H, dn/dr]
        qr = apply_rope(qr, cos, sin)
        c, kr = _latents(cfg, lp, x)  # [T, R], [T, dr]
        kr = apply_rope(kr[:, None], cos, sin)[:, 0]
        w_uk, w_uv = _absorbed_w(cfg, lp, h.dtype)
        qt = torch.einsum("thd,rhd->thr", qn, w_uk)  # [T, H, R]
        ctx_lat = ragged_prefill_attend_mla(
            qt.contiguous(), qr.contiguous(), c.contiguous(), kr.contiguous(), cache_c, cache_r,
            li, rowids, offsets, slots, starts, scale=scale, block_tables=tbl, pool_c=pk,
            pool_r=pr,
        )
        ctx = torch.einsum("thr,rhd->thd", ctx_lat, w_uv).reshape(T, H * dv)
        h = h + qdot(ctx, lp["wo_mla"])
        h = _ffn_residual(cfg, lp, h, moe_valid=moe_valid)
        # writes last, positional and table-free (private positions are
        # identity-homed)
        if quantized:
            for cache, new in ((cache_c, c), (cache_r, kr)):
                q = quantize_kv(new[keep], scale_dtype=cache["s"].dtype)
                cache["q"][li, wslot, 0, wpos] = q["q"]
                cache["s"][li, wslot, 0, wpos] = q["s"]
        else:
            cache_c[li, wslot, 0, wpos] = c[keep].to(cache_c.dtype)
            cache_r[li, wslot, 0, wpos] = kr[keep].to(cache_r.dtype)
    last = h[torch.clamp(last_idx.long(), 0, T - 1)]
    return _logits(cfg, params, last), cache_c, cache_r


@torch.no_grad()
def mla_prefill_chunk_batch(
    cfg: ModelConfig,
    params: Params,
    cache_c: Any,  # latents [L, B, 1, S, R] or the int8 dict — updated in place
    cache_r: Any,  # rope keys [L, B, 1, S, dr] or the int8 dict — updated in place
    tokens: torch.Tensor,  # [A, C] int32 — right-padded chunks, one per row
    slots: torch.Tensor,  # [A] int32 (pads: B, writes nothing)
    starts: torch.Tensor,  # [A] int32 absolute position of each chunk's start
    nvalid: torch.Tensor,  # [A] int32 valid tokens per chunk
    skey: int = 0,  # bound on the PAST key range (0 = whole S)
    all_logits: bool = False,  # logits at every chunk position
    paged: dict | None = None,  # {"tbl","k","v"}: tables, latent pool, rope pool
    writes: tuple | None = None,  # (keep, wslot, wpos): llama.chunk_write_targets
) -> tuple[torch.Tensor, Any, Any]:
    """Batched chunked prefill for MLA, JAX's `mla_prefill_chunk_batch`:
    the queries fold through W_uk so the past segment scores straight
    against the latent cache (int8 latents dequantized after the dot, the
    latent scales folded into the probabilities on the value side); the
    self segment scores against the chunk's own exact latents. One joint
    softmax over [past | self], the attended [H, R] context re-expanded
    through W_uv. Reads before writes in every layer, as
    `llama_prefill_chunk_batch`; plain torch."""
    H, dn, dr, dv = _dims(cfg)
    quantized = isinstance(cache_c, dict)
    L, B, _, S, R = (cache_c["q"] if quantized else cache_c).shape
    A, C = tokens.shape
    Sk = min(skey, S) if skey else S
    scale = mla_scale(cfg)
    dev = tokens.device
    rows = slots.long().clamp(max=B - 1)
    starts_l = starts.long()
    keep, wslot, wpos = (chunk_write_targets(slots, starts, C, B, S) if writes is None
                         else (w.long() for w in writes))
    tbl = nbs = None
    if paged is not None:
        nbs = paged["tbl"].shape[1]
        tbl = paged["tbl"].index_select(0, rows)[:, :max(1, -(-Sk // (S // nbs)))]
    pk = None if paged is None else paged["k"]
    pr = None if paged is None else paged["v"]

    def past(cache, pool, li):  # [A, Sk, ·] (or [A, Sk] for a scale plane)
        return past_rows(cache[li], None if pool is None else pool[li], rows, tbl, Sk, nbs)[:, 0]

    h = _embed_in(cfg, params, tokens)  # [A, C, D]
    q_pos = starts_l[:, None] + torch.arange(C, device=dev)[None, :]
    cos, sin = rope_tables(cfg, dr, q_pos)  # [A, C, dr/2]
    key_pos = torch.arange(Sk, device=dev)
    past_mask = (key_pos[None, None, :] < starts_l[:, None, None]).expand(A, C, Sk)
    c_idx = torch.arange(C, device=dev)
    self_mask = (c_idx[None, :] <= c_idx[:, None])[None].expand(A, C, C)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)
    moe_valid = c_idx[None, :] < nvalid.long()[:, None]
    for li, lp in enumerate(layer_params(params)):
        x = _norm(cfg, h, lp["attn_norm"])
        qn, qr = _queries(cfg, lp, x)  # [A, C, H, dn/dr]
        qr = apply_rope(qr, cos, sin)
        c, kr = _latents(cfg, lp, x)  # [A, C, R], [A, C, dr]
        kr = apply_rope(kr[..., None, :], cos, sin)[..., 0, :]
        w_uk, w_uv = _absorbed_w(cfg, lp, h.dtype)
        qt = torch.einsum("achd,rhd->achr", qn, w_uk)  # [A, C, H, R]

        # reads first: past latents and rope keys as this layer found them
        if quantized:
            lat = past(cache_c["q"], None if pk is None else pk["q"], li)
            rop = past(cache_r["q"], None if pr is None else pr["q"], li)
            ls = past(cache_c["s"], None if pk is None else pk["s"], li).float()
            rs = past(cache_r["s"], None if pr is None else pr["s"], li).float()
            s_past = (
                torch.einsum("achr,asr->ahcs", qt, lat.to(qt.dtype)).float() * ls[:, None, None]
                + torch.einsum("achd,asd->ahcs", qr, rop.to(qr.dtype)).float() * rs[:, None, None]
            ) * scale
        else:
            lat = past(cache_c, pk, li)
            rop = past(cache_r, pr, li)
            s_past = (
                torch.einsum("achr,asr->ahcs", qt, lat.to(qt.dtype))
                + torch.einsum("achd,asd->ahcs", qr, rop.to(qr.dtype))
            ).float() * scale
        s_self = (
            torch.einsum("achr,atr->ahct", qt, c) + torch.einsum("achd,atd->ahct", qr, kr)
        ).float() * scale
        s_past = torch.where(past_mask[:, None], s_past, neg)
        s_self = torch.where(self_mask[:, None], s_self, neg)
        probs = torch.softmax(torch.cat([s_past, s_self], dim=-1), dim=-1)
        p_past, p_self = probs[..., :Sk], probs[..., Sk:]
        if quantized:
            p_past = p_past * ls[:, None, None]  # the value side's dequantization
        ctx_lat = (torch.einsum("ahcs,asr->achr", p_past.to(h.dtype), lat.to(h.dtype))
                   + torch.einsum("ahct,atr->achr", p_self.to(h.dtype), c))
        ctx = torch.einsum("achr,rhd->achd", ctx_lat, w_uv).reshape(A, C, H * dv)
        h = h + qdot(ctx, lp["wo_mla"])
        h = _ffn_residual(cfg, lp, h, moe_valid=moe_valid)

        # writes last, positional and table-free
        if quantized:
            for cache, new in ((cache_c, c), (cache_r, kr)):
                q = quantize_kv(new.reshape(A * C, -1)[keep], scale_dtype=cache["s"].dtype)
                cache["q"][li, wslot, 0, wpos] = q["q"]
                cache["s"][li, wslot, 0, wpos] = q["s"]
        else:
            cache_c[li, wslot, 0, wpos] = c.reshape(A * C, R)[keep].to(cache_c.dtype)
            cache_r[li, wslot, 0, wpos] = kr.reshape(A * C, dr)[keep].to(cache_r.dtype)
    if all_logits:
        return _logits(cfg, params, h), cache_c, cache_r  # [A, C, V]
    last = h[torch.arange(A, device=dev), (nvalid.long() - 1).clamp(0, C - 1)]
    return _logits(cfg, params, last), cache_c, cache_r


def _write_live(plane: torch.Tensor, rows, w, live, new: torch.Tensor) -> None:
    """plane[:, rows[b], 0, w[b]] = new[:, b] for the live rows; a parked
    row (w >= S) writes back what its row holds at S - 1, so nothing
    changes and no shape depends on the data (no host sync: the step runs
    inside a CUDA graph). plane [L, B, 1, S, *rest], new [L, Ba, *rest]."""
    wc = w.clamp(max=plane.shape[3] - 1)
    keep = live.reshape(1, -1, *([1] * (new.dim() - 2)))
    plane[:, rows, 0, wc] = torch.where(keep, new, plane[:, rows, 0, wc])


def _step_inputs(cfg, lp, h, cos, sin):
    """One decode layer's attention inputs: (qt [Ba, H, R], qr [Ba, H, dr],
    c [Ba, R], kr [Ba, dr], W_uv)."""
    x = _norm(cfg, h, lp["attn_norm"])
    qn, qr = _queries(cfg, lp, x)  # [Ba, H, dn/dr]
    qr = apply_rope(qr, cos, sin)
    c, kr = _latents(cfg, lp, x)
    kr = apply_rope(kr[:, None], cos, sin)[:, 0]
    w_uk, w_uv = _absorbed_w(cfg, lp, h.dtype)
    qt = torch.einsum("bhd,rhd->bhr", qn, w_uk)
    return qt, qr, c, kr, w_uv


@torch.no_grad()
def mla_decode_step(
    cfg: ModelConfig,
    params: Params,
    cache_c: Any,  # latents (engine "k") — updated in place
    cache_r: Any,  # rope keys (engine "v") — updated in place
    tokens: torch.Tensor,  # [Ba] int32
    lengths: torch.Tensor,  # [Ba] int32 — write position per row (>= S: parked)
    slot_ids: torch.Tensor | None = None,  # [Ba] int32 cache rows (None = 1:1)
    paged: dict | None = None,  # {"tbl","k","v"}
) -> tuple[torch.Tensor, Any, Any]:
    """One absorbed decode step for all rows. int8 latents: per layer
    `decode_attend_q8_mla` over the PRE-append cache (position lengths[b]
    from the exact vectors), then one quantized append of every layer's
    latent and rope key (JAX's kernel arm). bf16 latents: per layer the
    row's latent and rope key are written first, then plain attention over
    [0, lengths[b]] (JAX's XLA arm). Parked rows write nothing. Returns
    (logits [Ba, V] f32, cache_c, cache_r)."""
    H, dn, dr, dv = _dims(cfg)
    quantized = isinstance(cache_c, dict)
    L, B, _, S, R = (cache_c["q"] if quantized else cache_c).shape
    Ba = tokens.shape[0]
    scale = mla_scale(cfg)
    dev = tokens.device
    h = _embed_in(cfg, params, tokens)  # [Ba, D]
    cos, sin = rope_tables(cfg, dr, lengths)  # [Ba, dr/2]
    rows = torch.arange(Ba, device=dev) if slot_ids is None else slot_ids.long()
    w = lengths.long()
    live = w < S
    tbl = None if paged is None else paged["tbl"]

    if quantized:
        cs, krs = [], []
        for li, lp in enumerate(layer_params(params)):
            qt, qr, c, kr, w_uv = _step_inputs(cfg, lp, h, cos, sin)
            ctx_lat = decode_attend_q8_mla(
                qt.contiguous(), qr.contiguous(), c.contiguous(), kr.contiguous(), cache_c,
                cache_r, li, lengths, slot_ids=slot_ids, scale=scale, block_tables=tbl,
                pool_c=None if paged is None else paged["k"],
                pool_r=None if paged is None else paged["v"],
            )
            ctx = torch.einsum("bhr,rhd->bhd", ctx_lat.to(h.dtype), w_uv)
            h = h + qdot(ctx.reshape(Ba, H * dv), lp["wo_mla"])
            h = _ffn_residual(cfg, lp, h, moe_capacity=Ba)
            cs.append(c)
            krs.append(kr)
        # one batched append per cache for all layers; parked rows drop
        for cache, new in ((cache_c, torch.stack(cs)), (cache_r, torch.stack(krs))):
            q = quantize_kv(new)  # [L, Ba, w] and [L, Ba]
            _write_live(cache["q"], rows, w, live, q["q"])
            _write_live(cache["s"], rows, w, live, q["s"].to(cache["s"].dtype))
        return _logits(cfg, params, h), cache_c, cache_r

    key_pos = torch.arange(S, device=dev)
    attn_mask = (key_pos[None, :] <= w[:, None])[:, None, :]  # [Ba, 1, S]
    ptbl = None if tbl is None else tbl.index_select(0, rows)
    for li, lp in enumerate(layer_params(params)):
        qt, qr, c, kr, w_uv = _step_inputs(cfg, lp, h, cos, sin)
        _write_live(cache_c[li:li + 1], rows, w, live, c[None].to(cache_c.dtype))
        _write_live(cache_r[li:li + 1], rows, w, live, kr[None].to(cache_r.dtype))
        if ptbl is None:
            lat = cache_c[li].index_select(0, rows)[:, 0]  # [Ba, S, R]
            rop = cache_r[li].index_select(0, rows)[:, 0]
        else:
            lat = paged_gather(cache_c[li], paged["k"][li], ptbl)[:, 0]
            rop = paged_gather(cache_r[li], paged["v"][li], ptbl)[:, 0]
        scores = (
            torch.einsum("bhr,bsr->bhs", qt, lat.to(qt.dtype))
            + torch.einsum("bhd,bsd->bhs", qr, rop.to(qr.dtype))
        ).float() * scale
        scores = torch.where(attn_mask, scores, torch.full_like(scores, NEG_INF))
        probs = torch.softmax(scores, dim=-1).to(h.dtype)
        ctx_lat = torch.einsum("bhs,bsr->bhr", probs, lat.to(probs.dtype))
        ctx = torch.einsum("bhr,rhd->bhd", ctx_lat, w_uv).reshape(Ba, H * dv)
        h = h + qdot(ctx, lp["wo_mla"])
        h = _ffn_residual(cfg, lp, h, moe_capacity=Ba)
    return _logits(cfg, params, h), cache_c, cache_r
