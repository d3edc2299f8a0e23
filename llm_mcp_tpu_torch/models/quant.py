"""int8 weights for the serving path (counterpart of the GQA parts of
`llm_mcp_tpu/models/quant.py`).

Each quantized linear is `{"q": int8 [..., in, out], "s": [..., out]}`:
symmetric per-output-channel scales, so dequantization commutes with the
product, `x @ (q * s) == (x @ q) * s`. `qdot` is the w8a8 path that the
JAX package runs by default (`LLM_MCP_TPU_W8A8=1`): the activation rows
are quantized to int8 too, the product is s8 x s8 -> s32 (`torch._int_mm`,
as the JAX package leaves it to XLA's `dot_general`), and the int32
accumulator is rescaled by the row and channel scales. The int32 sum is
exact, so given the same int8 operands the product equals JAX's bit for
bit on any device.

Also here: the fused layer layout of the single-device engine (`wqkv` =
wq|wk|wv, `w13` = w1|w3, concatenated after quantization, which leaves
every output column unchanged), the direct-int8 random init (the bf16
tree of an 8B model never materializes), and the bit-packing of the int8
KV cache's per-position scales into one int8 pseudo-head row.

MLA and DeepSeek MoE trees (`models/mla.py`) quantize their attention
linears and shared experts, in the main stack and in the dense prologue
`dense_layers`; the routed expert banks stay in the model dtype, as in
JAX. Encoder trees (`models/embedder.py`) quantize their linears and the
per-row embedding the same way; their norms, biases and position and
type tables stay as they are. The sharding-spec part of the JAX module waits for multi-device
serving.
"""

from __future__ import annotations

from typing import Any

import torch

Params = dict[str, Any]

# `x / 127.0` in the JAX package's jitted code compiles (XLA's algebraic
# simplifier) to a multiplication by 1/127 rounded to float32, which
# differs from a true division in about 5 % of values by one ulp. Every
# quantizer that runs inside jit there multiplies by this constant here;
# `quantize_weight`, which JAX runs eagerly, divides.
INV127 = 1.0 / 127.0

# linear weights quantized inside each stacked layer tree: [L, in, out];
# the MLA factorization and DeepSeek's shared experts quantize, the routed
# expert banks do not
LAYER_QUANT_KEYS = (
    "wq", "wk", "wv", "wo", "w1", "w2", "w3",
    "wq_mla", "w_dkv", "w_ukv", "wo_mla",
    "w1s", "w3s", "w2s",
    "wqkv", "w13",
)
LAYER_STACKS = ("layers", "dense_layers")  # the MLA dense prologue is a second stack


def _over_stacks(params: Params, fn) -> Params:
    """`fn` over every stacked layer tree of `params` (a shallow copy)."""
    out: Params = dict(params)
    for key in LAYER_STACKS:
        if key in params:
            out[key] = fn(dict(params[key]))
    return out


def _quantize_slice(w: torch.Tensor, axis: int) -> dict[str, torch.Tensor]:
    wf = w.float()
    amax = wf.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"q": q, "s": scale.squeeze(axis).to(w.dtype)}


def quantize_weight(w: torch.Tensor, axis: int = -2) -> dict[str, torch.Tensor]:
    """Symmetric per-output-channel int8: |max| over the contraction axis
    (default -2, the `in` axis of an [..., in, out] linear). Scales keep
    the weight's dtype. Stacked [L, in, out] tensors are quantized one
    layer slice at a time, so the float32 working copy is 1/L of the
    tensor."""
    if w.dim() < 3:
        return _quantize_slice(w, axis)
    ax = axis if axis < 0 else axis - 1  # the same axis inside one slice
    parts = [_quantize_slice(w[i], ax) for i in range(w.shape[0])]
    return {"q": torch.stack([p["q"] for p in parts]), "s": torch.stack([p["s"] for p in parts])}


def is_quantized(w) -> bool:
    return isinstance(w, dict) and "q" in w


def _int_matmul(x8: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """[..., K] int8 @ [K, N] int8 -> [..., N] int32 through `torch._int_mm`.
    On the card cuBLASLt wants more than 16 rows and K, N multiples of 8:
    the rows are padded with zeros (each row's scale is its own, so pad
    rows change nothing) and other shapes raise."""
    lead = x8.shape[:-1]
    a = x8.reshape(-1, x8.shape[-1])
    M = a.shape[0]
    if a.is_cuda:
        K, N = q.shape
        if K % 8 or N % 8:
            raise ValueError(f"qdot: int8 GEMM on CUDA needs K, N multiples of 8, got {K}, {N}")
        Mp = max(32, -(-M // 8) * 8)
        if Mp != M:
            a = torch.cat([a, a.new_zeros((Mp - M, a.shape[1]))])
    y = torch._int_mm(a.contiguous(), q)
    return y[:M].reshape(*lead, q.shape[1])


def qdot(x: torch.Tensor, w) -> torch.Tensor:
    """Product over the last axis of x; plain `x @ w` for a plain tensor.
    For a quantized weight, w8a8: per-row activation scales
    `max|x| * INV127` (floor 1e-30), int8 rows rounded half to even, an
    s8 x s8 -> s32 product, then `y * xa * s` in float32, cast to x's
    dtype."""
    if isinstance(w, dict):
        xf = x.float()
        xa = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) * INV127, min=1e-30)
        x8 = torch.round(xf / xa).to(torch.int8)
        y = _int_matmul(x8, w["q"])
        return (y.float() * xa * w["s"].float()).to(x.dtype)
    return x @ w


def embed_lookup(embed, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding rows for token ids; per-row scales when quantized (the
    activation dtype follows the scale dtype)."""
    idx = tokens.long()
    if isinstance(embed, dict):
        rows = embed["q"][idx].to(embed["s"].dtype)
        return rows * embed["s"][idx][..., None]
    return embed[idx]


def logits_head(embed_or_head, h: torch.Tensor, tied: bool) -> torch.Tensor:
    """Final projection to vocab logits (float32). A quantized head is
    upcast to h's dtype and multiplied, as in the JAX package: for a
    128256-row vocabulary that is a transient of one bf16 copy of the head
    (1.05 GB at D = 4096)."""
    if isinstance(embed_or_head, dict):
        q, s = embed_or_head["q"], embed_or_head["s"]
        m = q.T if tied else q
        y = (h @ m.to(h.dtype)).float()
        return y * s.float()
    head = embed_or_head.T if tied else embed_or_head
    return (h @ head).float()


def quantize_params(params: Params) -> Params:
    """Quantize every dense linear of a Llama-family, MLA or encoder tree
    (both stacks), plus the embedding (per-row scales, which are also
    per-output-channel of its transpose, the tied head) and the LM head.
    Norm weights, biases, the q/k norms, the router and routed expert banks
    stay as they are (Mixtral's and DeepSeek's banks in the model dtype, as
    in JAX). Already-quantized leaves are kept."""

    def quant_block(b: Params) -> Params:
        for k in LAYER_QUANT_KEYS:
            if k in b and not is_quantized(b[k]):
                b[k] = quantize_weight(b[k])
        return b

    out = _over_stacks(params, quant_block)
    if not is_quantized(params["embed"]):
        out["embed"] = quantize_weight(params["embed"], axis=-1)
    if "lm_head" in params and not is_quantized(params["lm_head"]):
        out["lm_head"] = quantize_weight(params["lm_head"], axis=-2)
    return out


def init_llama_params_quantized(
    cfg,
    generator: torch.Generator,
    scale_dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cpu",
) -> Params:
    """Random Llama-family tree made directly in int8 form (the tree
    `quantize_params` produces), one layer at a time on `device`: uniform
    int8 payloads in [-127, 127] from `generator` and constant scales
    `fan_in**-0.5 / 73.3` (uniform int8 draws have std 73.3, so the
    weights match a fan-in-scaled normal init in magnitude). The bf16 tree
    never exists. MLA configs get the MLA factorization in int8 and, with
    experts, routed banks drawn in `scale_dtype` and shared experts drawn
    and quantized (JAX's `init_llama_params_quantized`), the dense
    prologue in `dense_layers`. The family leaves are JAX's: norms at
    1 - norm_weight_offset, zero biases, unit q/k norms, and Mixtral's
    router and routed banks drawn in `scale_dtype`."""
    hd = cfg.resolved_head_dim
    L, D, H, Hkv, Fh, V = (
        cfg.n_layers, cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.ffn_hidden, cfg.vocab_size,
    )
    if cfg.kv_lora_rank:
        return _init_mla_params_quantized(cfg, generator, scale_dtype, device)

    def qw(shape, fan_in):
        return _qw(shape, fan_in, generator, scale_dtype, device)

    def norm():
        return torch.full((L, D), 1.0 - cfg.norm_weight_offset, dtype=scale_dtype, device=device)

    layers = {
        "attn_norm": norm(),
        "ffn_norm": norm(),
        "wq": qw((L, D, H * hd), D),
        "wk": qw((L, D, Hkv * hd), D),
        "wv": qw((L, D, Hkv * hd), D),
        "wo": qw((L, H * hd, D), H * hd),
    }
    if cfg.qkv_bias:
        for k, n in (("bq", H), ("bk", Hkv), ("bv", Hkv)):
            layers[k] = torch.zeros((L, n * hd), dtype=scale_dtype, device=device)
    if cfg.qk_norm:
        for k in ("q_norm", "k_norm"):
            layers[k] = torch.ones((L, hd), dtype=scale_dtype, device=device)
    if cfg.post_norms:
        layers["post_attn_norm"] = norm()
        layers["post_ffn_norm"] = norm()
    if cfg.n_experts:
        from .moe import init_moe_layer_params

        layers.update(init_moe_layer_params(cfg, generator, scale_dtype, L, device))
    else:
        layers.update(w1=qw((L, D, Fh), D), w3=qw((L, D, Fh), D), w2=qw((L, Fh, D), Fh))
    embed_q = torch.randint(-127, 128, (V, D), generator=generator, dtype=torch.int8,
                            device=device)
    params: Params = {
        "embed": {"q": embed_q,
                  "s": torch.full((V,), (D**-0.5) / 73.3, dtype=scale_dtype, device=device)},
        "layers": layers,
        "final_norm": torch.full((D,), 1.0 - cfg.norm_weight_offset, dtype=scale_dtype,
                                 device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = qw((D, V), D)
    return params


def _qw(shape, fan_in, generator, scale_dtype, device) -> dict:
    """Direct-int8 random weight: uniform payload in [-127, 127] from
    `generator`, made one [in, out] matrix at a time, and constant
    per-output-channel scales fan_in^-1/2 / 73.3."""
    q = torch.empty(shape, dtype=torch.int8, device=device)
    for dst in q.reshape(-1, *shape[-2:]):
        dst.copy_(torch.randint(-127, 128, dst.shape, generator=generator, dtype=torch.int8,
                                device=device))
    s = torch.full(shape[:-2] + shape[-1:], (fan_in**-0.5) / 73.3, dtype=scale_dtype,
                   device=device)
    return {"q": q, "s": s}


def _init_mla_params_quantized(cfg, generator, scale_dtype, device) -> Params:
    """The MLA branch of `init_llama_params_quantized`."""
    from .mla import _check_dense_q, mla_param_shapes
    from .moe import init_moe_layer_params

    _check_dense_q(cfg)
    shapes = mla_param_shapes(cfg)

    def block(spec: dict) -> Params:
        L = spec["attn_norm"][0]
        out: Params = {}
        for name, shape in spec.items():
            if name in ("attn_norm", "ffn_norm", "kv_norm"):
                out[name] = torch.ones(shape, dtype=scale_dtype, device=device)
            elif name not in ("router", "w1e", "w3e", "w2e", "w1s", "w3s", "w2s"):
                out[name] = _qw(shape, shape[-2], generator, scale_dtype, device)
        if "router" in spec:
            moe = init_moe_layer_params(cfg, generator, scale_dtype, L, device)
            for k in ("w1s", "w3s", "w2s"):
                if k in moe:
                    moe[k] = quantize_weight(moe[k])
            out.update(moe)
        return out

    D, V = cfg.dim, cfg.vocab_size
    params: Params = {
        "embed": {"q": _qw((V, D), D, generator, scale_dtype, device)["q"],
                  "s": torch.full((V,), (D**-0.5) / 73.3, dtype=scale_dtype, device=device)},
        "layers": block(shapes["layers"]),
        "final_norm": torch.ones((D,), dtype=scale_dtype, device=device),
    }
    if "dense_layers" in shapes:
        params["dense_layers"] = block(shapes["dense_layers"])
    if not cfg.tie_embeddings:
        params["lm_head"] = _qw((D, V), D, generator, scale_dtype, device)
    return params


def _concat_w(parts):
    """Concatenate linears along the output axis, keeping quantization. For
    w8a8 this is exact: `qdot` quantizes the shared activation row once,
    so the fused product gives the separate products' int32 columns."""
    if all(isinstance(p, dict) for p in parts):
        return {
            "q": torch.cat([p["q"] for p in parts], dim=-1),
            "s": torch.cat([p["s"] for p in parts], dim=-1),
        }
    if any(isinstance(p, dict) for p in parts):
        raise ValueError("cannot fuse mixed quantized/unquantized linears")
    return torch.cat(parts, dim=-1)


def fuse_layer_weights(params: Params) -> Params:
    """The single-device layer layout: wq|wk|wv become one `wqkv` product
    and w1|w3 one `w13`, two GEMMs instead of five per layer (Qwen2's
    biases become one `bqkv`). `llama._qkv` and `llama._ffn_residual`
    split the fused outputs. An MLA stack fuses only w13 (its dense
    prologue; MoE layers have none)."""

    def fuse_block(b: Params) -> Params:
        if all(k in b for k in ("wq", "wk", "wv")):
            b["wqkv"] = _concat_w([b.pop("wq"), b.pop("wk"), b.pop("wv")])
            if all(k in b for k in ("bq", "bk", "bv")):
                b["bqkv"] = torch.cat([b.pop("bq"), b.pop("bk"), b.pop("bv")], dim=-1)
        if "w1" in b and "w3" in b:
            b["w13"] = _concat_w([b.pop("w1"), b.pop("w3")])
        return b

    return _over_stacks(params, fuse_block)


def gemm_layout(params: Params) -> Params:
    """The layers' int8 payloads [L, K, N] stored K-contiguous (strides
    (K*N, 1, K)): the same values, in the operand layout for which
    cuBLASLt's int8 GEMM behind `torch._int_mm` picks its fast kernels
    (measured on an H100: 5-13x the K-by-N row-major layout, which falls
    back to an sm80 WMMA kernel; see PERF.md). Copied one layer at a time,
    so the transient is one layer."""

    def layout_block(b: Params) -> Params:
        for k, w in b.items():
            if is_quantized(w) and w["q"].dim() == 3 and w["q"].stride(1) != 1:
                L, K, N = w["q"].shape
                q = torch.empty_strided((L, K, N), (K * N, 1, K), dtype=torch.int8,
                                        device=w["q"].device)
                for li in range(L):
                    q[li].copy_(w["q"][li])
                b[k] = {"q": q, "s": w["s"]}
        return b

    return _over_stacks(params, layout_block)


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def scale_pack_width(n_kv_heads: int, head_dim: int, scale_dtype: torch.dtype) -> int:
    """1 when the 2*Hkv K and V scales of one position fit one head_dim row
    of int8 lanes (the packed pseudo-head exists), else 0."""
    return 1 if 2 * n_kv_heads * _itemsize(scale_dtype) <= head_dim else 0


def pack_scales(s: torch.Tensor, head_dim: int) -> torch.Tensor:
    """Bit-pack per-position scales [..., Hs, T] into one int8 pseudo-head
    row [..., 1, T, head_dim]: per position, the Hs scales' bytes in
    little-endian order, then zero lanes up to head_dim. Byte-identical to
    the JAX package's `pack_scales`."""
    Hs, T = s.shape[-2], s.shape[-1]
    raw = s.transpose(-1, -2).contiguous().view(torch.int8)  # [..., T, Hs * itemsize]
    out = torch.zeros((*raw.shape[:-1], head_dim), dtype=torch.int8, device=s.device)
    out[..., : raw.shape[-1]] = raw
    return out.unsqueeze(-3)


def unpack_scales(row: torch.Tensor, n_heads: int, scale_dtype: torch.dtype) -> torch.Tensor:
    """Invert `pack_scales`: [..., T, head_dim] int8 -> [..., n_heads, T]."""
    raw = row[..., : n_heads * _itemsize(scale_dtype)].contiguous()
    return raw.view(scale_dtype).transpose(-1, -2)
