"""Bidirectional transformer encoder for embeddings (counterpart of
`llm_mcp_tpu/models/embedder.py`).

Plain functions on tensors over a parameter dictionary with the JAX
package's layout, so the two compute the same vectors from the same
weights. One parameterized encoder serves the BERT families:

  - nomic_bert (nomic-embed-text): rope, post-LN LayerNorm, a gated
    SwiGLU MLP without biases, segment-0 type embeddings;
  - classic BERT: learned absolute positions, post-LN LayerNorm, a plain
    GELU MLP, biases on every linear;
  - rope, RMSNorm and pre-norm SwiGLU (`tiny-embed`).

The attention keeps JAX's roundings: the product of q and k in the
activation dtype, cast to float32 and then scaled, padded keys masked to
-1e30, the softmax in float32 cast back before P.V. JAX's attention is a
plain XLA einsum, so this one is plain torch; it runs in slices of
(batch row, head) pairs that keep the float32 scores under
`SCORE_BUDGET_BYTES`, since a padded batch of 64 at 4096 tokens and
nomic's 12 heads would otherwise hold 51.5 GB of scores. Each pair's
scores are its own, so the slices compute what one call would.

Linears go through `quant.qdot` and the token embedding through
`quant.embed_lookup`, so an int8 tree (`quantize_params`, or
`init_embedder_params_quantized`) serves unchanged. `embed_forward`
returns L2-normalized float32 vectors; Matryoshka truncation is the
engine's (`executor/embedding.py`).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from ..ops.norms import rms_norm
from ..ops.rope import apply_rope, rope_tables
from .configs import ModelConfig
from .llama import _layer
from .quant import _qw, embed_lookup, qdot

Params = dict[str, Any]

NEG = -1e30
# float32 attention scores held at once: 1 GiB is one batch row of 12
# heads at 4096 tokens (805 MB)
SCORE_BUDGET_BYTES = 1 << 30


def embedder_param_shapes(cfg: ModelConfig) -> dict[str, Any]:
    """Expected shape of every parameter of an encoder tree."""
    hd = cfg.resolved_head_dim
    L, D, H, Fh, V = cfg.n_layers, cfg.dim, cfg.n_heads, cfg.ffn_hidden, cfg.vocab_size
    ls: dict[str, Any] = {
        "attn_norm": (L, D),
        "wq": (L, D, H * hd),
        "wk": (L, D, H * hd),
        "wv": (L, D, H * hd),
        "wo": (L, H * hd, D),
        "ffn_norm": (L, D),
        "w1": (L, D, Fh),
        "w2": (L, Fh, D),
    }
    if cfg.enc_gated:
        ls["w3"] = (L, D, Fh)
    if cfg.enc_norm == "layer":
        ls.update(attn_norm_b=(L, D), ffn_norm_b=(L, D))
    if cfg.enc_bias:
        ls.update(bq=(L, H * hd), bk=(L, H * hd), bv=(L, H * hd), bo=(L, D), b1=(L, Fh),
                  b2=(L, D))
        if cfg.enc_gated:
            ls["b3"] = (L, Fh)
    shapes: dict[str, Any] = {"embed": (V, D), "layers": ls}
    if cfg.enc_pos == "learned":
        shapes["pos_embed"] = (cfg.max_seq_len, D)
    if cfg.type_vocab_size:
        shapes["type_embed"] = (cfg.type_vocab_size, D)
    if cfg.enc_post_ln:
        # post-LN stacks normalize after the embeddings and inside each
        # block; there is no final norm
        shapes["embed_norm"] = (D,)
        if cfg.enc_norm == "layer":
            shapes["embed_norm_b"] = (D,)
    else:
        shapes["final_norm"] = (D,)
    return shapes


def _is_norm(name: str) -> bool:
    return name.endswith("norm")


def _is_bias(name: str) -> bool:
    return name.endswith("_b") or name in ("bq", "bk", "bv", "bo", "b1", "b2", "b3")


def init_embedder_params(
    cfg: ModelConfig,
    generator: torch.Generator,
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cpu",
) -> Params:
    """Random encoder weights with fan-in scaling from `generator`, one
    layer slice at a time on `device`; norm weights at 1, biases at 0."""

    def w(shape, fan_in):
        t = torch.empty(shape, dtype=dtype, device=device)
        for dst in t if len(shape) == 3 else [t]:
            r = torch.randn(dst.shape, generator=generator, dtype=torch.float32, device=device)
            dst.copy_(r * fan_in**-0.5)
        return t

    def leaf(name, shape, fan_in):
        if _is_norm(name):
            return torch.ones(shape, dtype=dtype, device=device)
        if _is_bias(name):
            return torch.zeros(shape, dtype=dtype, device=device)
        return w(shape, fan_in)

    shapes = embedder_param_shapes(cfg)
    params: Params = {"layers": {k: leaf(k, s, s[1]) for k, s in shapes.pop("layers").items()}}
    for k, s in shapes.items():
        params[k] = leaf(k, s, cfg.dim)
    return params


def init_embedder_params_quantized(
    cfg: ModelConfig,
    generator: torch.Generator,
    scale_dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cpu",
) -> Params:
    """The encoder tree made directly in int8 form, as JAX's
    `init_embedder_params_quantized`: uniform int8 payloads with constant
    per-output-channel scales fan_in**-0.5 / 73.3 (per row for the token
    embedding); norms at 1, biases at 0, and the position and type tables
    at 0, in `scale_dtype`."""
    shapes = embedder_param_shapes(cfg)
    layers: Params = {}
    for k, s in shapes.pop("layers").items():
        if _is_norm(k):
            layers[k] = torch.ones(s, dtype=scale_dtype, device=device)
        elif _is_bias(k):
            layers[k] = torch.zeros(s, dtype=scale_dtype, device=device)
        else:
            layers[k] = _qw(s, s[1], generator, scale_dtype, device)
    V, D = shapes.pop("embed")
    params: Params = {
        "embed": {"q": _qw((V, D), D, generator, scale_dtype, device)["q"],
                  "s": torch.full((V,), (D**-0.5) / 73.3, dtype=scale_dtype, device=device)},
        "layers": layers,
    }
    for k, s in shapes.items():
        fill = 1.0 if _is_norm(k) else 0.0
        params[k] = torch.full(s, fill, dtype=scale_dtype, device=device)
    return params


def _act(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "gelu":  # BERT's "gelu" is the erf form
        return F.gelu(x)
    if cfg.act in ("gelu_new", "gelu_pytorch_tanh"):
        return F.gelu(x, approximate="tanh")
    if cfg.act == "relu":
        return F.relu(x)
    if cfg.act == "silu":
        return F.silu(x)
    raise ValueError(f"unsupported encoder activation {cfg.act!r}")


def _norm(cfg: ModelConfig, x: torch.Tensor, w: torch.Tensor, b) -> torch.Tensor:
    """LayerNorm in float32 (with its bias when there is one), or RMSNorm."""
    if cfg.enc_norm == "layer":
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + cfg.norm_eps) * w.float()
        if b is not None:
            out = out + b.float()
        return out.to(x.dtype)
    return rms_norm(x, w, cfg.norm_eps)


def encoder_attention(
    q: torch.Tensor,  # [B, S, H, hd]
    k: torch.Tensor,
    v: torch.Tensor,
    valid: torch.Tensor,  # [B, S] bool: the keys inside each row
) -> torch.Tensor:
    """Bidirectional, pad-masked attention with JAX's roundings, in slices
    of (row, head) pairs whose float32 scores fit `SCORE_BUDGET_BYTES` (at
    least one pair a slice). Returns [B, S, H, hd]."""
    B, S, H, hd = q.shape
    qh = q.permute(0, 2, 1, 3).reshape(B * H, S, hd)
    kh = k.permute(0, 2, 1, 3).reshape(B * H, S, hd)
    vh = v.permute(0, 2, 1, 3).reshape(B * H, S, hd)
    keep = valid.repeat_interleave(H, dim=0)[:, None, :]  # [B * H, 1, S]
    step = max(1, SCORE_BUDGET_BYTES // (S * S * 4))
    out = torch.empty_like(qh)
    for i in range(0, B * H, step):
        j = min(i + step, B * H)
        s = torch.matmul(qh[i:j], kh[i:j].transpose(-1, -2)).float() * hd**-0.5
        s = torch.where(keep[i:j], s, torch.full_like(s, NEG))
        p = torch.softmax(s, dim=-1).to(q.dtype)
        del s
        out[i:j] = torch.matmul(p, vh[i:j])
    return out.reshape(B, H, S, hd).permute(0, 2, 1, 3)


@torch.no_grad()
def embed_forward(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,  # [B, S] int32, right-padded
    lengths: torch.Tensor,  # [B] int32
) -> torch.Tensor:
    """Encode a batch into L2-normalized float32 vectors [B, D]."""
    B, S = tokens.shape
    hd, H = cfg.resolved_head_dim, cfg.n_heads
    dev = tokens.device

    h = embed_lookup(params["embed"], tokens)
    if cfg.enc_pos == "learned":
        h = h + params["pos_embed"][:S][None].to(h.dtype)
    if cfg.type_vocab_size:
        h = h + params["type_embed"][0][None, None].to(h.dtype)  # segment 0
    if cfg.enc_post_ln:
        h = _norm(cfg, h, params["embed_norm"], params.get("embed_norm_b"))

    if cfg.enc_pos == "rope":
        cos, sin = rope_tables(cfg, hd, torch.arange(S, dtype=torch.int32, device=dev)[None])
    valid = torch.arange(S, device=dev)[None, :] < lengths.long()[:, None]  # [B, S]

    def bias(x, lp, key):
        return x + lp[key].to(x.dtype) if cfg.enc_bias else x

    def attn(x, lp):
        q, k, v = (bias(qdot(x, lp[w]), lp, b).reshape(B, S, H, hd)
                   for w, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")))
        if cfg.enc_pos == "rope":
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        ctx = encoder_attention(q, k, v, valid).reshape(B, S, H * hd)
        return bias(qdot(ctx, lp["wo"]), lp, "bo")

    def mlp(x, lp):
        up = _act(cfg, bias(qdot(x, lp["w1"]), lp, "b1"))
        if cfg.enc_gated:
            up = up * bias(qdot(x, lp["w3"]), lp, "b3")
        return bias(qdot(up, lp["w2"]), lp, "b2")

    for li in range(cfg.n_layers):
        lp = _layer(params, li)
        if cfg.enc_post_ln:
            h = _norm(cfg, h + attn(h, lp), lp["attn_norm"], lp.get("attn_norm_b"))
            h = _norm(cfg, h + mlp(h, lp), lp["ffn_norm"], lp.get("ffn_norm_b"))
        else:
            h = h + attn(_norm(cfg, h, lp["attn_norm"], lp.get("attn_norm_b")), lp)
            h = h + mlp(_norm(cfg, h, lp["ffn_norm"], lp.get("ffn_norm_b")), lp)
    h = h.float() if cfg.enc_post_ln else _norm(cfg, h, params["final_norm"], None).float()

    if cfg.pooling == "cls":
        pooled = h[:, 0]
    else:  # masked mean
        w = valid.float()[:, :, None]
        pooled = (h * w).sum(dim=1) / torch.clamp(w.sum(dim=1), min=1.0)
    return pooled / torch.clamp(torch.linalg.vector_norm(pooled, dim=-1, keepdim=True), min=1e-9)
