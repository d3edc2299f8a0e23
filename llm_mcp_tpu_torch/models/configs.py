"""Model architecture configs (counterpart of `llm_mcp_tpu/models/configs.py`).

The port serves the JAX package's decoder families: Llama (and the
R1-Distill-Llama), Qwen2.5 and R1-Distill-Qwen (q/k/v biases), Qwen3
(per-head q/k norm, explicit head_dim), Mistral (sliding window), Gemma-2
((1 + w) norms, post-norms, gelu, sqrt(dim) embedding scale, score and
logit softcaps, alternating windows), Mixtral (top-2 MoE) and the
DeepSeek-V2 family (MLA latent attention, DeepSeek MoE). `config_from_hf`
reads a checkpoint's `config.json`; `resolve_config` prefers it over the
catalog, as the JAX package does. The embedders are here too: the BERT
family encoders (`arch="encoder"`: nomic_bert and classic BERT, served by
`models/embedder.py`) and Qwen3-Embedding, a Qwen3 decoder pooled at its
last token (`models/llama.py:llama_encode`).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import re
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch: str = "llama"  # llama (causal decoder) | mla | encoder (bidirectional embedder)
    vocab_size: int = 128_256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_hidden: int = 14_336
    head_dim: int = 0  # 0: dim // n_heads
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 131_072
    # embedders: the pooling (mean | cls for encoders, last for decoders)
    # and the output width (0: dim); the encoder's variants, as JAX's:
    # LayerNorm with bias or RMSNorm, post-LN residuals with an embedding
    # norm, rope or a learned position table, a gated or a plain MLP,
    # biases on every linear, and BERT's segment embeddings (segment 0)
    pooling: str = "mean"
    embed_dim: int = 0
    enc_norm: str = "rms"  # rms | layer
    enc_post_ln: bool = False
    enc_pos: str = "rope"  # rope | learned
    enc_gated: bool = True
    enc_bias: bool = False
    type_vocab_size: int = 0
    # family knobs: Qwen2 q/k/v biases; Qwen3 per-head q/k RMSNorm; the FFN
    # activation (gelu is the tanh approximation, as jax.nn.gelu); Gemma's
    # x * (1 + w) norms, sqrt(dim) embedding scale, softcaps on the logits
    # and the scores, and post-attention/post-FFN norms; sliding windows
    # (every `sliding_pattern`-th layer global: 1 = all sliding, Mistral;
    # 2 = alternating, Gemma-2); Gemma-2's score scale
    # query_pre_attn_scalar**-0.5 (0: head_dim)
    qkv_bias: bool = False
    qk_norm: bool = False
    act: str = "silu"
    norm_weight_offset: float = 0.0
    embed_scale: bool = False
    logit_softcap: float = 0.0
    attn_softcap: float = 0.0
    sliding_window: int = 0
    query_pre_attn_scalar: float = 0.0
    sliding_pattern: int = 1
    post_norms: bool = False
    # MoE (0 experts: dense FFN)
    n_experts: int = 0
    experts_per_tok: int = 2
    capacity_factor: float = 1.25
    # MLA (DeepSeek-V2 multi-head latent attention, kv_lora_rank > 0): the
    # KV cache holds one latent (kv_lora_rank) and one shared rope key
    # (qk_rope_head_dim) per token instead of per-head K/V
    q_lora_rank: int = 0  # 0: dense query projection (V2-Lite); > 0 is refused
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 0
    qk_nope_head_dim: int = 0
    v_head_dim: int = 0
    # rope scaling (off at rope_factor 1): "llama3" wavelength bands,
    # "linear" position interpolation or "yarn" (DeepSeek-V2;
    # yarn_mscale_all_dim also scales the scores)
    rope_type: str = "yarn"
    rope_factor: float = 1.0
    rope_orig_max: int = 0
    llama3_low_freq_factor: float = 1.0
    llama3_high_freq_factor: float = 4.0
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale: float = 0.0
    yarn_mscale_all_dim: float = 0.0
    # DeepSeek MoE: shared always-on experts, the routed experts' width
    # (0: ffn_hidden), the dense layers before the MoE stack, and the gate
    # convention (norm_topk_prob False: raw softmax gates times
    # routed_scaling_factor)
    n_shared_experts: int = 0
    moe_ffn_hidden: int = 0
    first_dense_layers: int = 0
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0
    tie_embeddings: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.dim // self.n_heads

    @property
    def yarn_attn_mscale(self) -> float:
        """Yarn's score-scale correction, (0.1 * m * ln(factor) + 1)^2 when
        yarn_mscale_all_dim = m is set (DeepSeek-V2), else 1."""
        if self.rope_factor > 1.0 and self.yarn_mscale_all_dim:
            m = 0.1 * self.yarn_mscale_all_dim * math.log(self.rope_factor) + 1.0
            return m * m
        return 1.0

    @property
    def attn_scale(self) -> float:
        return (self.query_pre_attn_scalar or self.resolved_head_dim) ** -0.5 * \
            self.yarn_attn_mscale


MODEL_CONFIGS: dict[str, ModelConfig] = {
    # Llama-3.1-8B per the published architecture
    "llama-3.1-8b": ModelConfig(
        name="llama-3.1-8b",
        max_seq_len=131_072,
        rope_type="llama3",
        rope_factor=8.0,
        rope_orig_max=8192,
        vocab_size=128_256,
        dim=4096,
        n_layers=32,
        n_heads=32,
        n_kv_heads=8,
        ffn_hidden=14_336,
        rope_theta=500_000.0,
    ),
    "llama-3.2-1b": ModelConfig(
        name="llama-3.2-1b",
        max_seq_len=131_072,
        rope_type="llama3",
        rope_factor=32.0,
        rope_orig_max=8192,
        vocab_size=128_256,
        dim=2048,
        n_layers=16,
        n_heads=32,
        n_kv_heads=8,
        ffn_hidden=8192,
        rope_theta=500_000.0,
        tie_embeddings=True,
    ),
    # MLA at Llama-8B proportions: an in-repo long-context serving config,
    # not a published checkpoint
    "mla-8b": ModelConfig(
        name="mla-8b",
        arch="mla",
        max_seq_len=131_072,
        vocab_size=128_256,
        dim=4096,
        n_layers=32,
        n_heads=32,
        n_kv_heads=1,  # latent cache: one shared row per token
        ffn_hidden=14_336,
        rope_theta=500_000.0,
        kv_lora_rank=512,
        qk_rope_head_dim=64,
        qk_nope_head_dim=128,
        v_head_dim=128,
    ),
    # DeepSeek-V2-Lite, a published MLA + MoE checkpoint (HF
    # deepseek-ai/DeepSeek-V2-Lite config.json): dense layer 0, 26 MoE
    # layers of 64 routed and 2 shared experts, 6 per token, yarn rope
    # from 4k to 160k
    "deepseek-v2-lite": ModelConfig(
        name="deepseek-v2-lite",
        arch="mla",
        max_seq_len=163_840,
        vocab_size=102_400,
        dim=2048,
        n_layers=27,
        n_heads=16,
        n_kv_heads=1,
        ffn_hidden=10_944,
        norm_eps=1e-6,
        rope_theta=10_000.0,
        kv_lora_rank=512,
        qk_rope_head_dim=64,
        qk_nope_head_dim=128,
        v_head_dim=128,
        n_experts=64,
        experts_per_tok=6,
        n_shared_experts=2,
        moe_ffn_hidden=1408,
        first_dense_layers=1,
        norm_topk_prob=False,
        routed_scaling_factor=1.0,
        rope_factor=40.0,
        rope_orig_max=4096,
        yarn_beta_fast=32.0,
        yarn_beta_slow=1.0,
        yarn_mscale=0.707,
        yarn_mscale_all_dim=0.707,
    ),
    # toy V2-structure config for tests: dense layer 0, MoE layers with
    # shared experts, yarn rope
    "tiny-v2": ModelConfig(
        name="tiny-v2",
        arch="mla",
        max_seq_len=512,
        vocab_size=512,
        dim=128,
        n_layers=3,
        n_heads=4,
        n_kv_heads=1,
        ffn_hidden=256,
        norm_eps=1e-6,
        rope_theta=10_000.0,
        kv_lora_rank=32,
        qk_rope_head_dim=16,
        qk_nope_head_dim=32,
        v_head_dim=32,
        n_experts=4,
        experts_per_tok=2,
        n_shared_experts=2,
        moe_ffn_hidden=64,
        first_dense_layers=1,
        norm_topk_prob=False,
        routed_scaling_factor=1.0,
        rope_factor=4.0,
        rope_orig_max=64,
        yarn_mscale=0.707,
        yarn_mscale_all_dim=0.707,
        tie_embeddings=True,
    ),
    # toy dense MLA config for tests
    "tiny-mla": ModelConfig(
        name="tiny-mla",
        arch="mla",
        max_seq_len=512,
        vocab_size=512,
        dim=128,
        n_layers=2,
        n_heads=4,
        n_kv_heads=1,
        ffn_hidden=256,
        rope_theta=10_000.0,
        kv_lora_rank=32,
        qk_rope_head_dim=16,
        qk_nope_head_dim=32,
        v_head_dim=32,
        tie_embeddings=True,
    ),
    # toy config for tests
    "tiny-llm": ModelConfig(
        name="tiny-llm",
        max_seq_len=512,
        vocab_size=512,
        dim=128,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        ffn_hidden=256,
        rope_theta=10_000.0,
        tie_embeddings=True,
    ),
    # Mixtral-8x7B per the published architecture: 8 experts, top 2
    "mixtral-8x7b": ModelConfig(
        name="mixtral-8x7b",
        vocab_size=32_000,
        dim=4096,
        n_layers=32,
        n_heads=32,
        n_kv_heads=8,
        ffn_hidden=14_336,
        rope_theta=1_000_000.0,
        max_seq_len=32_768,
        n_experts=8,
        experts_per_tok=2,
    ),
    # toy MoE config for tests: E / k = 2 at capacity factor 2, so the
    # capacity is the token count (dropless)
    "tiny-moe": ModelConfig(
        name="tiny-moe",
        vocab_size=512,
        dim=128,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        ffn_hidden=256,
        rope_theta=10_000.0,
        max_seq_len=512,
        n_experts=4,
        experts_per_tok=2,
        capacity_factor=2.0,
        tie_embeddings=True,
    ),
    # Qwen2.5 per the published architecture: q/k/v biases, 1M rope theta
    "qwen2.5-7b": ModelConfig(
        name="qwen2.5-7b",
        vocab_size=152_064,
        dim=3584,
        n_layers=28,
        n_heads=28,
        n_kv_heads=4,
        ffn_hidden=18_944,
        rope_theta=1_000_000.0,
        norm_eps=1e-6,
        max_seq_len=32_768,
        qkv_bias=True,
    ),
    # Qwen3 (HF Qwen/Qwen3-8B config.json): per-head q/k RMSNorm before
    # rope, explicit head_dim
    "qwen3-8b": ModelConfig(
        name="qwen3-8b",
        vocab_size=151_936,
        dim=4096,
        n_layers=36,
        n_heads=32,
        n_kv_heads=8,
        ffn_hidden=12_288,
        head_dim=128,
        rope_theta=1_000_000.0,
        norm_eps=1e-6,
        max_seq_len=32_768,
        qk_norm=True,
    ),
    # the DeepSeek-R1 distills: published Qwen2.5 and Llama checkpoints
    "deepseek-r1-distill-qwen-1.5b": ModelConfig(
        name="deepseek-r1-distill-qwen-1.5b",
        vocab_size=151_936,
        dim=1536,
        n_layers=28,
        n_heads=12,
        n_kv_heads=2,
        ffn_hidden=8960,
        rope_theta=10_000.0,
        norm_eps=1e-6,
        max_seq_len=131_072,
        qkv_bias=True,
        tie_embeddings=True,
    ),
    "deepseek-r1-distill-llama-8b": ModelConfig(
        name="deepseek-r1-distill-llama-8b",
        vocab_size=128_256,
        dim=4096,
        n_layers=32,
        n_heads=32,
        n_kv_heads=8,
        ffn_hidden=14_336,
        rope_theta=500_000.0,
        max_seq_len=131_072,
    ),
    # head_dim 64: runs on the CPU only until the kernels gain hd-64 arms
    "qwen2.5-0.5b": ModelConfig(
        name="qwen2.5-0.5b",
        vocab_size=151_936,
        dim=896,
        n_layers=24,
        n_heads=14,
        n_kv_heads=2,
        ffn_hidden=4864,
        rope_theta=1_000_000.0,
        norm_eps=1e-6,
        max_seq_len=32_768,
        qkv_bias=True,
        tie_embeddings=True,
    ),
    # Mistral-7B-v0.1: a 4096-token sliding window on every layer
    "mistral-7b": ModelConfig(
        name="mistral-7b",
        vocab_size=32_000,
        dim=4096,
        n_layers=32,
        n_heads=32,
        n_kv_heads=8,
        ffn_hidden=14_336,
        rope_theta=10_000.0,
        max_seq_len=32_768,
        sliding_window=4096,
        sliding_pattern=1,
    ),
    # Gemma-2-9B: gelu FFN, (1 + w) norms with post-norms, sqrt(dim)
    # embedding scale, score and logit softcaps, an alternating 4096-token
    # window, a tied 256k vocabulary, head_dim 256 and scores scaled by
    # 224**-0.5 (dim / n_heads, not head_dim)
    "gemma2-9b": ModelConfig(
        name="gemma2-9b",
        vocab_size=256_000,
        dim=3584,
        n_layers=42,
        n_heads=16,
        n_kv_heads=8,
        ffn_hidden=14_336,
        head_dim=256,
        rope_theta=10_000.0,
        norm_eps=1e-6,
        max_seq_len=8192,
        act="gelu",
        norm_weight_offset=1.0,
        embed_scale=True,
        logit_softcap=30.0,
        attn_softcap=50.0,
        sliding_window=4096,
        sliding_pattern=2,
        query_pre_attn_scalar=224.0,
        post_norms=True,
        tie_embeddings=True,
    ),
    # toy family configs for tests
    "tiny-qwen": ModelConfig(
        name="tiny-qwen",
        vocab_size=512,
        dim=128,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        ffn_hidden=256,
        rope_theta=10_000.0,
        max_seq_len=512,
        qkv_bias=True,
        tie_embeddings=True,
    ),
    "tiny-qwen3": ModelConfig(
        name="tiny-qwen3",
        vocab_size=512,
        dim=128,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        ffn_hidden=256,
        head_dim=64,  # explicit, not dim // n_heads = 32
        rope_theta=10_000.0,
        max_seq_len=512,
        qk_norm=True,
        tie_embeddings=True,
    ),
    "tiny-mistral": ModelConfig(
        name="tiny-mistral",
        vocab_size=512,
        dim=128,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        ffn_hidden=256,
        rope_theta=10_000.0,
        max_seq_len=512,
        sliding_window=64,
        sliding_pattern=1,
        tie_embeddings=True,
    ),
    "tiny-gemma": ModelConfig(
        name="tiny-gemma",
        vocab_size=512,
        dim=128,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        ffn_hidden=256,
        rope_theta=10_000.0,
        max_seq_len=512,
        act="gelu",
        norm_weight_offset=1.0,
        embed_scale=True,
        logit_softcap=30.0,
        attn_softcap=50.0,
        sliding_window=64,
        sliding_pattern=2,
        query_pre_attn_scalar=24.0,  # not head_dim (32), so tests see it
        post_norms=True,
        tie_embeddings=True,
    ),
    # the published nomic_bert architecture (nomic-ai/nomic-embed-text-v1.5
    # config.json; a checkpoint's own config.json wins): full rotary rope,
    # post-LN LayerNorm, biasless gated SwiGLU, segment embeddings, mean
    # pooling
    "nomic-embed-text": ModelConfig(
        name="nomic-embed-text",
        arch="encoder",
        vocab_size=30_528,
        dim=768,
        n_layers=12,
        n_heads=12,
        n_kv_heads=12,
        ffn_hidden=3072,
        rope_theta=10_000.0,
        norm_eps=1e-12,
        max_seq_len=8192,
        enc_norm="layer",
        enc_post_ln=True,
        enc_gated=True,
        enc_bias=False,
        type_vocab_size=2,
        pooling="mean",
        embed_dim=768,
    ),
    # Qwen3-Embedding-8B: a Qwen3 causal LM (HF Qwen3ForCausalLM) pooled at
    # its last token; it serves through EmbeddingEngine's decoder path
    # (`llama.llama_encode`) and loads through the decoder mapping
    "qwen3-embedding-8b": ModelConfig(
        name="qwen3-embedding-8b",
        vocab_size=151_936,
        dim=4096,
        n_layers=36,
        n_heads=32,
        n_kv_heads=8,
        ffn_hidden=12_288,
        head_dim=128,
        rope_theta=1_000_000.0,
        norm_eps=1e-6,
        max_seq_len=32_768,
        qk_norm=True,
        tie_embeddings=True,  # encoding never reaches a head
        pooling="last",
        embed_dim=4096,
    ),
    # toy encoder for tests: rope, RMSNorm, pre-norm SwiGLU
    "tiny-embed": ModelConfig(
        name="tiny-embed",
        arch="encoder",
        vocab_size=512,
        dim=64,
        n_layers=2,
        n_heads=4,
        n_kv_heads=4,
        ffn_hidden=128,
        rope_theta=10_000.0,
        max_seq_len=512,
        pooling="mean",
        embed_dim=64,
    ),
}


def _compact(s: str) -> str:
    """Strip separators so "llama3.1:8b", "Llama-3.1-8B" and "llama_3.1_8b"
    compare equal."""
    return re.sub(r"[-_.:\s]", "", s.lower())


_BERT_ACTS = ("gelu", "gelu_new", "gelu_pytorch_tanh", "relu", "silu")
_NOMIC_ACTS = ("swiglu", "geglu", "silu", "gelu", "gelu_new", "relu")


def _encoder_config_from_hf(doc: dict, mt: str, name: str) -> ModelConfig:
    """The encoder families, classic BERT and nomic_bert, as the JAX package
    reads them. What the encoder cannot compute is refused: an unknown
    activation, nomic's prenorm variant, a partial rotary fraction, and
    MLP bias flags that disagree with the attention's (one `enc_bias`
    covers every linear)."""
    if mt == "bert":
        act = str(doc.get("hidden_act") or "gelu").lower()
        if act not in _BERT_ACTS:
            raise ValueError(f"unsupported hidden_act {act!r} for bert")
        dim = int(doc["hidden_size"])
        return ModelConfig(
            name=name or str(doc.get("_name_or_path") or mt),
            arch="encoder",
            vocab_size=int(doc["vocab_size"]),
            dim=dim,
            n_layers=int(doc["num_hidden_layers"]),
            n_heads=int(doc["num_attention_heads"]),
            n_kv_heads=int(doc["num_attention_heads"]),
            ffn_hidden=int(doc["intermediate_size"]),
            norm_eps=float(doc.get("layer_norm_eps") or 1e-12),
            max_seq_len=int(doc.get("max_position_embeddings") or 512),
            act=act,
            enc_norm="layer",
            enc_post_ln=True,
            enc_pos="learned",
            enc_gated=False,
            enc_bias=True,
            type_vocab_size=int(doc.get("type_vocab_size") or 0),
            pooling="mean",
            embed_dim=dim,
        )
    # nomic_bert: GPT-2 style key names
    dim = int(doc.get("n_embd") or doc.get("hidden_size") or 768)
    n_heads = int(doc.get("n_head") or doc.get("num_attention_heads") or 12)
    act = str(doc.get("activation_function") or "swiglu").lower()
    if act not in _NOMIC_ACTS:
        raise ValueError(f"unsupported activation_function {act!r} for nomic_bert")
    if bool(doc.get("prenorm", False)):
        raise ValueError("unsupported nomic_bert prenorm=true (post-LN only)")
    rot_frac = float(doc.get("rotary_emb_fraction", 1.0) or 0.0)
    qkv_bias = bool(doc.get("qkv_proj_bias", True))
    for bias_key in ("mlp_fc1_bias", "mlp_fc2_bias"):
        if bias_key in doc and bool(doc[bias_key]) != qkv_bias:
            raise ValueError(
                f"unsupported nomic_bert bias split: {bias_key}="
                f"{bool(doc[bias_key])} but qkv_proj_bias={qkv_bias}"
            )
    if 0.0 < rot_frac < 1.0:
        raise ValueError(
            f"unsupported rotary_emb_fraction {rot_frac} for nomic_bert (only 0.0 or 1.0)"
        )
    return ModelConfig(
        name=name or str(doc.get("_name_or_path") or mt),
        arch="encoder",
        vocab_size=int(doc["vocab_size"]),
        dim=dim,
        n_layers=int(doc.get("n_layer") or doc.get("num_hidden_layers") or 12),
        n_heads=n_heads,
        n_kv_heads=n_heads,
        ffn_hidden=int(doc.get("n_inner") or doc.get("intermediate_size") or 4 * dim),
        rope_theta=float(doc.get("rotary_emb_base") or 10_000.0),
        norm_eps=float(doc.get("layer_norm_epsilon") or 1e-12),
        max_seq_len=int(doc.get("n_positions") or doc.get("max_position_embeddings") or 2048),
        # swiglu: a silu gate; geglu: a gelu gate; other names pass through
        act="silu" if act in ("swiglu", "silu") else "gelu" if act == "geglu" else act,
        enc_norm="layer",
        enc_post_ln=True,
        enc_pos="rope" if rot_frac > 0 else "learned",
        enc_gated="glu" in act,
        enc_bias=qkv_bias,
        type_vocab_size=int(doc.get("type_vocab_size") or 0),
        pooling="mean",
        embed_dim=dim,
    )


def config_from_hf(doc: dict, name: str = "") -> ModelConfig:
    """A ModelConfig from an HF checkpoint's config.json, as the JAX
    package reads it: the decoder families llama, qwen2, qwen3, mistral,
    mixtral, gemma2 and deepseek_v2, and the encoders bert and nomic_bert.
    Any other type raises, and so does a rope scaling the port does not
    apply."""
    mt = str(doc.get("model_type", "")).lower()
    if mt in ("bert", "nomic_bert"):
        return _encoder_config_from_hf(doc, mt, name)
    n_heads = int(doc.get("num_attention_heads", 32))
    kw: dict = dict(
        name=name or str(doc.get("_name_or_path") or mt or "hf-model"),
        vocab_size=int(doc["vocab_size"]),
        dim=int(doc["hidden_size"]),
        n_layers=int(doc["num_hidden_layers"]),
        n_heads=n_heads,
        n_kv_heads=int(doc.get("num_key_value_heads") or n_heads),
        ffn_hidden=int(doc["intermediate_size"]),
        head_dim=int(doc.get("head_dim") or 0),
        rope_theta=float(doc.get("rope_theta") or 10_000.0),
        norm_eps=float(doc.get("rms_norm_eps") or 1e-5),
        max_seq_len=int(doc.get("max_position_embeddings") or 8192),
        tie_embeddings=bool(doc.get("tie_word_embeddings", False)),
    )
    rs = doc.get("rope_scaling") or {}
    rs = rs if isinstance(rs, dict) else {}
    rs_type = str(rs.get("rope_type") or rs.get("type") or "").lower()
    if rs_type == "linear":
        kw.update(rope_type="linear", rope_factor=float(rs.get("factor") or 1.0),
                  rope_orig_max=int(rs.get("original_max_position_embeddings") or 1))
    if mt == "llama":
        if rs_type == "llama3":
            kw.update(
                rope_type="llama3",
                rope_factor=float(rs.get("factor") or 1.0),
                rope_orig_max=int(rs.get("original_max_position_embeddings") or 0),
                llama3_low_freq_factor=float(rs.get("low_freq_factor") or 1.0),
                llama3_high_freq_factor=float(rs.get("high_freq_factor") or 4.0),
            )
    elif mt == "qwen2":
        kw["qkv_bias"] = True
    elif mt == "qwen3":
        kw["qk_norm"] = True
    elif mt == "mistral":
        kw["sliding_window"] = int(doc.get("sliding_window") or 0)
        kw["sliding_pattern"] = 1
    elif mt == "mixtral":
        kw["n_experts"] = int(doc["num_local_experts"])
        kw["experts_per_tok"] = int(doc.get("num_experts_per_tok") or 2)
    elif mt == "gemma2":
        kw.update(
            act="gelu",
            norm_weight_offset=1.0,
            embed_scale=True,
            logit_softcap=float(doc.get("final_logit_softcapping") or 0.0),
            attn_softcap=float(doc.get("attn_logit_softcapping") or 0.0),
            sliding_window=int(doc.get("sliding_window") or 0),
            sliding_pattern=2,
            query_pre_attn_scalar=float(doc.get("query_pre_attn_scalar") or 0.0),
            post_norms=True,
            tie_embeddings=True,
        )
    elif mt == "deepseek_v2":
        kw.update(
            arch="mla",
            n_kv_heads=1,  # the latent cache poses as one KV head (mla.py)
            q_lora_rank=int(doc.get("q_lora_rank") or 0),
            kv_lora_rank=int(doc["kv_lora_rank"]),
            qk_rope_head_dim=int(doc["qk_rope_head_dim"]),
            qk_nope_head_dim=int(doc["qk_nope_head_dim"]),
            v_head_dim=int(doc["v_head_dim"]),
            n_experts=int(doc.get("n_routed_experts") or 0),
            experts_per_tok=int(doc.get("num_experts_per_tok") or 2),
            n_shared_experts=int(doc.get("n_shared_experts") or 0),
            moe_ffn_hidden=int(doc.get("moe_intermediate_size") or 0),
            first_dense_layers=int(doc.get("first_k_dense_replace") or 0),
            # HF DeepseekV2Config's default: raw softmax gates
            norm_topk_prob=bool(doc.get("norm_topk_prob", False)),
            routed_scaling_factor=float(doc.get("routed_scaling_factor") or 1.0),
        )
        if rs_type == "yarn":
            kw.update(
                rope_type="yarn",
                rope_factor=float(rs.get("factor") or 1.0),
                rope_orig_max=int(rs.get("original_max_position_embeddings") or 0),
                yarn_beta_fast=float(rs.get("beta_fast") or 32.0),
                yarn_beta_slow=float(rs.get("beta_slow") or 1.0),
                yarn_mscale=float(rs.get("mscale") or 0.0),
                yarn_mscale_all_dim=float(rs.get("mscale_all_dim") or 0.0),
            )
    else:
        raise ValueError(
            f"unsupported HF model_type {mt!r} "
            "(supported: llama, qwen2, qwen3, mistral, mixtral, gemma2, "
            "deepseek_v2, bert, nomic_bert)"
        )
    if rs_type and kw.get("rope_factor", 1.0) <= 1.0 and rs_type != "default":
        # a scaling the port does not apply would degrade past the
        # original context silently
        raise ValueError(f"unsupported rope_scaling type {rs_type!r} for {mt!r}")
    return ModelConfig(**kw)


def config_from_hf_dir(path: str, name: str = "") -> ModelConfig:
    """`config_from_hf` over a checkpoint directory's config.json. For an
    encoder, a sentence-transformers `1_Pooling/config.json` beside it
    decides the pooling (config.json never records it); a malformed one
    keeps the family's default."""
    with open(os.path.join(path, "config.json")) as f:
        cfg = config_from_hf(json.load(f), name=name)
    pool_path = os.path.join(path, "1_Pooling", "config.json")
    if cfg.arch == "encoder" and os.path.isfile(pool_path):
        try:
            with open(pool_path) as f:
                pdoc = json.load(f)
            if pdoc.get("pooling_mode_cls_token"):
                cfg = dataclasses.replace(cfg, pooling="cls")
            elif pdoc.get("pooling_mode_mean_tokens"):
                cfg = dataclasses.replace(cfg, pooling="mean")
        except Exception:  # malformed: the family's default
            pass
    return cfg


def resolve_config(model, weights_dir: str = "") -> ModelConfig:
    """Config for a model name (or a ModelConfig, returned as it is) and an
    optional checkpoint directory: the directory's config.json describes
    the weights and wins; a malformed one falls back to the catalog, with
    a warning, as in the JAX package."""
    if not isinstance(model, str):
        return model
    if weights_dir and os.path.isfile(os.path.join(weights_dir, "config.json")):
        try:
            return config_from_hf_dir(weights_dir, name=model)
        except Exception as e:  # a malformed config.json: the catalog
            logging.getLogger("models").warning(
                "config.json in %s not usable (%s); falling back to the catalog entry for %r",
                weights_dir, e, model,
            )
    return get_config(model)


def get_config(name: str) -> ModelConfig:
    """Config by catalog name or a common alias ("llama3.1:8b",
    "meta-llama/Llama-3.1-8B-Instruct", "deepseek-r1:1.5b"), resolved as
    the JAX package's `get_config` resolves `TPU_MODEL`."""
    key = name.lower().strip()
    if key in MODEL_CONFIGS:
        return MODEL_CONFIGS[key]
    ck = _compact(key.split("/")[-1])
    for cname, cfg in MODEL_CONFIGS.items():
        cc = _compact(cname)
        if cc == ck or cc in ck:
            return cfg
    if ("deepseek-v2" in key or "deepseek_v2" in key) and "lite" in key:
        return MODEL_CONFIGS["deepseek-v2-lite"]
    if "deepseek-r1" in key or "deepseek_r1" in key or "deepscaler" in key or "deepcoder" in key:
        # the size decides the base architecture: 1.5b/7b are Qwen2.5
        # distills, 8b the Llama distill; other sizes have no config
        if "1.5b" in key:
            return MODEL_CONFIGS["deepseek-r1-distill-qwen-1.5b"]
        if "7b" in key:
            return MODEL_CONFIGS["qwen2.5-7b"]
        if "8b" in key:
            return MODEL_CONFIGS["deepseek-r1-distill-llama-8b"]
    if "llama" in key and "1b" in key:
        return MODEL_CONFIGS["llama-3.2-1b"]
    if "llama" in key:
        return MODEL_CONFIGS["llama-3.1-8b"]
    if "qwen" in key and "0.5b" in key:
        return MODEL_CONFIGS["qwen2.5-0.5b"]
    if "qwen" in key:
        return MODEL_CONFIGS["qwen2.5-7b"]
    if "mixtral" in key:
        return MODEL_CONFIGS["mixtral-8x7b"]
    if "mistral" in key:
        return MODEL_CONFIGS["mistral-7b"]
    if "gemma" in key:
        return MODEL_CONFIGS["gemma2-9b"]
    if "embed" in key:
        return MODEL_CONFIGS["nomic-embed-text"]
    raise KeyError(f"unknown model {name!r}; known: {sorted(MODEL_CONFIGS)}")
