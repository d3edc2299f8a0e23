"""Model architecture configs (counterpart of `llm_mcp_tpu/models/configs.py`).

The port serves dense GQA Llama models and the DeepSeek-V2 family (MLA
latent attention, DeepSeek MoE), so the config keeps the fields those
models read. Family knobs (Gemma's norm offset and softcaps, sliding
windows, linear rope scaling) and reading a checkpoint's `config.json`
come with the families and checkpoints that need them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab_size: int = 128_256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_hidden: int = 14_336
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
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
    # rope scaling (off at rope_factor 1): "llama3" wavelength bands or
    # "yarn" (DeepSeek-V2; yarn_mscale_all_dim also scales the scores)
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
        return self.dim // self.n_heads

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
        return self.resolved_head_dim**-0.5 * self.yarn_attn_mscale


MODEL_CONFIGS: dict[str, ModelConfig] = {
    # Llama-3.1-8B per the published architecture
    "llama-3.1-8b": ModelConfig(
        name="llama-3.1-8b",
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
        vocab_size=512,
        dim=128,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        ffn_hidden=256,
        rope_theta=10_000.0,
        tie_embeddings=True,
    ),
}


def get_config(name: str) -> ModelConfig:
    """Config by catalog name."""
    try:
        return MODEL_CONFIGS[name]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; known: {sorted(MODEL_CONFIGS)}") from None
