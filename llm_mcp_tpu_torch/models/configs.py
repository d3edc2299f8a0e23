"""Model architecture configs (counterpart of `llm_mcp_tpu/models/configs.py`).

The slice serves dense GQA Llama models, so the config keeps only the
fields those models read. Family knobs (Gemma's norm offset and softcaps,
sliding windows, other rope scalings) and reading a checkpoint's
`config.json` come with the families and checkpoints that need them.
"""

from __future__ import annotations

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
    # llama3 wavelength-banded rope scaling (off at rope_factor 1)
    rope_factor: float = 1.0
    rope_orig_max: int = 0
    tie_embeddings: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def attn_scale(self) -> float:
        return self.resolved_head_dim**-0.5


MODEL_CONFIGS: dict[str, ModelConfig] = {
    # Llama-3.1-8B per the published architecture
    "llama-3.1-8b": ModelConfig(
        name="llama-3.1-8b",
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
