"""Rotary position embeddings (counterpart of `llm_mcp_tpu/ops/rope.py`).

Split-half convention, as in Llama. Frequencies and angles are float32,
as in the JAX package: the llama3 wavelength bands and the yarn ramp are
computed in f32 so both sides round the same way. Linear scaling comes
with the families that use it.
"""

from __future__ import annotations

import math

import torch


def _inv_freq(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    idx = torch.arange(0, half, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (idx / half))


def rope_frequencies(
    head_dim: int, theta: float, positions: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [..., head_dim//2] for integer positions [...]."""
    inv_freq = _inv_freq(head_dim, theta, positions.device)
    angles = positions.to(torch.float32)[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def _yarn_get_mscale(scale: float, mscale: float) -> float:
    if scale <= 1.0 or not mscale:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def yarn_rope_frequencies(
    head_dim: int,
    theta: float,
    positions: torch.Tensor,
    *,
    factor: float,
    orig_max: int,
    beta_fast: float = 32.0,
    beta_slow: float = 1.0,
    mscale: float = 0.0,
    mscale_all_dim: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Yarn-corrected cos/sin tables (DeepSeek-V2 long-context rope): per
    frequency a blend of the original inv_freq (high frequencies, whose
    wavelength fits the original context) and inv_freq / factor (low
    frequencies), with a linear ramp between the beta_fast and beta_slow
    correction dims, and the magnitude correction folded into cos/sin."""
    half = head_dim // 2
    idx = torch.arange(0, half, dtype=torch.float32, device=positions.device)
    freq_extra = 1.0 / (theta ** (idx / half))
    freq_inter = freq_extra / factor

    def corr_dim(n_rot: float) -> float:
        return (head_dim * math.log(orig_max / (n_rot * 2 * math.pi))) / (2 * math.log(theta))

    low = max(math.floor(corr_dim(beta_fast)), 0)
    high = min(math.ceil(corr_dim(beta_slow)), head_dim - 1)
    ramp = torch.clip((idx - low) / max(high - low, 1e-3), 0.0, 1.0)
    extra_mask = 1.0 - ramp  # 1: keep the original (extrapolate), 0: interpolate
    inv_freq = freq_inter * ramp + freq_extra * extra_mask
    m = _yarn_get_mscale(factor, mscale) / _yarn_get_mscale(factor, mscale_all_dim)
    angles = positions.to(torch.float32)[..., None] * inv_freq
    return torch.cos(angles) * m, torch.sin(angles) * m


def llama3_rope_frequencies(
    head_dim: int,
    theta: float,
    positions: torch.Tensor,
    *,
    factor: float,
    orig_max: int,
    low_freq_factor: float = 1.0,
    high_freq_factor: float = 4.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Llama-3.1-style rope scaling (HF rope_type "llama3"): short
    wavelengths keep the original frequency, long ones divide by `factor`,
    and the band between interpolates smoothly."""
    inv_freq = _inv_freq(head_dim, theta, positions.device)
    wavelen = 2.0 * math.pi / inv_freq
    low_wl = orig_max / low_freq_factor
    high_wl = orig_max / high_freq_factor
    smooth = torch.clip(
        (orig_max / wavelen - low_freq_factor)
        / max(high_freq_factor - low_freq_factor, 1e-3),
        0.0,
        1.0,
    )
    blended = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
    inv_freq = torch.where(
        wavelen < high_wl, inv_freq,
        torch.where(wavelen > low_wl, inv_freq / factor, blended),
    )
    angles = positions.to(torch.float32)[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def rope_tables(cfg, head_dim: int, positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Config-dispatched rope tables, the entry point every forward path
    uses: linear position interpolation, llama3 or yarn scaling when
    configured (rope_factor > 1; the last two with an original context),
    plain otherwise."""
    if cfg.rope_factor > 1.0 and cfg.rope_type == "linear":
        # every frequency divided by the factor: the positions are
        return rope_frequencies(head_dim, cfg.rope_theta,
                                positions.to(torch.float32) / cfg.rope_factor)
    if cfg.rope_factor > 1.0 and cfg.rope_orig_max:
        if cfg.rope_type == "llama3":
            return llama3_rope_frequencies(
                head_dim, cfg.rope_theta, positions,
                factor=cfg.rope_factor, orig_max=cfg.rope_orig_max,
                low_freq_factor=cfg.llama3_low_freq_factor,
                high_freq_factor=cfg.llama3_high_freq_factor,
            )
        return yarn_rope_frequencies(
            head_dim, cfg.rope_theta, positions,
            factor=cfg.rope_factor, orig_max=cfg.rope_orig_max,
            beta_fast=cfg.yarn_beta_fast, beta_slow=cfg.yarn_beta_slow,
            mscale=cfg.yarn_mscale, mscale_all_dim=cfg.yarn_mscale_all_dim,
        )
    return rope_frequencies(head_dim, cfg.rope_theta, positions)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (split-half layout). x: [..., n_heads, head_dim];
    cos/sin: [..., head_dim//2] broadcast over the heads axis. The rotation
    runs in float32 (bf16 x times f32 tables promotes, as in JAX) and the
    result is cast back to x's dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)
