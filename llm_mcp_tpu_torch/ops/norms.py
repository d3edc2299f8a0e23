"""RMSNorm (counterpart of `llm_mcp_tpu/ops/norms.py`).

The reduction runs in float32 and the result is cast back to the
activation dtype, as in the JAX package.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    norm = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (norm * weight.float()).to(x.dtype)
