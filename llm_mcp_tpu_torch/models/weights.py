"""Parameter trees into the port's tensors (counterpart of
`llm_mcp_tpu/models/weights.py`).

`params_from_numpy` takes a parameter tree in the JAX package's layout as
numpy arrays (for example `jax.tree.map(np.asarray, params)`) and returns
the same tree as tensors on `device`. It is how the two implementations
are made to compute from the same weights. Reading safetensors
checkpoints comes with real checkpoints, in a later slice.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .configs import ModelConfig
from .llama import param_shapes


def params_from_numpy(
    tree: dict[str, Any],
    cfg: ModelConfig,
    device: str | torch.device = "cpu",
    dtype: torch.dtype = torch.bfloat16,
) -> dict[str, Any]:
    """Convert a numpy parameter tree, checking every key and shape against
    `cfg`. Raises on a missing key, an unknown key or a wrong shape."""
    expected = param_shapes(cfg)

    def convert(node: dict[str, Any], spec: dict[str, Any], path: str) -> dict[str, Any]:
        unknown = sorted(set(node) - set(spec))
        missing = sorted(set(spec) - set(node))
        if unknown or missing:
            raise KeyError(
                f"parameter tree {path or '/'}: unknown keys {unknown}, missing keys {missing}"
            )
        out: dict[str, Any] = {}
        for key, want in spec.items():
            val = node[key]
            if isinstance(want, dict):
                if not isinstance(val, dict):
                    raise TypeError(f"{path}{key}: expected a sub-tree")
                out[key] = convert(val, want, f"{path}{key}/")
                continue
            arr = np.asarray(val)
            if tuple(arr.shape) != tuple(want):
                raise ValueError(f"{path}{key}: shape {arr.shape}, expected {want}")
            out[key] = torch.from_numpy(np.array(arr, dtype=np.float32)).to(
                device=device, dtype=dtype
            )
        return out

    return convert(tree, expected, "")
