"""Parameter trees into the port's tensors (counterpart of
`llm_mcp_tpu/models/weights.py`).

`params_from_numpy` takes a parameter tree in the JAX package's layout as
numpy arrays (for example `jax.tree.map(np.asarray, params)`) and returns
the same tree as tensors on `device`. It is how the two implementations
are made to compute from the same weights. The tree may be the JAX
package's int8 form (`quantize_params`, `init_llama_params_quantized`):
a quantized leaf is `{"q": int8, "s": scales}`, its payload copied exactly
and its scales converted to `dtype`; and it may carry the single-device
fused keys `wqkv`/`w13` (`fuse_layer_weights`). MLA and DeepSeek MoE
trees (`models/mla.py`) carry their dense prologue in `dense_layers` and
the routed expert banks as [L, E, D, F] tensors. Reading safetensors
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
    fused = any(k in tree.get(stack, {}) for stack in ("layers", "dense_layers")
                for k in ("wqkv", "w13"))
    expected = param_shapes(cfg, fused=fused)

    def tensor(arr, want, path) -> torch.Tensor:
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(want):
            raise ValueError(f"{path}: shape {arr.shape}, expected {want}")
        return torch.from_numpy(np.array(arr, dtype=np.float32)).to(device=device, dtype=dtype)

    def quantized(val: dict, want: tuple, path: str) -> dict[str, torch.Tensor]:
        if set(val) != {"q", "s"}:
            raise KeyError(f"{path}: a quantized leaf holds exactly 'q' and 's', got {sorted(val)}")
        q = np.asarray(val["q"])
        if q.dtype != np.int8 or tuple(q.shape) != tuple(want):
            raise ValueError(f"{path}/q: {q.dtype} {q.shape}, expected int8 {want}")
        # scales are per output channel: the contraction axis drops (the
        # embedding's scales are per row, its last axis drops)
        cut = -1 if path == "embed" else -2
        s_want = tuple(want[:cut]) + (tuple(want[cut + 1:]) if cut == -2 else ())
        return {"q": torch.from_numpy(q.copy()).to(device),
                "s": tensor(val["s"], s_want, f"{path}/s")}

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
            elif isinstance(val, dict):
                out[key] = quantized(val, want, f"{path}{key}")
            else:
                out[key] = tensor(val, want, f"{path}{key}")
        return out

    return convert(tree, expected, "")
