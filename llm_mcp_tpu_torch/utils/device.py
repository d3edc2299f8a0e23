"""Device resolution for the port's entry points.

Entry points default to the card. Without CUDA they raise instead of
carrying on quietly on the CPU; the CPU runs only when asked for by name.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return dev
