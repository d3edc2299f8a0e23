"""Shared executor helpers (counterpart of `llm_mcp_tpu/executor/common.py`)."""

from __future__ import annotations


def pow2_bucket(n: int, cap: int, floor: int = 32) -> int:
    """Smallest power-of-two ≥ n (min `floor`), capped at `cap`."""
    b = floor
    while b < n:
        b *= 2
    return min(b, cap)


def fine_bucket(n: int, cap: int, floor: int = 32) -> int:
    """Smallest rung of the {pow2, 1.5x pow2} ladder ≥ n (min `floor`),
    capped at `cap` — 32, 48, 64, 96, 128, 192, 256, ..."""
    b = floor
    while b < n:
        mid = b + b // 2
        if n <= mid:
            return min(mid, cap)
        b *= 2
    return min(b, cap)
