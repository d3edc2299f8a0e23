"""Prompt/message helpers (counterpart of `llm_mcp_tpu/utils/tokens.py`)."""

from __future__ import annotations

from typing import Any


def messages_to_prompt(messages: list[dict[str, Any]]) -> str:
    """Flatten chat messages to a single prompt string ("role: content" lines)."""
    parts: list[str] = []
    for m in messages or []:
        role = str(m.get("role", "user"))
        content = m.get("content", "")
        if isinstance(content, list):  # OpenAI content-parts form
            content = " ".join(
                str(p.get("text", "")) for p in content if isinstance(p, dict)
            )
        parts.append(f"{role}: {content}")
    return "\n".join(parts)
