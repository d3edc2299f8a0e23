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


def split_think(text: str) -> tuple[str, str]:
    """Split a leading `<think>...</think>` block from the visible answer.

    Returns (thinking, answer). Text that does not start (after whitespace)
    with `<think>` is returned whole as the answer; otherwise both parts are
    stripped, and an unterminated block is all thinking.
    """
    stripped = text.lstrip()
    if not stripped.startswith("<think>"):
        return "", text
    end = stripped.find("</think>")
    if end < 0:
        return stripped[len("<think>"):].strip(), ""
    return stripped[len("<think>"):end].strip(), stripped[end + len("</think>"):].strip()
