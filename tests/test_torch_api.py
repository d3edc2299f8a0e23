"""The port's chat API answers as the JAX package's local chat path does.

A stub engine stands in for `GenerationEngine`, so each test pins one
behaviour of `llm_mcp_tpu_torch/api/inference.py` against the reference
(`llm_mcp_tpu/api/inference.py`):

  - a non-streamed answer that starts with a `<think>` block carries it in
    `message.reasoning` and the stripped answer in `content`, and the
    port's `split_think` agrees with the reference's;
  - a body's `top_k` does not reach the engine (the reference's chat path
    reads only `max_tokens`, `temperature` and `top_p`);
  - a streamed engine error is sent as an `error` chunk, and the final
    chunk keeps `finish_reason: "stop"` before `data: [DONE]`.
"""

from __future__ import annotations

import json
import urllib.request

import pytest

from llm_mcp_tpu.utils.tokens import split_think as split_think_ref
from llm_mcp_tpu_torch.api.inference import serve
from llm_mcp_tpu_torch.utils.tokens import split_think

USAGE = {"prompt_tokens": 3, "completion_tokens": 2, "total_tokens": 5}


class StubEngine:
    """Answers every request with fixed text or events and records the
    keyword arguments each call was given."""

    device = "cpu"

    def __init__(self, text: str = "", events: list[dict] | None = None):
        self.text = text
        self.events = events or []
        self.calls: list[dict] = []

    def generate(self, prompt, **kw):
        self.calls.append(kw)
        return {"text": self.text, "finish_reason": "stop", "usage": dict(USAGE)}

    def generate_stream(self, prompt, **kw):
        self.calls.append(kw)
        yield from self.events

    def slots_in_use(self):
        return 0

    def queue_depth(self):
        return 0

    def prefix_cache_stats(self):
        return {}

    def paging_stats(self):
        return {}


def _post(engine: StubEngine, body: dict):
    """POST `body` to /v1/chat/completions of a server over `engine`;
    returns the JSON answer, or the SSE `data:` lines when streaming."""
    api = serve({"stub": engine})
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{api.port}/v1/chat/completions",
            data=json.dumps(dict(body, model="stub")).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=60) as r:
            raw = r.read().decode()
    finally:
        api.shutdown()
    if body.get("stream"):
        return [ln[6:] for ln in raw.splitlines() if ln.startswith("data: ")]
    return json.loads(raw)


MESSAGES = [{"role": "user", "content": "hi"}]


@pytest.mark.parametrize(
    "text",
    [
        "<think>plan</think> answer ",
        "no block here ",
        "<think>unterminated plan",
        "  \n<think> lead </think>\n the answer\n",
        "answer <think>late</think>",
        "",
    ],
)
def test_split_think_matches_reference(text):
    assert split_think(text) == split_think_ref(text)


def test_chat_sync_splits_think():
    eng = StubEngine(text="<think>plan</think> answer ")
    out = _post(eng, {"messages": MESSAGES})
    msg = out["choices"][0]["message"]
    assert msg == {"role": "assistant", "content": "answer", "reasoning": "plan"}
    # no think block: the text is the content and no reasoning key is sent
    eng = StubEngine(text="plain answer")
    msg = _post(eng, {"messages": MESSAGES})["choices"][0]["message"]
    assert msg == {"role": "assistant", "content": "plain answer"}


@pytest.mark.parametrize("stream", [False, True])
def test_chat_body_top_k_does_not_reach_engine(stream):
    eng = StubEngine(text="ok", events=[{"type": "done", "usage": USAGE, "finish_reason": "stop"}])
    _post(eng, {"messages": MESSAGES, "top_k": 5, "top_p": 0.5, "temperature": 0.3,
                "stream": stream})
    (kw,) = eng.calls
    assert "top_k" not in kw
    assert (kw["top_p"], kw["temperature"]) == (0.5, 0.3)


def test_chat_stream_error_keeps_finish_stop():
    eng = StubEngine(events=[
        {"type": "token", "text": "a"},
        {"type": "error", "error": "engine failed"},
    ])
    lines = _post(eng, {"messages": MESSAGES, "stream": True})
    assert lines[-1] == "[DONE]"
    chunks = [json.loads(ln) for ln in lines[:-1]]
    assert chunks[1]["choices"][0]["delta"] == {"content": "a"}
    assert chunks[-2]["error"] == {"message": "engine failed"}
    assert chunks[-1]["choices"][0]["finish_reason"] == "stop"
