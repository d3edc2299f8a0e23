"""OpenAI-shaped chat completions over local engines (counterpart of the
local chat path of `llm_mcp_tpu/api/inference.py`).

`POST /v1/chat/completions` answers from a local `GenerationEngine`,
streaming (SSE chunks ending in `data: [DONE]`) or in one JSON body.
`GET /v1/models` lists the served models and `GET /health` reports the
engines (each one's `prefix_cache`, `paging` and `memory` blocks).

Load shedding, as the reference: before dispatch the engine's
`admission_state()` is asked; above its watermark the request is shed
with 429 and a `Retry-After` from the engine's drain estimate, and the
engine records the shed (`note_shed`). A body's `priority` (an integer, 0
when absent or malformed) reaches the engine, whose KV pool may preempt a
lower priority stream for it. Smart model selection, proxying to other
devices, the cloud fallback, constraints and tenants come in later slices.
"""

from __future__ import annotations

import time
import uuid
from typing import Any

from ..utils.tokens import messages_to_prompt, split_think
from .http import HTTPApi, Request, Response


class InferenceAPI:
    def __init__(self, engines: dict[str, Any]):
        self.engines = dict(engines)

    def register(self, api: HTTPApi) -> None:
        api.route("POST", "/v1/chat/completions", self.handle_chat_completions)
        api.route("GET", "/v1/models", self.handle_models)
        api.route("GET", "/health", self.handle_health)

    def _engine(self, model: str):
        if not model and len(self.engines) == 1:
            return next(iter(self.engines.items()))
        return model, self.engines.get(model)

    def handle_models(self, req: Request, resp: Response) -> None:
        resp.write_json({
            "object": "list",
            "data": [
                {"id": name, "object": "model", "owned_by": "local"} for name in self.engines
            ],
        })

    def handle_health(self, req: Request, resp: Response) -> None:
        resp.write_json({
            "status": "ok",
            "engines": {
                name: {
                    "device": str(eng.device),
                    "slots_in_use": eng.slots_in_use(),
                    "queue_depth": eng.queue_depth(),
                    "prefix_cache": eng.prefix_cache_stats(),
                    "paging": eng.paging_stats(),
                    "memory": eng.memory_stats(),
                }
                for name, eng in self.engines.items()
            },
        })

    def handle_chat_completions(self, req: Request, resp: Response) -> None:
        body = req.json()
        messages = body.get("messages") or []
        if not isinstance(messages, list) or not messages:
            resp.write_error("messages required", 400)
            return
        stream = bool(body.get("stream", False))
        try:
            raw_max = body.get("max_tokens", body.get("max_completion_tokens"))
            max_tokens = int(raw_max) if raw_max is not None else 512
            temperature = float(body.get("temperature", 0.7))
            top_p = float(body.get("top_p", 1.0))
        except (TypeError, ValueError) as e:
            resp.write_error(f"invalid numeric parameter: {e}", 400)
            return
        if max_tokens < 1:
            resp.write_error("max_tokens must be >= 1", 400)
            return
        stop = body.get("stop") or []
        if isinstance(stop, str):
            stop = [stop]
        model, engine = self._engine(str(body.get("model") or ""))
        if engine is None:
            resp.write_error(f"model {model!r} not available", 404)
            return
        # above the admission watermark more queued work only slows every
        # stream: shed now, with the engine's drain estimate (an engine
        # without the gate, such as a test's stand-in, admits)
        adm = getattr(engine, "admission_state", None)
        shed, retry_after = adm() if adm is not None else (False, 0.0)
        if shed:
            engine.note_shed()
            resp.extra_headers["Retry-After"] = str(max(1, int(retry_after + 0.5)))
            resp.write_error(
                "server overloaded: admission watermark or tenant quota "
                "exceeded; retry after the indicated delay",
                429,
            )
            return
        try:
            priority = int(body.get("priority") or 0)
        except (TypeError, ValueError):
            priority = 0
        t0 = time.time()
        prompt = messages_to_prompt(messages)
        gen_kwargs = dict(
            max_tokens=max_tokens, temperature=temperature, top_p=top_p, stop=stop,
            priority=priority,
        )
        created = int(t0)
        cmpl_id = f"chatcmpl-{uuid.uuid4().hex[:24]}"
        if stream:
            self._chat_stream(resp, engine, model, prompt, gen_kwargs, cmpl_id, created)
        else:
            self._chat_sync(resp, engine, model, prompt, gen_kwargs, cmpl_id, created)

    def _chat_sync(self, resp, engine, model, prompt, gen_kwargs, cmpl_id, created) -> None:
        try:
            out = engine.generate(prompt, **gen_kwargs)
        except RuntimeError as e:
            resp.write_error(str(e), 500)
            return
        thinking, answer = split_think(out["text"])
        message: dict[str, Any] = {"role": "assistant", "content": answer}
        if thinking:
            message["reasoning"] = thinking
        resp.write_json({
            "id": cmpl_id,
            "object": "chat.completion",
            "created": created,
            "model": model,
            "choices": [{"index": 0, "message": message, "finish_reason": out["finish_reason"]}],
            "usage": out["usage"],
        })

    def _chat_stream(self, resp, engine, model, prompt, gen_kwargs, cmpl_id, created) -> None:
        resp.start_sse()
        base = {"id": cmpl_id, "object": "chat.completion.chunk", "created": created, "model": model}
        first = dict(base, choices=[{"index": 0, "delta": {"role": "assistant"}, "finish_reason": None}])
        if not resp.sse_data(first):
            return
        usage: dict[str, Any] = {}
        finish = "stop"
        for evt in engine.generate_stream(prompt, **gen_kwargs):
            if evt["type"] == "token":
                chunk = dict(
                    base,
                    choices=[{"index": 0, "delta": {"content": evt["text"]}, "finish_reason": None}],
                )
                if not resp.sse_data(chunk):
                    return  # client went away; the engine finishes the slot
            elif evt["type"] == "done":
                usage = evt.get("usage", {})
                finish = evt.get("finish_reason", "stop")
            elif evt["type"] == "error":
                resp.sse_data(dict(base, error={"message": evt.get("error", "")}))
                break
        resp.sse_data(dict(base, choices=[{"index": 0, "delta": {}, "finish_reason": finish}], usage=usage))
        resp.sse_data("[DONE]")


def serve(engines: dict[str, Any], host: str = "127.0.0.1", port: int = 0) -> HTTPApi:
    """Start an HTTP server answering for `engines`; returns it (its
    `port` is the bound one, `shutdown()` stops it)."""
    api = HTTPApi()
    InferenceAPI(engines).register(api)
    api.serve(host, port)
    return api
