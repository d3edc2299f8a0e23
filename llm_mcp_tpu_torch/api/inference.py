"""OpenAI-shaped chat completions and embeddings over local engines
(counterpart of the local chat and embedding paths of
`llm_mcp_tpu/api/inference.py`).

`POST /v1/chat/completions` answers from a local `GenerationEngine`,
streaming (SSE chunks ending in `data: [DONE]`) or in one JSON body.
`GET /v1/models` lists the served models (`kind` chat or embed) and
`GET /health` reports the engines (each one's `prefix_cache`, `paging`
and `memory` blocks) and the embedders (`EmbeddingEngine.stats`). An
engine serves any decoder family of the catalog, or a Hugging Face
checkpoint directory with its own tokenizer (`GenerationEngine(...,
weights_dir=)`; `python -m llm_mcp_tpu_torch.api --weights-dir`).

Load shedding, as the reference: before dispatch the engine's
`admission_state()` is asked; above its watermark the request is shed
with 429 and a `Retry-After` from the engine's drain estimate, and the
engine records the shed (`note_shed`). A body's `priority` (an integer, 0
when absent or malformed) reaches the engine, whose KV pool may preempt a
lower priority stream for it.

Structured output, as the reference: `response_format` (json_object,
json_schema, and the regex and choice extensions), a forced tool call
(`tools` with `tool_choice` "required" or a named function: a json_schema
over the call object `{"name", "arguments"}`) and `logit_bias` are parsed
after the engine is resolved (`parse_constraints`, the reference's
function), so the bias ids are checked against the serving engine's
vocabulary; a malformed or unsupported one answers 400 with the
reference's message. They reach `generate` only when present, so an
unconstrained request builds the same `GenRequest` as before. Smart model
selection, proxying to other devices, the cloud fallback and tenants are
not ported yet (ROADMAP queue 1).

`POST /v1/embeddings` answers from a local `EmbeddingEngine` with the
reference's local path: the same 400s for a bad body, `input` or
`dimensions`, the first local embedding engine when no model is named,
and the reference's body and `usage`. A model no local engine carries
answers the 503s the reference gives with no cloud provider and no other
device.
"""

from __future__ import annotations

import json
import time
import uuid
from typing import Any

from ..utils.tokens import messages_to_prompt, split_think
from .http import HTTPApi, Request, Response


def parse_constraints(
    body: dict, n_vocab: int, bias_max: int
) -> tuple[dict | None, list | None, str | None]:
    """Distill the OpenAI-style structured-output surface into the engine's
    constraint spec: ``(constraint, logit_bias, error)``.

    - ``response_format``: ``json_object`` / ``json_schema`` (OpenAI), plus
      the ``regex`` and ``choice`` extensions (constrain/schema.py).
    - ``tools`` + ``tool_choice``: a FORCED tool call ("required" or a
      named function) becomes a json_schema constraint over the call
      object ``{"name": ..., "arguments": <parameters schema>}``;
      "auto"/"none"/absent leaves the model unconstrained.
    - ``logit_bias``: OpenAI token-id→bias map, values clamped to ±100;
      out-of-range ids and oversize maps are request errors (400), never
      silent truncation — a dropped bias entry would be an invisible
      behavior change.

    ``error`` is a 400-worthy message; both other slots are None then."""
    constraint: dict | None = None
    rf = body.get("response_format")
    if rf is not None:
        if not isinstance(rf, dict):
            return None, None, "response_format must be an object"
        typ = rf.get("type")
        if typ in (None, "text"):
            pass
        elif typ == "json_object":
            constraint = {"type": "json_object"}
        elif typ == "json_schema":
            js = rf.get("json_schema")
            schema = (
                js.get("schema") if isinstance(js, dict) else rf.get("schema")
            )
            if not isinstance(schema, (dict, bool)):
                return None, None, (
                    "response_format.json_schema requires a schema object"
                )
            constraint = {"type": "json_schema", "schema": schema}
        elif typ == "regex":
            pat = rf.get("pattern")
            if not isinstance(pat, str) or not pat:
                return None, None, "response_format.regex requires a pattern"
            constraint = {"type": "regex", "pattern": pat}
        elif typ == "choice":
            ch = rf.get("choices")
            if (
                not isinstance(ch, list)
                or not ch
                or not all(isinstance(c, str) and c for c in ch)
            ):
                return None, None, (
                    "response_format.choice requires non-empty string choices"
                )
            constraint = {"type": "choice", "choices": ch}
        else:
            return None, None, f"unsupported response_format type {typ!r}"
    tools = body.get("tools")
    tc = body.get("tool_choice")
    if tools is not None and tc not in (None, "none", "auto"):
        if not isinstance(tools, list) or not tools:
            return None, None, "tools must be a non-empty list"
        fns: dict[str, Any] = {}
        for t in tools:
            fn = t.get("function") if isinstance(t, dict) else None
            if not isinstance(fn, dict) or not fn.get("name"):
                return None, None, "each tool requires function.name"
            fns[str(fn["name"])] = fn.get("parameters")
        if isinstance(tc, dict):
            name = (tc.get("function") or {}).get("name")
            if name not in fns:
                return None, None, f"tool_choice names unknown tool {name!r}"
            fns = {name: fns[name]}
        elif tc != "required":
            return None, None, f"unsupported tool_choice {tc!r}"
        calls = [
            {
                "type": "object",
                "properties": {
                    "name": {"const": nm},
                    "arguments": params if params is not None else True,
                },
            }
            for nm, params in fns.items()
        ]
        constraint = {
            "type": "json_schema",
            "schema": calls[0] if len(calls) == 1 else {"anyOf": calls},
        }
    bias: list | None = None
    lb = body.get("logit_bias")
    if lb is not None:
        if not isinstance(lb, dict):
            return None, None, "logit_bias must map token ids to biases"
        if len(lb) > bias_max:
            return None, None, (
                f"logit_bias supports at most {bias_max} entries "
                "(LLM_MCP_TPU_CN_BIAS_MAX)"
            )
        bias = []
        for k, v in lb.items():
            try:
                tid, val = int(k), float(v)
            except (TypeError, ValueError):
                return None, None, f"invalid logit_bias entry {k!r}"
            if n_vocab and not (0 <= tid < n_vocab):
                return None, None, (
                    f"logit_bias token id {tid} out of range [0, {n_vocab})"
                )
            bias.append([tid, max(-100.0, min(100.0, val))])
    return constraint, bias, None


class InferenceAPI:
    def __init__(self, engines: dict[str, Any], embed_engines: dict[str, Any] | None = None):
        self.engines = dict(engines)
        self.embed_engines = dict(embed_engines or {})

    def register(self, api: HTTPApi) -> None:
        api.route("POST", "/v1/chat/completions", self.handle_chat_completions)
        api.route("POST", "/v1/embeddings", self.handle_embeddings)
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
                {"id": name, "object": "model", "owned_by": "local", "kind": kind}
                for kind, names in (("chat", self.engines), ("embed", self.embed_engines))
                for name in names
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
            "embedders": {name: eng.stats() for name, eng in self.embed_engines.items()},
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
        # structured output: parsed after engine resolution, so the bias ids
        # are checked against the serving engine's vocabulary
        cfg = getattr(engine, "cfg", None)
        constraint, logit_bias, cn_err = parse_constraints(
            body, int(getattr(cfg, "vocab_size", 0) or 0), int(getattr(engine, "cn_bias_max", 64)),
        )
        if cn_err is not None:
            resp.write_error(cn_err, 400)
            return
        t0 = time.time()
        prompt = messages_to_prompt(messages)
        gen_kwargs = dict(
            max_tokens=max_tokens, temperature=temperature, top_p=top_p, stop=stop,
            priority=priority,
        )
        # only constrained requests carry the keywords
        if constraint is not None:
            gen_kwargs["constraint"] = constraint
        if logit_bias:
            gen_kwargs["logit_bias"] = logit_bias
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


    def handle_embeddings(self, req: Request, resp: Response) -> None:
        try:
            body = req.json()
        except json.JSONDecodeError:
            body = None
        if not isinstance(body, dict):
            resp.write_error("invalid JSON body", 400)
            return
        model = str(body.get("model") or "")
        raw_input = body.get("input")
        if isinstance(raw_input, str):
            texts = [raw_input]
        elif isinstance(raw_input, list) and all(isinstance(t, str) for t in raw_input):
            texts = raw_input
        else:
            resp.write_error("input must be a string or list of strings", 400)
            return
        if not texts:
            resp.write_error("input must not be empty", 400)
            return
        try:
            dimensions = body.get("dimensions")
            dimensions = int(dimensions) if dimensions else None
        except (TypeError, ValueError):
            resp.write_error("dimensions must be an integer", 400)
            return
        if not model:
            model = next(iter(self.embed_engines), "")
        if not model:
            resp.write_error("no embedding model available", 503)
            return
        engine = self.embed_engines.get(model)
        # the cloud provider, the proxy to other devices and the metrics
        # counters of the reference's path are ROADMAP queue 1 item 9
        if engine is None:
            if "/" in model:
                resp.write_error("no cloud provider configured", 503)
            else:
                resp.write_error(f"embeddings unavailable for {model!r}: no device has the model",
                                 503)
            return
        vectors, ntok = engine.embed(texts, dimensions=dimensions)
        resp.write_json({
            "object": "list",
            "data": [{"object": "embedding", "embedding": v, "index": i}
                     for i, v in enumerate(vectors)],
            "model": model,
            "usage": {"prompt_tokens": ntok, "total_tokens": ntok},
        })


def serve(engines: dict[str, Any], host: str = "127.0.0.1", port: int = 0,
          embed_engines: dict[str, Any] | None = None) -> HTTPApi:
    """Start an HTTP server answering for `engines` (chat) and
    `embed_engines` (embeddings); returns it (its `port` is the bound one,
    `shutdown()` stops it)."""
    api = HTTPApi()
    InferenceAPI(engines, embed_engines).register(api)
    api.serve(host, port)
    return api
