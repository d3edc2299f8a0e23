"""`python -m llm_mcp_tpu_torch.api` — serve a model and an embedder on the card.

    python -m llm_mcp_tpu_torch.api --model llama-3.1-8b --max-slots 8 \\
        --max-seq-len 4096 --port 8080

Serves `POST /v1/chat/completions`, `POST /v1/embeddings`, `GET
/v1/models` and `GET /health` until SIGINT or SIGTERM. `--weights-dir
DIR` (env `TPU_WEIGHTS_DIR`) serves a Hugging Face checkpoint directory:
its config.json decides the architecture, its safetensors shards are the
weights (quantized on load with `--quant int8`) and its tokenizer.json the tokenizer (the in-repo
BPE; `LLM_MCP_TPU_TOKENIZER=native|python|hf|byte` forces a backend).
Without it the weights are random from `--seed` and the tokenizer is the
byte tokenizer. `--model` (env `TPU_MODEL`) names the model and, without
a config.json, resolves it in the catalog as the JAX server resolves
`TPU_MODEL` ("qwen2.5-7b", "mistral-7b", "gemma2-9b", "mixtral-8x7b",
"deepseek-r1:1.5b", ...). On the card every family runs but head_dim 64
(Qwen2.5-0.5B), which the engine refuses there. `--device cpu` runs
the plain PyTorch versions of the kernels on the CPU. `--prompt-cache-mb`
(default 256, as the JAX server) sizes the prompt-prefix cache and its
paged pool; 0 turns it off.

`--quant int8` serves int8 weights and `--kv-quant int8` the int8 KV
cache (the JAX package's serving configuration of record is both);
`--decode-compact auto|on|off` sets slot compaction. Their defaults come
from `TPU_QUANT`, `TPU_KV_QUANT` and `TPU_DECODE_COMPACT`, as the JAX
server reads them; the engine warns about an unknown value and drops it.

    python -m llm_mcp_tpu_torch.api --model llama-3.1-8b --max-slots 16 \\
        --quant int8 --kv-quant int8

`--model deepseek-v2-lite` serves DeepSeek-V2-Lite (MLA latent attention,
DeepSeek MoE: dense layer 0, 26 layers of 64 routed and 2 shared experts)
at full depth and width; its configuration of record is int8 weights with
the int8 latent cache (the routed expert banks stay bf16, about 29 GB):

    python -m llm_mcp_tpu_torch.api --model deepseek-v2-lite --quant int8 \\
        --kv-quant int8 --max-slots 16 --max-seq-len 4096

and `--kv-quant ""` serves it with bf16 latents.

Beside the generator the server loads an embedding engine, as the JAX
server does, and answers `POST /v1/embeddings`: `--embed-model` (env
`TPU_EMBED_MODEL`, default `nomic-embed-text`; `qwen3-embedding-8b` is
the 8B decoder embedder), `--embed-weights-dir` (`TPU_EMBED_WEIGHTS_DIR`,
the embedder's own checkpoint directory: the generator's is never used
for it, and a warning says so when only `--weights-dir` is set) and
`--embed-quant int8` (`TPU_EMBED_QUANT`). Its longest input is
`min(--max-seq-len, 8192)` tokens.

    python -m llm_mcp_tpu_torch.api --model llama-3.1-8b \
        --embed-model qwen3-embedding-8b --embed-quant int8
    python -m llm_mcp_tpu_torch.api --device cpu --model tiny-llm \
        --embed-model tiny-embed --max-seq-len 256
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import threading

import torch


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m llm_mcp_tpu_torch.api")
    ap.add_argument("--model", default=os.environ.get("TPU_MODEL", "llama-3.1-8b"))
    ap.add_argument("--weights-dir", default=os.environ.get("TPU_WEIGHTS_DIR", ""),
                    help="Hugging Face checkpoint directory (env TPU_WEIGHTS_DIR)")
    ap.add_argument("--max-slots", type=int, default=8)
    ap.add_argument("--max-seq-len", type=int, default=4096)
    ap.add_argument("--prefill-chunk", type=int, default=512)
    ap.add_argument("--decode-chunk", type=int, default=4)
    ap.add_argument("--prompt-cache-mb", type=int, default=256,
                    help="prompt-prefix cache budget in MiB (0 = off)")
    ap.add_argument("--quant", default=os.environ.get("TPU_QUANT", ""),
                    help='weights: "" (bf16) or int8 (env TPU_QUANT)')
    ap.add_argument("--kv-quant", default=os.environ.get("TPU_KV_QUANT", ""),
                    help='KV cache: "" (bf16) or int8 (env TPU_KV_QUANT)')
    ap.add_argument("--decode-compact", default=os.environ.get("TPU_DECODE_COMPACT", "auto"),
                    help="slot compaction: auto|on|off (env TPU_DECODE_COMPACT)")
    ap.add_argument("--embed-model", default=os.environ.get("TPU_EMBED_MODEL", "nomic-embed-text"),
                    help="embedding model (env TPU_EMBED_MODEL)")
    ap.add_argument("--embed-weights-dir", default=os.environ.get("TPU_EMBED_WEIGHTS_DIR", ""),
                    help="the embedder's checkpoint directory (env TPU_EMBED_WEIGHTS_DIR)")
    ap.add_argument("--embed-quant", default=os.environ.get("TPU_EMBED_QUANT", ""),
                    help='embedder weights: "" (bf16) or int8 (env TPU_EMBED_QUANT)')
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s %(message)s")
    log = logging.getLogger("main")

    from ..executor import EmbeddingEngine, GenerationEngine
    from .inference import serve

    dtype = torch.bfloat16 if args.device != "cpu" else torch.float32
    engine = GenerationEngine(
        args.model,
        weights_dir=args.weights_dir,
        max_slots=args.max_slots,
        max_seq_len=args.max_seq_len,
        prefill_chunk=args.prefill_chunk,
        decode_chunk=args.decode_chunk,
        prompt_cache_mb=args.prompt_cache_mb,
        quant=args.quant,
        kv_quant=args.kv_quant,
        decode_compact=args.decode_compact,
        seed=args.seed,
        dtype=dtype,
        device=args.device,
    ).start()
    if args.weights_dir and not args.embed_weights_dir:
        # the generator's directory never leaks into the embedder (its
        # config.json would describe the wrong model), so the embedder
        # falls back to the byte tokenizer: say it
        log.warning(
            "TPU_EMBED_WEIGHTS_DIR is unset while TPU_WEIGHTS_DIR=%s: embedder %s has no "
            "checkpoint dir and will use the byte tokenizer; set TPU_EMBED_WEIGHTS_DIR to its "
            "weights dir", args.weights_dir, args.embed_model,
        )
    log.info("loading embedding engine: %s", args.embed_model)
    try:
        embedder = EmbeddingEngine(
            args.embed_model,
            weights_dir=args.embed_weights_dir,
            max_seq_len=min(args.max_seq_len, 8192),
            quant=args.embed_quant,
            seed=args.seed,
            dtype=dtype,
            device=args.device,
        )
    except BaseException:
        engine.shutdown()
        raise
    api = serve({args.model: engine}, args.host, args.port,
                embed_engines={args.embed_model: embedder})
    log.info("serving %s and %s on %s:%d (%s)", args.model, args.embed_model, args.host,
             api.port, engine.device)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    stop.wait()
    api.shutdown()
    engine.shutdown()


if __name__ == "__main__":
    main()
