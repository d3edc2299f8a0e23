"""`python -m llm_mcp_tpu_torch.api` — boot the core server with a model and
an embedder on the card (counterpart of `python -m llm_mcp_tpu.api`).

    python -m llm_mcp_tpu_torch.api --model llama-3.1-8b --max-slots 8 \\
        --max-seq-len 4096 --port 8080

Boots a `CoreServer` (`api/server.py`): the job API and the worker
protocol, `/v1/llm/request`, `/v1/chat/completions` (through the router),
`/v1/embeddings`, the catalog routes, `/metrics` and `/v1/traces`, until
SIGINT or SIGTERM. Pull workers (`python -m llm_mcp_tpu_torch.worker`)
claim the jobs. The JAX package's process settings apply: `CORE_HTTP_ADDR`
(`host:port`, default `:8080`; `--host` / `--port` override it), `DB_PATH`
(the SQLite job queue and catalog, default `llmmcp.sqlite3`; `--db-path`),
`--advertise-addr` (the `host:port` the catalog gives other processes for
this device; default the bound address) and `TPU_DISABLE_ENGINES=1` (a
router-only core: no engine is loaded, jobs go to workers and devices).
Beside it the gRPC worker protocol (`rpc/`, the JAX server's eleven RPCs
on the port's own wire) listens on `CORE_GRPC_ADDR` (default `:9090`):
workers with `CORE_GRPC_TARGET` claim over it. With a generation engine
the same server hosts the KV transfer endpoint (Transfer for remote
migration into this process, PrefixFetch for the fleet prefix tier), and
the device advertises `TPU_TRANSFER_ADDR` (else `CORE_GRPC_ADDR` as it is)
as its `transfer_addr`; `TPU_MIGRATE_PEER` (host:port, comma-separated)
names remote decode engines that `TPU_MIGRATE=1` hands streams to. The
boot logs a checksum of the generator's parameter tree
(`models/weights.py:params_checksum`): processes that hand streams or
prefixes to each other must print the same one.

    CORE_GRPC_ADDR=127.0.0.1:9090 TPU_TRANSFER_ADDR=127.0.0.1:9090 \
        python -m llm_mcp_tpu_torch.api --model llama-3.1-8b --quant int8 --kv-quant int8

`--weights-dir
DIR` (env `TPU_WEIGHTS_DIR`) serves a Hugging Face checkpoint directory:
its config.json decides the architecture, its safetensors shards are the
weights (quantized on load with `--quant int8`) and its tokenizer.json the tokenizer (the in-repo
BPE; `LLM_MCP_TPU_TOKENIZER=native|python|hf|byte` forces a backend).
Without it the weights are random from `--seed` and the tokenizer is the
byte tokenizer. `--model` (env `TPU_MODEL`) names the model and, without
a config.json, resolves it in the catalog as the JAX server resolves
`TPU_MODEL` ("qwen2.5-7b", "mistral-7b", "gemma2-9b", "mixtral-8x7b",
"deepseek-r1:1.5b", ...). On the card every catalog family runs (the tiny
test configs' head_dim 32 runs on the CPU only). `--device cpu` runs
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

A model zoo (`executor/zoo.py`) co-hosts more generation models on the
card, as the JAX server's: `TPU_ZOO_MODELS` names them (comma-separated;
the primary `--model` is left out), the first `TPU_ZOO_HOT` (default 1)
load at boot and the rest park in host memory until a request swaps them
in (`TPU_ZOO_SWAP=0`: a parked model answers 503). Their engines take
every construction option of the primary but its checkpoint directory
(whose config.json would make every zoo model the primary's): random
weights from `--seed`. Tenants: `TPU_TENANT_QUOTAS` ("alice=600,*=100",
tokens a second) meters the requests whose `X-Tenant-Id` header
(`TPU_TENANT_HEADER` renames it) names a tenant; one over its quota gets a
429 with `Retry-After`.

    TPU_ZOO_MODELS=llama-3.2-1b,qwen2.5-0.5b TPU_ZOO_HOT=1 \
    TPU_TENANT_QUOTAS="alice=400,bob=4000" python -m llm_mcp_tpu_torch.api \
        --model llama-3.1-8b --quant int8 --kv-quant int8 --max-slots 16

Tensor parallelism, as the JAX server boots it: `TPU_MESH_SHAPE` (e.g.
`tp=2`) with the JAX package's process triplet (`JAX_COORDINATOR_ADDRESS`,
`JAX_NUM_PROCESSES`, `JAX_PROCESS_ID`: `parallel/distributed.py` starts
`torch.distributed` from it, backend `gloo`) and `TPU_SLICE_CMD_ADDR` (the
leader's command channel, host:port). Every rank runs the same command;
rank 0 serves the leader `SliceEngine` inside the core server, every other
rank replays its steps (`run_follower`) and never binds HTTP. Each rank
runs on `cuda:{rank % device_count}` (`--device cpu`: CPU ranks).

    JAX_COORDINATOR_ADDRESS=127.0.0.1:29500 JAX_NUM_PROCESSES=2 JAX_PROCESS_ID=0 \
    TPU_MESH_SHAPE=tp=2 TPU_SLICE_CMD_ADDR=127.0.0.1:29501 \
        python -m llm_mcp_tpu_torch.api --model llama-3.1-8b --quant int8 --kv-quant int8
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import threading

import torch


def boot_zoo(cfg, gen_engines: dict, engine_kw: dict):
    """The model zoo of `cfg.tpu_zoo_models` (None when unset), as the JAX
    server boots it: the primary engines' models left out, the first
    `tpu_zoo_hot` loaded and started now, the rest parked until a request.
    Its factory builds each engine with `engine_kw`, the primary's
    construction options (host_params None: the cold first load; a tree:
    a parked model's swap-in)."""
    from ..executor import GenerationEngine, ModelZoo

    if not cfg.tpu_zoo_models:
        return None

    def zoo_factory(name, host_params):
        return GenerationEngine(name, params=host_params, **engine_kw)

    zoo = ModelZoo(zoo_factory, hot=cfg.tpu_zoo_hot, swap=cfg.tpu_zoo_swap)
    catalog = [m.strip() for m in cfg.tpu_zoo_models.split(",")
               if m.strip() and m.strip() not in gen_engines]
    try:
        for i, name in enumerate(catalog):
            zoo.register(name, resident=i < cfg.tpu_zoo_hot)
    except BaseException:
        zoo.shutdown()
        raise
    logging.getLogger("main").info(
        "model zoo: %d models (%s resident), hot=%d swap=%s", len(catalog),
        ",".join(zoo.resident_models()) or "none", cfg.tpu_zoo_hot, cfg.tpu_zoo_swap)
    return zoo


def main(argv: list[str] | None = None) -> None:
    # the handlers first: a signal during the boot stops the server after it
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    server, grpc_server = boot(argv)
    if server is None:
        return  # a follower rank: its replay ended with the leader's stop
    stop.wait()
    logging.getLogger("main").info("shutting down")
    if grpc_server is not None:
        grpc_server.stop()
    server.shutdown()


def boot(argv: list[str] | None = None):
    """The engines, the started core server and, when `CORE_GRPC_ADDR`
    is set, the started gRPC server beside it, as the JAX `main` boots
    them. Returns (server, grpc_server or None); `main` serves until a
    signal. A follower rank of a mesh (`TPU_MESH_SHAPE`) replays the
    leader's steps here until it stops, and returns (None, None)."""
    from ..utils.config import Config
    from ..utils.logging import setup_logging

    cfg = Config()
    default_host, _, default_port = cfg.http_addr.rpartition(":")
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
    ap.add_argument("--host", default=default_host or "0.0.0.0",
                    help="bind address (env CORE_HTTP_ADDR host part)")
    ap.add_argument("--port", type=int, default=int(default_port or 8080),
                    help="bind port (env CORE_HTTP_ADDR port part)")
    ap.add_argument("--db-path", default=cfg.db_path, help="SQLite file (env DB_PATH)")
    ap.add_argument("--advertise-addr", default="",
                    help="host:port other processes reach this device at")
    args = ap.parse_args(argv)
    setup_logging(logging.getLevelName(os.environ.get("LOG_LEVEL", "INFO")))
    log = logging.getLogger("main")

    from ..executor import EmbeddingEngine, GenerationEngine
    from ..models.weights import params_checksum
    from ..state.db import Database
    from .server import CoreServer

    gen_engines: dict = {}
    embed_engines: dict = {}
    zoo = None
    if os.environ.get("TPU_DISABLE_ENGINES", "") not in ("1", "true"):
        dtype = torch.bfloat16 if args.device != "cpu" else torch.float32
        mesh = None
        if cfg.tpu_mesh_shape:
            # the process group first (from JAX's triplet), then this
            # rank's mesh and device
            from ..parallel import distributed

            distributed.initialize(device="cpu" if args.device == "cpu" else None)
            mesh = distributed.make_global_mesh(
                cfg.tpu_mesh_shape, device="cpu" if args.device == "cpu" else None)
            log.info("serving over %r (backend %s)", mesh, mesh.backend)
            args.device = str(mesh.device)
        engine_kw = dict(
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
        )
        if mesh is not None and mesh.size > 1:
            from ..executor import SliceEngine

            if not cfg.tpu_slice_cmd_addr:
                raise ValueError(f"TPU_MESH_SHAPE={cfg.tpu_mesh_shape!r} spans {mesh.size} ranks: "
                                 "set TPU_SLICE_CMD_ADDR (the leader's command channel)")
            kw = {k: v for k, v in engine_kw.items() if k not in ("device",)}
            engine = SliceEngine(args.model, mesh=mesh, cmd_addr=cfg.tpu_slice_cmd_addr,
                                 weights_dir=args.weights_dir, **kw)
            if mesh.rank != 0:
                log.info("slice follower %d/%d on %s: replaying the leader's steps",
                         mesh.rank, mesh.size, mesh.device)
                engine.run_follower()
                return None, None
            engine.start()
        else:
            engine = GenerationEngine(args.model, weights_dir=args.weights_dir, mesh=mesh,
                                      **engine_kw).start()
        gen_engines[args.model] = engine
        # processes that hand streams or prefixes to each other must hold
        # the same weights: this line lets an operator compare them
        log.info("weights of %s: checksum %s", args.model, params_checksum(engine.params))
        # the generator's directory never leaks into the embedder (its
        # config.json would describe the wrong model), so the embedder
        # falls back to the byte tokenizer: say it
        cfg.tpu_weights_dir, cfg.tpu_embed_weights_dir = args.weights_dir, args.embed_weights_dir
        cfg.tpu_embed_model = args.embed_model
        cfg.warn_embed_dir_gap(log)
        log.info("loading embedding engine: %s", args.embed_model)
        try:
            embed_engines[args.embed_model] = EmbeddingEngine(
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
        try:
            zoo = boot_zoo(cfg, gen_engines, engine_kw)
        except BaseException:
            engine.shutdown()
            raise
    server = CoreServer(
        cfg,
        db=Database(args.db_path),
        gen_engines=gen_engines,
        embed_engines=embed_engines,
        advertise_addr=args.advertise_addr,
        zoo=zoo,
    ).start(args.host, args.port)
    log.info("core server on %s:%d serving %s", args.host, server.port,
             ", ".join(sorted(gen_engines) + sorted(embed_engines)) or "no engine (router only)")
    grpc_server = None
    if cfg.grpc_addr:
        from ..rpc import GrpcCoreServer

        ghost, _, gport = cfg.grpc_addr.rpartition(":")
        grpc_server = GrpcCoreServer(
            server.queue,
            server.catalog,
            circuit=server.router.circuit,
            device_max_concurrency=cfg.device_max_concurrency,
            default_lease_s=float(cfg.worker_lease_seconds),
        )
        if gen_engines:
            # the KV transfer endpoint on the same server: remote migration
            # in, and the fleet prefix tier's PrefixFetch out; the device
            # advertises the address peers dial for it
            eng = next(iter(gen_engines.values()))
            grpc_server.enable_kv_transfer(
                eng.migrate_import_stream,
                prefix_export=server.prefix_export,
                prefix_export_hash=server.prefix_export_hash,
            )
            server.transfer_addr = server.transfer_addr or cfg.grpc_addr
        try:
            grpc_server.start(f"{ghost or '0.0.0.0'}:{gport or 9090}")
        except BaseException:
            server.shutdown()
            raise
        log.info("grpc worker protocol on %s (port %d)", cfg.grpc_addr, grpc_server.port)
    return server, grpc_server


if __name__ == "__main__":
    main()
