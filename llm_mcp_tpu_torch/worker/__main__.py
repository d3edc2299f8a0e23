"""`python -m llm_mcp_tpu_torch.worker` — boot a pull worker (counterpart of
`python -m llm_mcp_tpu.worker`).

    CORE_URL=http://core:8080 python -m llm_mcp_tpu_torch.worker
    WORKER_LOAD_ENGINES=1 TPU_MODEL=llama-3.1-8b python -m llm_mcp_tpu_torch.worker
    WORKER_LOAD_ENGINES=1 TPU_MODEL=tiny-llm TPU_EMBED_MODEL=tiny-embed \\
        python -m llm_mcp_tpu_torch.worker --device cpu
    CORE_GRPC_TARGET=core:9090 WORKER_LOAD_ENGINES=1 python -m llm_mcp_tpu_torch.worker

Env-configured like the JAX package's worker: `CORE_URL` points at the
core's HTTP worker protocol; `WORKER_ID`, `WORKER_NAME`, `WORKER_KINDS`
(comma-separated job kinds, empty = any) and `WORKER_LEASE_SECONDS` set
the worker. With `WORKER_LOAD_ENGINES=1` the engines (`TPU_MODEL`,
`TPU_EMBED_MODEL` and the other `TPU_*` engine settings) load in-process
on the card, or on the CPU only with `--device cpu`; otherwise jobs proxy
to the routed device's address or to the cloud provider. With
`CORE_GRPC_TARGET` set the worker speaks the gRPC worker protocol
(`rpc/client.py:GrpcCoreClient`) to the core's `CORE_GRPC_ADDR` instead of
HTTP; a target that is down surfaces as the transport's errors (the
worker retries them), never as a switch to HTTP.

`TPU_MESH_SHAPE` (with JAX's process triplet and `TPU_SLICE_CMD_ADDR`, as
`python -m llm_mcp_tpu_torch.api`) serves the generator over a tp mesh of
processes: rank 0 is the worker with the leader engine, every other rank
replays its steps and never claims a job.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m llm_mcp_tpu_torch.worker")
    ap.add_argument("--device", default="cuda",
                    help="where WORKER_LOAD_ENGINES=1 loads the engines: cuda or cpu")
    args = ap.parse_args(argv)
    from ..api.providers import CloudClient
    from ..utils.config import Config
    from ..utils.logging import setup_logging
    from .client import CoreClient
    from .executors import Executors
    from .worker import Worker

    setup_logging(logging.getLevelName(os.environ.get("LOG_LEVEL", "INFO")))
    cfg = Config()
    core_url = os.environ.get("CORE_URL", "http://localhost:8080")

    gen_engines: dict = {}
    embed_engines: dict = {}
    if os.environ.get("WORKER_LOAD_ENGINES", "") in ("1", "true"):
        import torch

        from ..executor import EmbeddingEngine, GenerationEngine

        dtype = torch.bfloat16 if args.device != "cpu" else torch.float32
        model = cfg.tpu_model
        mesh = None
        if cfg.tpu_mesh_shape:
            from ..executor import SliceEngine
            from ..parallel import distributed

            distributed.initialize(device="cpu" if args.device == "cpu" else None)
            mesh = distributed.make_global_mesh(
                cfg.tpu_mesh_shape, device="cpu" if args.device == "cpu" else None)
            args.device = str(mesh.device)
            if mesh.size > 1:
                eng = SliceEngine(
                    model, mesh=mesh, cmd_addr=cfg.tpu_slice_cmd_addr,
                    max_slots=cfg.tpu_max_slots, max_seq_len=cfg.tpu_max_seq_len, dtype=dtype,
                    weights_dir=cfg.tpu_weights_dir, quant=cfg.tpu_quant,
                    kv_quant=cfg.tpu_kv_quant, prefill_chunk=cfg.tpu_prefill_chunk,
                    decode_compact=cfg.tpu_decode_compact,
                    prompt_cache_mb=cfg.tpu_prompt_cache_mb,
                    target_ttft_ms=cfg.tpu_target_ttft_ms)
                if mesh.rank != 0:
                    eng.run_follower()
                    return
                gen_engines[model] = eng.start()
        gen_engines[model] = gen_engines.get(model) or GenerationEngine(
            model,
            mesh=mesh,
            max_slots=cfg.tpu_max_slots,
            max_seq_len=cfg.tpu_max_seq_len,
            dtype=dtype,
            weights_dir=cfg.tpu_weights_dir,
            quant=cfg.tpu_quant,
            kv_quant=cfg.tpu_kv_quant,
            prefill_chunk=cfg.tpu_prefill_chunk,
            decode_compact=cfg.tpu_decode_compact,
            prompt_cache_mb=cfg.tpu_prompt_cache_mb,
            target_ttft_ms=cfg.tpu_target_ttft_ms,
            device=args.device,
        ).start()
        cfg.warn_embed_dir_gap(logging.getLogger("worker"))
        try:
            embed_engines[cfg.tpu_embed_model] = EmbeddingEngine(
                cfg.tpu_embed_model,
                max_seq_len=min(cfg.tpu_max_seq_len, 8192),
                dtype=dtype,
                weights_dir=cfg.tpu_embed_weights_dir,
                quant=cfg.tpu_embed_quant,
                device=args.device,
            )
        except BaseException:
            gen_engines[model].shutdown()
            raise

    cloud = CloudClient(cfg) if (cfg.has_openrouter() or cfg.has_openai()) else None
    # gRPC transport when configured (the reference worker was gRPC-only,
    # `main.py:536-599`); HTTP otherwise. Worker is transport-agnostic.
    grpc_target = os.environ.get("CORE_GRPC_TARGET", "")
    if grpc_target:
        from ..rpc.client import GrpcCoreClient

        client = GrpcCoreClient(grpc_target)
    else:
        client = CoreClient(core_url)
    worker = Worker(
        client,
        Executors(gen_engines=gen_engines, embed_engines=embed_engines, cloud=cloud),
        worker_id=cfg.worker_id,
        name=cfg.worker_name,
        kinds=[k.strip() for k in cfg.worker_kinds.split(",") if k.strip()],
        lease_seconds=float(cfg.worker_lease_seconds),
    )
    signal.signal(signal.SIGTERM, lambda *_: worker.stop())
    signal.signal(signal.SIGINT, lambda *_: worker.stop())
    worker.run()
    for e in gen_engines.values():
        e.shutdown()


if __name__ == "__main__":
    main()
