"""Env-var configuration (counterpart of `llm_mcp_tpu/utils/config.py`).

Pure env-var config with typed helpers and a `Config` snapshot, so
services build hermetically in tests. The fields are those the core
server, discovery, knowledge ingest, the job plane and the workers read,
with the JAX package's env names and defaults. Of JAX's compile cache only
the warm-up pack's plan has a counterpart: `compile_cache_path` names the
directory (`TPU_COMPILE_CACHE`) whose `warmup_plan.json` the server's boot
hands to the warm-up planner as priors. The pack's XLA executables have
none on the card: the kernel libraries build from their sources and the
decode rounds' CUDA graphs are captured anew in each process, so
`enable_compile_cache` is not ported. The engines' own knobs (`TPU_SPEC`,
`TPU_KV_HOST_OFFLOAD`, ...) are read by the engines at construction.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


def getenv(key: str, default: str = "") -> str:
    v = os.environ.get(key, "")
    return v if v != "" else default


def getenv_int(key: str, default: int) -> int:
    v = os.environ.get(key, "")
    try:
        return int(v)
    except (TypeError, ValueError):
        return default


def getenv_float(key: str, default: float) -> float:
    v = os.environ.get(key, "")
    try:
        return float(v)
    except (TypeError, ValueError):
        return default


def getenv_bool(key: str, default: bool = False) -> bool:
    v = os.environ.get(key, "").strip().lower()
    if v in ("1", "true", "yes", "on"):
        return True
    if v in ("0", "false", "no", "off"):
        return False
    return default


@dataclass
class Config:
    """Snapshot of the service configuration."""

    # Core service: the HTTP API and the gRPC worker protocol (`rpc/`)
    http_addr: str = field(default_factory=lambda: getenv("CORE_HTTP_ADDR", ":8080"))
    grpc_addr: str = field(default_factory=lambda: getenv("CORE_GRPC_ADDR", ":9090"))
    db_path: str = field(default_factory=lambda: getenv("DB_PATH", "llmmcp.sqlite3"))

    # Discovery (`discovery/`): the server's ticker runs a discovery run
    # (self-registration, TPU-slice metadata peers, static endpoints, the
    # optional subnet sweep) at this interval
    discovery_interval_s: int = field(default_factory=lambda: getenv_int("DISCOVERY_INTERVAL", 60))
    tpu_extra_endpoints: str = field(default_factory=lambda: getenv("TPU_EXTRA_ENDPOINTS", ""))
    discovery_scan_subnets: bool = field(default_factory=lambda: getenv_bool("DISCOVERY_SCAN_SUBNETS"))
    discovery_subnets: str = field(default_factory=lambda: getenv("DISCOVERY_SUBNETS", ""))

    # Scheduling / limits
    device_max_concurrency: int = field(default_factory=lambda: getenv_int("DEVICE_MAX_CONCURRENCY", 2))
    strict_model_limits: bool = field(default_factory=lambda: getenv_bool("STRICT_MODEL_LIMITS"))
    device_limits_interval_s: int = field(default_factory=lambda: getenv_int("DEVICE_LIMITS_INTERVAL", 300))
    # planner (background maintenance, `planner.py`); 0 interval disables
    planner_interval_s: int = field(default_factory=lambda: getenv_int("PLANNER_INTERVAL", 3600))
    planner_stale_days: float = field(default_factory=lambda: getenv_float("PLANNER_STALE_DAYS", 7.0))
    planner_max_price_per_1m: float = field(default_factory=lambda: getenv_float("PLANNER_MAX_PRICE_PER_1M", 0.0))
    planner_bench_max_age_s: float = field(default_factory=lambda: getenv_float("PLANNER_BENCH_MAX_AGE_S", 0.0))
    benchmark_max_price_per_1m: float = field(default_factory=lambda: getenv_float("BENCHMARK_MAX_PRICE_PER_1M", 10.0))

    # Worker
    worker_id: str = field(default_factory=lambda: getenv("WORKER_ID", ""))
    worker_name: str = field(default_factory=lambda: getenv("WORKER_NAME", ""))
    worker_kinds: str = field(default_factory=lambda: getenv("WORKER_KINDS", ""))
    worker_lease_seconds: int = field(default_factory=lambda: getenv_int("WORKER_LEASE_SECONDS", 30))

    # Cloud providers
    openai_api_key: str = field(default_factory=lambda: getenv("OPENAI_API_KEY", ""))
    openai_base_url: str = field(default_factory=lambda: getenv("OPENAI_BASE_URL", "https://api.openai.com/v1"))
    openrouter_api_key: str = field(default_factory=lambda: getenv("OPENROUTER_API_KEY", ""))
    openrouter_base_url: str = field(
        default_factory=lambda: getenv("OPENROUTER_BASE_URL", "https://openrouter.ai/api/v1")
    )

    # Knowledge services (`POST /v1/knowledge/ingest` proxies to them)
    lightrag_url: str = field(default_factory=lambda: getenv("LIGHTRAG_URL", ""))
    lightrag_api_key: str = field(default_factory=lambda: getenv("LIGHTRAG_API_KEY", ""))
    mem0_url: str = field(default_factory=lambda: getenv("MEM0_URL", ""))

    # Telemetry (the alert monitor, `python -m llm_mcp_tpu_torch.telemetry`)
    telegram_bot_token: str = field(default_factory=lambda: getenv("TELEGRAM_BOT_TOKEN", ""))
    telegram_chat_id: str = field(default_factory=lambda: getenv("TELEGRAM_CHAT_ID", ""))
    telemetry_interval_s: int = field(default_factory=lambda: getenv_int("TELEMETRY_INTERVAL", 30))
    alert_fail_threshold: int = field(default_factory=lambda: getenv_int("ALERT_FAIL_THRESHOLD", 5))

    # Executor (the engines a core or worker loads)
    tpu_model: str = field(default_factory=lambda: getenv("TPU_MODEL", "llama-3.1-8b"))
    tpu_embed_model: str = field(default_factory=lambda: getenv("TPU_EMBED_MODEL", "nomic-embed-text"))
    tpu_embed_quant: str = field(default_factory=lambda: getenv("TPU_EMBED_QUANT", ""))
    tpu_weights_dir: str = field(default_factory=lambda: getenv("TPU_WEIGHTS_DIR", ""))
    # the embed model's OWN checkpoint dir: the generator's never leaks in
    tpu_embed_weights_dir: str = field(
        default_factory=lambda: getenv("TPU_EMBED_WEIGHTS_DIR", "")
    )
    tpu_max_slots: int = field(default_factory=lambda: getenv_int("TPU_MAX_SLOTS", 32))
    tpu_max_seq_len: int = field(default_factory=lambda: getenv_int("TPU_MAX_SEQ_LEN", 2048))
    # the mesh the generation engine serves over (parallel/mesh.py syntax,
    # e.g. "tp=2"; empty: one device) and, with more than one rank, the
    # leader's command-channel address: rank 0 serves the leader
    # SliceEngine inside CoreServer, every other rank replays its steps
    # (run_follower) and never binds HTTP
    tpu_mesh_shape: str = field(default_factory=lambda: getenv("TPU_MESH_SHAPE", ""))
    tpu_slice_cmd_addr: str = field(default_factory=lambda: getenv("TPU_SLICE_CMD_ADDR", ""))
    tpu_quant: str = field(default_factory=lambda: getenv("TPU_QUANT", ""))  # "" | int8
    tpu_kv_quant: str = field(default_factory=lambda: getenv("TPU_KV_QUANT", ""))  # "" | int8
    tpu_prefill_chunk: int = field(default_factory=lambda: getenv_int("TPU_PREFILL_CHUNK", 512))
    tpu_target_ttft_ms: float = field(default_factory=lambda: getenv_float("TPU_TARGET_TTFT_MS", 2000.0))
    tpu_decode_compact: str = field(default_factory=lambda: getenv("TPU_DECODE_COMPACT", "auto"))
    tpu_prompt_cache_mb: int = field(default_factory=lambda: getenv_int("TPU_PROMPT_CACHE_MB", 256))
    # extra API ports that discovery probes on every host (comma-separated;
    # the server probes its own bound port first)
    tpu_extra_ports: str = field(default_factory=lambda: getenv("TPU_EXTRA_PORTS", ""))
    # model zoo (executor/zoo.py): TPU_ZOO_MODELS is a comma-separated catalog
    # co-hosted on the card ("" = no zoo); TPU_ZOO_HOT caps how many stay
    # resident; the rest park in host memory and TPU_ZOO_SWAP=0 makes a
    # parked model a 503 instead of a swap-in
    tpu_zoo_models: str = field(default_factory=lambda: getenv("TPU_ZOO_MODELS", ""))
    tpu_zoo_hot: int = field(default_factory=lambda: getenv_int("TPU_ZOO_HOT", 1))
    tpu_zoo_swap: bool = field(default_factory=lambda: getenv("TPU_ZOO_SWAP", "1") != "0")
    # per-tenant quotas (executor/scheduler.py token buckets), tokens a
    # second: "alice=600,bob=300,*=1000"; "" = unmetered. The engines read
    # the env at construction; TPU_TENANT_HEADER renames the request header
    # of the tenant id (default X-Tenant-Id, api/inference.py)
    tpu_tenant_quotas: str = field(default_factory=lambda: getenv("TPU_TENANT_QUOTAS", ""))
    tpu_tenant_header: str = field(default_factory=lambda: getenv("TPU_TENANT_HEADER", ""))

    def __post_init__(self) -> None:
        # DB_DSN was documented but never read by any backend (the store is
        # sqlite at DB_PATH, full stop). A silently inert knob is an operator
        # trap — fail loud instead of letting a configured DSN be ignored.
        if os.environ.get("DB_DSN", ""):
            raise RuntimeError(
                "DB_DSN is set but unsupported: the only storage backend is "
                "sqlite at DB_PATH. Unset DB_DSN (or set DB_PATH) to proceed."
            )

    def has_openai(self) -> bool:
        return bool(self.openai_api_key)

    def has_openrouter(self) -> bool:
        return bool(self.openrouter_api_key)

    def warn_embed_dir_gap(self, log) -> None:
        """Deployments that set only TPU_WEIGHTS_DIR: the generator's dir
        deliberately does NOT leak into the embedder (its config.json would
        be authoritative for the wrong model), but the resulting silent
        byte-tokenizer fallback changes embedding outputs — say it out loud
        at every serving entrypoint."""
        if not self.tpu_embed_weights_dir and self.tpu_weights_dir:
            log.warning(
                "TPU_EMBED_WEIGHTS_DIR is unset while TPU_WEIGHTS_DIR=%s: "
                "embedder %s has no checkpoint dir and will use the byte "
                "tokenizer; set TPU_EMBED_WEIGHTS_DIR to its weights dir",
                self.tpu_weights_dir, self.tpu_embed_model,
            )


def compile_cache_path() -> str:
    """The warm-up pack's directory: `TPU_COMPILE_CACHE` names it;
    `0`/`off`/`false`/`no` or unset disable it ("" returned). JAX's
    fallback to `JAX_COMPILATION_CACHE_DIR`, a variable of JAX's own, is
    not read here."""
    knob = getenv("TPU_COMPILE_CACHE", "").strip()
    if knob.lower() in ("0", "off", "false", "no"):
        return ""
    return knob
