"""Token-timeline perf observatory: ITL/TPOT, goodput, and rooflines
(counterpart of `llm_mcp_tpu/telemetry/perf.py`).

TTFT histograms say how fast the *first* token arrives; the compile ledger
says what first uses cost; neither explains a steady-state regression.
This module is the third observability layer (tracing.py = per-request,
recorder.py = post-mortem, perf.py = *explanation*), with three coupled
parts:

1. **Token timelines** — the engine feeds every emission round's
   (wall gap, tokens learned) pair here, yielding per-token inter-token
   latency (ITL, a.k.a. TPOT) p50/p95/p99 over a rolling window, and a
   goodput accountant that classifies each finished request against the
   joint TTFT + ITL SLO (`TPU_TARGET_TTFT_MS` / `TPU_TARGET_ITL_MS`):
   `goodput_tok_per_s` counts only tokens from SLO-conforming requests.

2. **Phase attribution** — every Nth dispatch (`TPU_PERF_SAMPLE`, dynamic;
   0 disables) the engine reports {host staging, device compute, scheduler
   wait} walls of one round per dispatch phase. The compile ledger times
   only *first* dispatches; this is the steady-state complement. On the
   card the device wall comes from CUDA events recorded around the sampled
   dispatch and read at that round's own fetch, so sampling adds no host
   sync to the loop.

3. **Rooflines** — analytical FLOPs and HBM-byte cost models per cache
   layout (bf16/int8 × GQA/MLA, including the fused int8 layout's scale
   pseudo-head rows and the paged path's block-table gathers; the JAX
   package's, unchanged) turn the sampled decode device time into MFU/MBU
   gauges against the card's peaks. The peaks come from `TPU_PEAK_TFLOPS`
   / `TPU_PEAK_HBM_GBPS` when set, else from `CARD_PEAKS` for the card the
   engine runs on; on any other card, and on the CPU, the gauges read
   `None`: no peak is guessed. All four layouts are evaluated against the
   same measured token rate — the non-active rows are the what-if column;
   `active` marks the one the engine actually runs.

Like tracing.py and recorder.py this module is stdlib-only (no torch) and
never imports `executor` or `api` — the engine imports *us* and hands
plain scalars in, the card's name among them.

`DISPATCH_PHASES` below is the registry of record for the serve path's
steady-state dispatch phases: every phase string the engine feeds the
compile ledger is either listed here (and therefore has a recorder etype
and a cost model) or in `AUX_COMPILE_PHASES` (ledger-only paths with no
steady-state cadence to sample).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any

__all__ = [
    "AUX_COMPILE_PHASES",
    "CACHE_LAYOUTS",
    "CARD_PEAKS",
    "DISPATCH_PHASES",
    "ModelShape",
    "PerfObservatory",
    "WARMUP_PHASES",
    "card_peaks",
    "decode_flops_per_token",
    "decode_hbm_bytes_per_token",
    "kv_bytes_per_token",
    "layout_name",
    "phase_cost",
    "prefill_flops_per_token",
]

# Steady-state dispatch phases: every one has a CompileLedger phase string,
# a flight-recorder etype, and a cost model in PHASE_COSTS (lint-enforced).
DISPATCH_PHASES = (
    "admit", "chunk", "cnstep", "decode", "fused", "fused_rag", "pf_rag",
    "verify",
)
# Compile-ledger-only phases: rare, data-dependent dispatches (COW block
# copies, pool puts, preemption restore) with no steady-state cadence
# worth sampling — the ledger's first-dispatch wall is the story. The
# port adds "build": a kernel library's nvcc build (a miss) or its load
# of an already built library (a hit), keyed by the library's name.
AUX_COMPILE_PHASES = ("build", "cow", "pool_put", "pool_put_host", "restore")
# Warm-up-plannable subset of the dispatch surface (executor/warmup.py):
# phases whose argument shapes are a pure function of the engine's config,
# so a warm-up step can run one from a shape key alone, without live
# traffic. fused/fused_rag/verify depend on the live fill mix and
# speculation state — the planner lists their ledger-observed keys but
# marks them unplannable (their first use happens on a real dispatch).
WARMUP_PHASES = ("admit", "chunk", "decode", "pf_rag")

CACHE_LAYOUTS = ("gqa_bf16", "gqa_int8", "mla_bf16", "mla_int8")

DEFAULT_PERF_SAMPLE = 32
DEFAULT_TARGET_ITL_MS = 0.0  # no ITL SLO unless configured
# Peak rates by card, keyed by `torch.cuda.get_device_name()`: (dense bf16
# tensor-core TFLOPS, HBM GB/s), from the datasheet. NVIDIA H100 SXM5
# (80 GB HBM3) at its 700 W power limit: 989.4 TFLOPS bf16 dense, 3350
# GB/s. A card set below 700 W runs slower under load than these peaks.
CARD_PEAKS: dict[str, tuple[float, float]] = {
    "NVIDIA H100 80GB HBM3": (989.4, 3350.0),
}
_SCALE_BYTES = 4  # per-(head, token) quantization scale, f32


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def card_peaks(device_name: str) -> tuple[float | None, float | None]:
    """(peak TFLOPS, peak HBM GB/s) for the roofline: each knob
    (`TPU_PEAK_TFLOPS`, `TPU_PEAK_HBM_GBPS`) when set, else the card's
    `CARD_PEAKS` entry, else None — never a guessed peak."""
    table = CARD_PEAKS.get(device_name or "")
    # each knob read by its literal name, so the knob registry sees it
    knobs = (_env_float("TPU_PEAK_TFLOPS", 0.0), _env_float("TPU_PEAK_HBM_GBPS", 0.0))
    out = [v if v > 0 else (table[i] if table else None) for i, v in enumerate(knobs)]
    return out[0], out[1]


def layout_name(mla: bool, int8: bool) -> str:
    return ("mla" if mla else "gqa") + ("_int8" if int8 else "_bf16")


@dataclass(frozen=True)
class ModelShape:
    """The scalar facts the cost models need, decoupled from ModelConfig so
    this module never imports the models package (which pulls torch)."""

    dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    param_count: int
    # MLA latent dims; 0 when the model is plain GQA
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 0

    @classmethod
    def from_config(cls, cfg: Any) -> "ModelShape":
        """Duck-typed: accepts any object with ModelConfig's fields."""
        hd = getattr(cfg, "head_dim", 0) or cfg.dim // cfg.n_heads
        return cls(
            dim=cfg.dim,
            n_layers=cfg.n_layers,
            n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads,
            head_dim=hd,
            param_count=int(cfg.param_count()),
            kv_lora_rank=getattr(cfg, "kv_lora_rank", 0) or 0,
            qk_rope_head_dim=getattr(cfg, "qk_rope_head_dim", 0) or 0,
        )


# -- cost models -------------------------------------------------------------


def _fused_scale_bytes(n_kv_heads: int, head_dim: int) -> int:
    """Per-token bytes of the fused int8 layout's packed scales: one f32
    scale per (k|v, kv-head, token), packed into pseudo-head rows of
    head_dim int8 lanes riding in the payload tensor — storage rounds up
    to whole rows, so the cost is the padded row width, not the scalars."""
    raw = 2 * n_kv_heads * _SCALE_BYTES
    rows = -(-raw // max(1, head_dim))
    return rows * head_dim


def kv_bytes_per_token(shape: ModelShape, layout: str) -> float:
    """KV-cache bytes ONE token occupies across all layers under `layout`.
    GQA stores k+v per kv-head; MLA stores one shared latent row
    (kv_lora_rank + rope key dims). int8 layouts add per-token scales —
    for fused GQA int8, padded to pseudo-head row granularity."""
    L = shape.n_layers
    if layout.startswith("mla"):
        latent = shape.kv_lora_rank + shape.qk_rope_head_dim
        if layout.endswith("int8"):
            return float(L * (latent + _SCALE_BYTES))
        return float(L * latent * 2)  # bf16 latents
    per_tok = 2 * shape.n_kv_heads * shape.head_dim
    if layout.endswith("int8"):
        return float(
            L * (per_tok + _fused_scale_bytes(shape.n_kv_heads, shape.head_dim))
        )
    return float(L * per_tok * 2)  # bf16 k+v


def decode_flops_per_token(shape: ModelShape, layout: str, ctx: float) -> float:
    """FLOPs to decode one token at mean context `ctx`: 2 FLOPs per weight
    (every parameter does one MAC) plus attention. GQA attention is QK^T +
    PV over the context (2 matmuls × 2 FLOPs/MAC per head); MLA's absorbed
    decode form runs both against the latent cache, so the per-head width
    is (kv_lora_rank + rope) for scores and kv_lora_rank for values.
    Layout quantization changes bytes, not FLOPs."""
    weights = 2.0 * shape.param_count
    if layout.startswith("mla"):
        score_w = shape.kv_lora_rank + shape.qk_rope_head_dim
        attn = 2.0 * shape.n_layers * shape.n_heads * ctx * (
            score_w + shape.kv_lora_rank
        )
    else:
        attn = 4.0 * shape.n_layers * shape.n_heads * shape.head_dim * ctx
    return weights + attn


def decode_hbm_bytes_per_token(
    shape: ModelShape,
    layout: str,
    ctx: float,
    rows: float,
    *,
    paged: bool = False,
    block_tokens: int = 16,
    weight_bytes_per_param: float = 1.0,
) -> float:
    """HBM bytes moved per decoded token: the full weight stream amortized
    over the batch rows (one stream serves every row of a step), the KV
    read of the row's whole context, the one-token KV append, and — paged —
    the block-table index gathers (one i32 per block per layer, the
    indirection the kernels' scalar-prefetch path reads)."""
    rows = max(1.0, rows)
    weights = shape.param_count * weight_bytes_per_param / rows
    kv_tok = kv_bytes_per_token(shape, layout)
    kv_read = ctx * kv_tok
    kv_write = kv_tok
    table = 0.0
    if paged:
        table = shape.n_layers * 4.0 * (ctx / max(1, block_tokens))
    return weights + kv_read + kv_write + table


def prefill_flops_per_token(shape: ModelShape, layout: str, ctx: float) -> float:
    """Prefill costs the same weight FLOPs per token; causal attention over
    a prompt averages half the final context per token."""
    return decode_flops_per_token(shape, layout, ctx / 2.0)


def _prefill_cost(shape, layout, ctx, rows, paged, block_tokens):
    flops = prefill_flops_per_token(shape, layout, ctx)
    # prefill is compute-bound: weights stream once per chunk, KV is
    # written (not read back) for every token
    byts = (
        shape.param_count / max(1.0, rows * max(ctx, 1.0))
        + kv_bytes_per_token(shape, layout)
    )
    return flops, byts


def _decode_cost(shape, layout, ctx, rows, paged, block_tokens):
    return (
        decode_flops_per_token(shape, layout, ctx),
        decode_hbm_bytes_per_token(
            shape, layout, ctx, rows, paged=paged, block_tokens=block_tokens
        ),
    )


# Registry of record: one analytical (flops, bytes) model per steady-state
# dispatch phase. verify is decode-shaped (one fused step over the drafted
# tokens); the prefill family shares the chunk model.
PHASE_COSTS = {
    "admit": _prefill_cost,
    "chunk": _prefill_cost,
    "pf_rag": _prefill_cost,
    "cnstep": _decode_cost,  # one masked decode step: decode-shaped
    "decode": _decode_cost,
    "fused": _decode_cost,
    "fused_rag": _decode_cost,
    "verify": _decode_cost,
}


def phase_cost(
    phase: str,
    shape: ModelShape,
    layout: str,
    *,
    ctx: float,
    rows: float,
    paged: bool = False,
    block_tokens: int = 16,
) -> tuple[float, float]:
    """(flops_per_token, hbm_bytes_per_token) for one dispatch phase."""
    return PHASE_COSTS[phase](shape, layout, ctx, rows, paged, block_tokens)


def _pctl(vals: list[float], q: float) -> float:
    """Nearest-rank percentile (matches engine.ttft_percentiles)."""
    if not vals:
        return 0.0
    n = len(vals)
    return vals[max(0, min(n - 1, int(n * q + 0.5) - 1))]


class PerfObservatory:
    """Per-process-engine perf state: ITL window, goodput ledger, sampled
    phase attribution, and the roofline evaluation. All writers are the
    engine thread; readers (API/dashboard/bench) take the same small lock
    the writers do, so snapshots are internally consistent."""

    def __init__(
        self,
        shape: ModelShape | None = None,
        *,
        active_layout: str = "gqa_bf16",
        paged: bool = False,
        block_tokens: int = 16,
        weight_bytes_per_param: float = 1.0,
        target_ttft_ms: float | None = None,
        target_itl_ms: float | None = None,
        itl_window: int = 4096,
        device_name: str = "",
    ):
        self.shape = shape
        # the card the engine runs on ("" on the CPU): picks the peaks
        self.device_name = device_name
        self.active_layout = active_layout
        self.paged = paged
        self.block_tokens = max(1, int(block_tokens))
        self.weight_bytes_per_param = weight_bytes_per_param
        self.target_ttft_ms = (
            _env_float("TPU_TARGET_TTFT_MS", 0.0)
            if target_ttft_ms is None else target_ttft_ms
        )
        self.target_itl_ms = (
            _env_float("TPU_TARGET_ITL_MS", DEFAULT_TARGET_ITL_MS)
            if target_itl_ms is None else target_itl_ms
        )
        self._lock = threading.Lock()
        # rolling per-token ITL seconds (percentile window) + a fresh queue
        # the Prometheus bridge drains exactly once per sample
        self._itl = deque(maxlen=max(64, itl_window))
        self._itl_fresh = deque(maxlen=8192)
        self._itl_count = 0
        self._itl_sum_s = 0.0
        # goodput ledger: lifetime counters + a rolling (ts, tokens, good)
        # window for the live tok/s split
        self.finished_requests = 0
        self.good_requests = 0
        self.finished_tokens = 0
        self.good_tokens = 0
        self._finish_window = deque(maxlen=4096)
        # per-tenant goodput ledgers (model zoo tenancy): tenant id ->
        # the same lifetime counters + rolling window as the engine-wide
        # ledger, plus the tenant's shed (429) count. Empty until a
        # request actually carries a tenant id — the single-tenant path
        # allocates nothing here.
        self._tenants: dict[str, dict[str, Any]] = {}
        # sampled phase attribution {phase: {host_s, device_s, wait_s,
        # samples, tokens}} — tokens only for the decode family (the MFU/MBU
        # denominator); dispatch counters drive the every-Nth cadence
        self._phases = {
            p: {"host_s": 0.0, "device_s": 0.0, "wait_s": 0.0,
                "samples": 0, "tokens": 0}
            for p in DISPATCH_PHASES
        }
        self._dispatches = {p: 0 for p in DISPATCH_PHASES}
        # live decode-shape EMAs feeding the roofline (mean context, rows)
        self._ctx_ema = 0.0
        self._rows_ema = 0.0

    # -- sampling cadence --------------------------------------------------

    @property
    def sample_every(self) -> int:
        """Dynamic (like TPU_FLIGHT): flip TPU_PERF_SAMPLE on a live
        process. 0 disables sampling entirely."""
        return _env_int("TPU_PERF_SAMPLE", DEFAULT_PERF_SAMPLE)

    def should_sample(self, phase: str) -> bool:
        """True on every Nth dispatch of `phase`. The caller must skip
        first dispatches (those belong to the CompileLedger — a compile
        wall in the steady-state attribution would swamp it)."""
        n = self.sample_every
        c = self._dispatches.get(phase)
        if c is None:
            return False
        self._dispatches[phase] = c + 1
        return n > 0 and (c + 1) % n == 0

    # -- token timelines ---------------------------------------------------

    def observe_itl(self, gap_s: float, n_tokens: int) -> float:
        """One emission round for one request: `n_tokens` arrived
        `gap_s` after the request's previous emission (or its first
        token). Tokens learned in one fetch share the gap evenly — the
        engine only syncs once per round, so a finer split would be
        fiction. Returns the per-token ITL in seconds."""
        if n_tokens <= 0:
            return 0.0
        itl = max(0.0, gap_s) / n_tokens
        with self._lock:
            # cap the fan-out so one giant coalesced round can't flood the
            # percentile window with identical samples
            for _ in range(min(n_tokens, 64)):
                self._itl.append(itl)
                self._itl_fresh.append(itl)
            self._itl_count += n_tokens
            self._itl_sum_s += max(0.0, gap_s)
        return itl

    def itl_percentiles(self) -> dict[str, float]:
        with self._lock:
            vals = sorted(self._itl)
            n = self._itl_count
        return {
            "p50_ms": _pctl(vals, 0.50) * 1e3,
            "p95_ms": _pctl(vals, 0.95) * 1e3,
            "p99_ms": _pctl(vals, 0.99) * 1e3,
            "samples": float(n),
        }

    def drain_itl(self) -> list[float]:
        """ITL samples (seconds) since the last drain — the metrics bridge
        observes each into llmtpu_itl_seconds exactly once."""
        with self._lock:
            vals = list(self._itl_fresh)
            self._itl_fresh.clear()
        return vals

    # -- goodput accounting ------------------------------------------------

    def finish_request(
        self, ttft_ms: float, itl_mean_ms: float, tokens: int,
        tenant: str = "",
    ) -> bool:
        """Classify one finished request against the joint SLO. A target of
        0 means that axis is unconstrained (matching TTFTBurnDetector's
        no-SLO convention). Returns whether the request was good. A
        non-empty `tenant` also lands the request in that tenant's ledger
        (per-tenant goodput for the zoo scheduler and /v1/debug/perf)."""
        good = (
            (self.target_ttft_ms <= 0 or ttft_ms <= self.target_ttft_ms)
            and (self.target_itl_ms <= 0 or itl_mean_ms <= self.target_itl_ms)
        )
        with self._lock:
            self.finished_requests += 1
            self.finished_tokens += tokens
            if good:
                self.good_requests += 1
                self.good_tokens += tokens
            self._finish_window.append((time.time(), tokens, good))
            if tenant:
                t = self._tenant_locked(tenant)
                t["finished_requests"] += 1
                t["finished_tokens"] += tokens
                if good:
                    t["good_requests"] += 1
                    t["good_tokens"] += tokens
                t["window"].append((time.time(), tokens, good))
        return good

    def _tenant_locked(self, tenant: str) -> dict[str, Any]:
        """Ledger for `tenant`, created on first touch. Caller holds the
        lock."""
        t = self._tenants.get(tenant)
        if t is None:
            t = {
                "finished_requests": 0, "good_requests": 0,
                "finished_tokens": 0, "good_tokens": 0, "shed": 0,
                "window": deque(maxlen=1024),
            }
            self._tenants[tenant] = t
        return t

    def note_tenant_shed(self, tenant: str, n: int = 1) -> None:
        """A per-tenant admission 429: quota or capacity shed charged to
        `tenant`'s ledger (surfaced in /v1/debug/perf and the
        llmtpu_tenant_shed_total metric)."""
        if not tenant:
            return
        with self._lock:
            self._tenant_locked(tenant)["shed"] += int(n)

    def tenant_goodput(self, window_s: float = 60.0) -> dict[str, dict[str, float]]:
        """Per-tenant goodput split, same shape as `goodput()` per entry
        plus the tenant's shed count. Empty dict when no request ever
        carried a tenant id."""
        now = time.time()
        out: dict[str, dict[str, float]] = {}
        with self._lock:
            for name, t in self._tenants.items():
                rows = [r for r in t["window"] if now - r[0] <= window_s]
                ftok, gtok = t["finished_tokens"], t["good_tokens"]
                out[name] = {
                    "goodput_tok_per_s": sum(
                        tok for _, tok, g in rows if g
                    ) / window_s,
                    "raw_finished_tok_per_s": sum(
                        tok for _, tok, _ in rows
                    ) / window_s,
                    "good_requests": float(t["good_requests"]),
                    "finished_requests": float(t["finished_requests"]),
                    "good_tokens": float(gtok),
                    "finished_tokens": float(ftok),
                    "goodput_ratio": (gtok / ftok) if ftok else 1.0,
                    "shed": float(t["shed"]),
                }
        return out

    def tenant_goodput_ratios(self) -> dict[str, float]:
        """Lifetime goodput_ratio per tenant — the SLO-debt signal the
        engine's preemption victim selection reads every preempt
        decision (cheap: no window scan)."""
        with self._lock:
            return {
                name: (t["good_tokens"] / t["finished_tokens"])
                if t["finished_tokens"] else 1.0
                for name, t in self._tenants.items()
            }

    def goodput(self, window_s: float = 60.0) -> dict[str, float]:
        now = time.time()
        with self._lock:
            rows = [r for r in self._finish_window if now - r[0] <= window_s]
            fin, good_r = self.finished_requests, self.good_requests
            ftok, gtok = self.finished_tokens, self.good_tokens
        raw = sum(t for _, t, _ in rows) / window_s
        good = sum(t for _, t, g in rows if g) / window_s
        return {
            "goodput_tok_per_s": good,
            "raw_finished_tok_per_s": raw,
            "good_requests": float(good_r),
            "finished_requests": float(fin),
            "good_tokens": float(gtok),
            "finished_tokens": float(ftok),
            "goodput_ratio": (gtok / ftok) if ftok else 1.0,
            "target_ttft_ms": self.target_ttft_ms,
            "target_itl_ms": self.target_itl_ms,
        }

    # -- sampled phase attribution ----------------------------------------

    def observe_phase(
        self,
        phase: str,
        host_s: float,
        device_s: float,
        wait_s: float = 0.0,
        *,
        tokens: int = 0,
        rows: int = 0,
        ctx_mean: float = 0.0,
    ) -> None:
        rec = self._phases.get(phase)
        if rec is None:
            return
        with self._lock:
            rec["host_s"] += max(0.0, host_s)
            rec["device_s"] += max(0.0, device_s)
            rec["wait_s"] += max(0.0, wait_s)
            rec["samples"] += 1
            rec["tokens"] += max(0, tokens)
            if rows > 0:
                self._rows_ema = (
                    rows if self._rows_ema == 0.0
                    else 0.8 * self._rows_ema + 0.2 * rows
                )
            if ctx_mean > 0:
                self._ctx_ema = (
                    ctx_mean if self._ctx_ema == 0.0
                    else 0.8 * self._ctx_ema + 0.2 * ctx_mean
                )

    def phase_attribution(self) -> dict[str, dict[str, float]]:
        with self._lock:
            return {
                p: {
                    "host_s": round(r["host_s"], 6),
                    "device_s": round(r["device_s"], 6),
                    "wait_s": round(r["wait_s"], 6),
                    "samples": float(r["samples"]),
                    "tokens": float(r["tokens"]),
                }
                for p, r in self._phases.items()
            }

    # -- roofline ----------------------------------------------------------

    def _decode_device_tok_per_s(self) -> float:
        """Sampled decode-family token rate while the device was actually
        computing — the roofline's measured input."""
        with self._lock:
            dev = sum(
                self._phases[p]["device_s"]
                for p in ("decode", "fused", "fused_rag")
            )
            tok = sum(
                self._phases[p]["tokens"]
                for p in ("decode", "fused", "fused_rag")
            )
        return tok / dev if dev > 0 else 0.0

    def roofline(self) -> dict[str, Any]:
        """MFU/MBU for every cache layout at the live decode shape. The
        measured token rate comes from the sampled device walls; the four
        layouts share it so the non-active rows read as what-ifs. A peak
        that is not known (no knob, a card without a `CARD_PEAKS` entry,
        the CPU) leaves its utilization gauges None."""
        tflops, gbps = card_peaks(self.device_name)
        peak_flops = tflops * 1e12 if tflops else None
        peak_bw = gbps * 1e9 if gbps else None
        tok_s = self._decode_device_tok_per_s()
        ctx = self._ctx_ema or 1.0
        rows = self._rows_ema or 1.0
        out: dict[str, Any] = {
            "peak_tflops": tflops,
            "peak_hbm_gbps": gbps,
            "device_tok_per_s": round(tok_s, 1),
            "ctx_mean": round(ctx, 1),
            "rows_mean": round(rows, 2),
            "active_layout": self.active_layout,
            "layouts": {},
        }
        if self.shape is None:
            return out
        for layout in CACHE_LAYOUTS:
            wb = (
                self.weight_bytes_per_param
                if layout == self.active_layout else
                (1.0 if layout.endswith("int8") else 2.0)
            )
            flops, byts = (
                decode_flops_per_token(self.shape, layout, ctx),
                decode_hbm_bytes_per_token(
                    self.shape, layout, ctx, rows,
                    paged=self.paged, block_tokens=self.block_tokens,
                    weight_bytes_per_param=wb,
                ),
            )
            out["layouts"][layout] = {
                "flops_per_token": flops,
                "hbm_bytes_per_token": byts,
                "arith_intensity": flops / byts if byts else 0.0,
                "mfu": (flops * tok_s / peak_flops) if peak_flops else None,
                "mbu": (byts * tok_s / peak_bw) if peak_bw else None,
                "active": layout == self.active_layout,
            }
        act = out["layouts"][self.active_layout]
        out["decode_mfu"] = None if act["mfu"] is None else round(act["mfu"], 4)
        out["decode_mbu"] = None if act["mbu"] is None else round(act["mbu"], 4)
        return out

    # -- the /v1/debug/perf document --------------------------------------

    def stats(self) -> dict[str, Any]:
        return {
            "sample_every": float(self.sample_every),
            "itl": self.itl_percentiles(),
            "itl_mean_ms": (
                self._itl_sum_s / self._itl_count * 1e3
                if self._itl_count else 0.0
            ),
            "goodput": self.goodput(),
            "tenants": self.tenant_goodput(),
            "phases": self.phase_attribution(),
            "roofline": self.roofline(),
        }
