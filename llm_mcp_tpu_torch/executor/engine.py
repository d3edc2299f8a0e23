"""Continuous-batching generation engine (counterpart of
`llm_mcp_tpu/executor/engine.py:GenerationEngine`, local backend).

One engine thread owns the model, the KV cache and every slot. Its loop
is the JAX engine's pipelined one (`_run` there). Each iteration:

  1. stages a ragged prefill group under the token-budget scheduler
     (`scheduler.py`): up to `admit_batch` mid-prefill prompts' next
     chunks packed back to back into one [T] token buffer (windowed and
     softcapped families, which no ragged kernel covers, stage a bucketed
     [Ab, bucket] group for `llama_prefill_chunk_batch` instead, as the JAX
     engine gates them);
  2. dispatches decode round N (`decode_chunk` steps) for the active slots
     and, fused behind it on the same stream, the staged group
     (`llama_prefill_chunk_ragged`), then activates the prompts whose last
     chunk landed, sampling their first token; with no active slot the
     group runs alone;
  3. emits round N-1's tokens and finishes slots (EOS, `max_tokens`, end
     of the sequence, stop strings);
  4. admits queued requests: prompts of at most `prefill_chunk` tokens
     prefill together (`llama_prefill`, batches of up to `admit_batch`),
     longer ones reserve a slot and join the chunk queue;
  5. fetches the oldest round once `pipeline_depth` rounds are in flight
     (or nothing is active): the round's one host sync. A quick scan of
     its tokens frees the slots that finished, so the next dispatch leaves
     them out; their events go out at the next emission.

A round never waits for its predecessor on the host. Its input tokens come
from the device-resident token ring (`_d_last`, written back by every
round and by every activation), its sampling parameters from `_d_temp`,
`_d_topk` and `_d_topp`, and its lengths and slot ids from one packed i32
upload. Host lengths advance at dispatch. A slot freed while rounds are in
flight cools (`_cooling`) until every round dispatched before the free has
been fetched. On the card the round is one CUDA graph a static shape
(`graphs.py`, `cuda_graphs=True`) and uploads are pinned and non-blocking,
so the host runs up to `pipeline_depth` rounds ahead of the card.

Decode rows and prefill rows are disjoint: a slot is decodable only once
its whole prompt is in the cache. Free and mid-prefill slots are parked at
`lengths = max_seq_len`, so the decode step's append writes nothing into
them. The packing rules are the JAX engine's (rowids sorted, pads carry
rowid R and position S, T on the pow2 ladder), so the two engines dispatch
the same work.

Prompt-prefix cache and paged KV, as in the JAX engine
(`prompt_cache_mb`, default 256): every slot owns a block table in the
ledger (`paging.py`). At activation a prompt that shares at least
`PREFIX_MIN` tokens with a recent prompt stores that prefix (length
floored to a power of two). With physical paging (`physical.py`; block
size in {32, 64, 128, 256} dividing `max_seq_len`) the entry's blocks are
copied once into a device pool, and a later prompt that starts with it is
admitted by pinning those blocks into its table: no row copies, except
the boundary block of an unaligned entry, copied on write. Its suffix
prefills through ragged chunks and its decode steps read the shared blocks
from the pool through the paged kernels, chosen on the host whenever a
row of the step has a non-identity table. Without physical paging an
entry is a copy of the slot's rows, copied into every hit slot.

int8, as the JAX engine (`quant`, `kv_quant`, `decode_compact`): with
`quant="int8"` the weights are int8 (`models/quant.py`; made directly in
int8 when none are passed, quantized when bf16 ones are) in the fused
single-device layout (`wqkv`, `w13`), stored K-contiguous for the int8
GEMM (`gemm_layout`); with `kv_quant="int8"` the KV cache
is the fused int8 layout (`k = {"q", "s"}`, `v = {}`), and every path
that moves cache rows (admission, prefix entries, pool copies, copy on
write, recovery) moves the payload with all its heads and the plain
scales together. Slot compaction (`decode_compact`, on by default with the
int8 cache): a decode round runs only a pow2 bucket of the active rows
(floor 8), each reading its cache row through `slot_ids`.

MLA models (DeepSeek-V2-Lite, `models/mla.py`) keep a latent cache in the
same (k, v) pair: k = latents [L, B, 1, S, R], v = rope keys
[L, B, 1, S, dr], and at int8 each its own {"q", "s"} dict, not fused.
Every path above maps over those leaves unchanged; the int8 latents are
read by the MLA decode kernel through `slot_ids` when compacted.

KV memory, as the JAX engine (`memory.py`): with `TPU_KV_HOST_OFFLOAD`
on, a `KVPool` is built at construction (off: none, a true no-op).
`admission_state()` compares the offered load (the ledger's unique blocks,
in slot-equivalents) with `TPU_ADMIT_WATERMARK × max_slots` and gives the
API its 429 and Retry-After. When the queue's head outranks the lowest
priority live stream (or has waited past twice the TTFT target) and no
slot is free, the loop drains the pipeline (every round fetched and
emitted, so the host lengths are exact), copies a victim's committed rows
and its round state to pinned host memory (`TPU_PREEMPT_POLICY` picks the
victim), parks its shared prefix pins in the ledger and frees the slot.
Snapshots are restored ahead of admission, into the same cache storage
(`copy_` into views: the captured round graphs hold the buffers'
addresses). A victim admitted off a prefix hit snapshots only its private
rows when its shared length is block-aligned.

Self-speculative decoding, as the JAX engine (`TPU_SPEC`, default on):
each slot keeps an n-gram drafter over its own history (`drafter.py`).
When a majority of the dispatchable slots have a draft and every row has
room for `TPU_SPEC_K` + 1 positions, the loop fetches and emits every
round in flight, then runs one verify round (`verify_round`): one chunk
pass over [last token, drafts] per slot (`llama_prefill_chunk_batch` with
every position's logits), accept/reject on the device (`spec_verify`), and
the round's final tokens written into the token ring. Rejected positions
roll back by arithmetic: their rows are overwritten before anything reads
them. A round that accepts under a quarter of its drafts pauses
speculation for 50 iterations. The verify round runs eagerly, outside the
round graphs; `TPU_SPEC=0` builds no verify function and leaves every
round as it was.

Grammar-constrained decoding, as the JAX engine (`constrain/`,
`TPU_CONSTRAIN`, default on): a request's `constraint` (json_schema,
json_object, regex, choice) and `logit_bias` compile to a per-slot
automaton cursor whose packed token masks are applied before every sample
of that slot (`apply_token_mask`): the first token's at activation, then
one masked eager decode step per loop iteration (`_cn_step_round`), or a
masked verify round when its drafts, filtered to the automaton's legal
prefix, compose. Constrained slots never ride the pipelined rounds: the
mask of token t + 1 exists only once the host automaton has consumed token
t. `TPU_CONSTRAIN=0` builds no compiler and no mask path.

The core server's reporting surface, as the JAX engine's: total tokens
and requests, `ttft_percentiles` (nearest rank over 600 s),
`current_tps` (10 s), `phase_budget` (the loop's host wall clock by
phase), `scheduler_stats`, and the stall watchdog (`stalled`,
`stall_seconds`, `TPU_STALL_TIMEOUT_S`); all read host stamps, nothing
synchronizes with the card. A request that carries the caller's trace
context gets the `engine.admit`, `engine.prefill` and `engine.decode`
spans, recorded from those stamps.

The observability plane, as the JAX engine's (`telemetry/recorder.py`,
`perf.py`, `workload.py`): flight events at every dispatch, admission,
preemption, restore and paging op; the compile ledger, fed by every first
use of a shape (`_note_exec_shape`: a round graph's capture, an eager
phase's first call, a kernel library's build or load); the anomaly
detectors; ITL per emission and goodput per finished request; every Nth
dispatch's host/device/wait split (`TPU_PERF_SAMPLE`; the device wall from
CUDA events read at the round's own fetch, no added sync); the latency
waterfall and the workload capture; and a torch.profiler capture armed
from `/v1/debug/profile`. The warm-up (`start_warmup`, `executor/warmup.py`)
runs the shape zoo's first uses before traffic, on the engine thread.

Tenancy, as the JAX engine: a request's `tenant` (`generate_stream(...,
tenant=)`) bills prompt plus generated tokens to its token bucket at
finish (`TPU_TENANT_QUOTAS`), `admission_state(tenant)` sheds a tenant
over its quota, its finished requests land in its goodput ledger, and a
preemption prefers the slot whose tenant has the most goodput surplus over
the worst-served tenant (SLO debt). The empty tenant touches none of it.
The model zoo (`executor/zoo.py`) builds engines around parked host trees
(`params` is put on the engine's device; a tree left elsewhere raises) and
carries `warmup_priors()` from one residency to the next. The int8 decode
kernel counts its splits in this engine's own arrival buffer, and the
kernel launches of the engine thread also count in `kernel_launches`.

KV migration, as the JAX engine (`migration.py`, `TPU_MIGRATE`, off by
default: off builds no queue, and every hook is guarded by `is not None`):
a request flagged `migrate_after_prefill` (or every request, on an engine a
coordinator gave the prefill role) is exported where it activates, once its
first token is emitted: its committed rows and round state are copied to
pinned host memory, the continuation state and the constraint state (spec,
bias and consumed ids) go into the header, the slot is freed without a
terminal event and the payload goes to the outbox. The slot is in no round
in flight then: a round carries only the slots active at its dispatch, and
the slot activated after every round in flight was dispatched (those read
it parked). `migrate_import` decodes a payload (pinned on the card) and
queues it; the loop restores migrated-in snapshots ahead of everything
else, through `_restore_snapshot`, re-pinning a shared prefix it holds
itself (`admit_shared`) and else folding the fallback rows in. The drain
hooks (`migrate_export_one`, `migrate_steal_queued`) hand over offloaded
snapshots and queued requests.

The fleet prefix tier, as the JAX engine (`routing/prefix.py`):
`prefix_chains` and `prefix_digest` read a mirror of the resident entries
behind its own lock; `prefix_export` (the longest chain prefixing the ids,
or a pow2 cut of a partial one) and `prefix_import` (rejected, never
raised, on a bad payload or another geometry) run on the engine thread,
parked there by the calling thread. An imported chain becomes an ordinary
entry: pool rows on the physical path, device rows on the contiguous one.

The dispatch plane, as the JAX engine's (`dispatch.py`): every device
mutation of the scheduling loop goes through one funnel, `_dx(op, *args)`,
over the registry `_build_ops` builds (JAX's 19 op names, closures over
`self` that take host payloads only: numpy arrays, CPU tensors, ints,
strings). With the default `LocalArraysBackend` the funnel is a direct
call. With `GSPMDBackend` and a `mesh` (`parallel/mesh.py`) of tp ranks,
rank 0 leads: it emits every step to the other ranks, which replay it
(`run_follower`) on their own shards: the weights sliced by JAX's
Megatron specs (unfused, quantized first; `parallel/sharding.py`), the
cache, the pool and the device round state at H/tp and Hkv/tp heads (the
int8 cache per rank in its own fused layout), with the model's
collectives inside the ops. Block tables stay host policy on the leader
and ride the payload; ops the leader reads back (`snap`, `pfxexp`,
`poolexp`) gather heads to it, and ops that take host rows (`insrows`,
`insat`, `pfximp`, `pput`) slice each rank's heads from the payload. A
failed step kills the engine under a mesh (`dead`: the followers replayed
it, nothing can be rebuilt in step). Under a mesh of more than one rank
the rounds run eagerly (collectives through `gloo` cannot be captured),
compaction stays off (as JAX's auto rule) and the warm-up is off (it runs
model steps outside the step program); dp, pp, sp and ep above 1, and MLA
or MoE configurations under tp, are refused (ROADMAP.md queue 1 item 11).
`SliceEngine` is the keyword surface of JAX's multi-host engine.

Not ported yet (ROADMAP queue 1): capture of the ragged group and of the
verify and masked rounds.
"""

from __future__ import annotations

import base64
import dataclasses
import functools
import logging
import os
import queue
import tempfile
import threading
import time
import uuid
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Iterator

import numpy as np
import torch

from ..kernels import attention as K
from ..kernels import build as kbuild
from ..models.configs import ModelConfig, resolve_config
from .. import constrain
from ..models.llama import (
    init_kv_cache,
    init_llama_params,
    llama_decode_step,
    llama_prefill,
    llama_prefill_chunk_batch,
    llama_prefill_chunk_ragged,
    plain_attention,
)
from ..models.weights import has_safetensors, load_llama_checkpoint
from ..routing import prefix as prefix_fp
from ..routing.prefix import chain_hashes
from ..telemetry import perf, tracing, workload
from ..telemetry import recorder as flight
from ..models.quant import (
    fuse_layer_weights,
    gemm_layout,
    init_llama_params_quantized,
    quantize_params,
)
from ..ops.sampling import apply_token_mask, sample_tokens, spec_verify
from ..utils.device import resolve_device
from ..utils.locks import OrderedLock
from ..parallel.mesh import tp_scope
from ..parallel.sharding import (
    fused_heads_full,
    fused_heads_local,
    shard_tree_for,
    supports_ragged_prefill,
)
from .common import fine_bucket, pow2_bucket
from .dispatch import DispatchBackend, GSPMDBackend, LocalArraysBackend
from .drafter import NGramDrafter
from .graphs import RoundGraphs, device_sync
from . import migration
from .memory import RESTORE_AGING_TTFT_MULT, KVPool, KVSnapshot, pytree_nbytes
from .paging import PagedKVManager
from .physical import PhysicalPool, pool_like
from .scheduler import TokenBudgetScheduler, parse_tenant_quotas
from .tokenizer import Tokenizer, load_tokenizer
from . import warmup as warmup_mod

log = logging.getLogger("executor")

_DONE = object()  # end-of-stream sentinel on a request's queue


def _map(fn, *trees):
    """fn over the leaves of KV trees of one structure: a tensor, or the
    fused int8 cache's dict ({"q", "s"}, or {} for its V side)."""
    if isinstance(trees[0], dict):
        return {k: fn(*(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(*trees) -> list[torch.Tensor]:
    out: list[torch.Tensor] = []
    for t in trees:
        out.extend(t.values() if isinstance(t, dict) else [t])
    return out


def _nbytes(*trees) -> int:
    return sum(x.numel() * x.element_size() for x in _leaves(*trees))


def _tree_to(tree: Any, device: torch.device) -> Any:
    """Every tensor leaf of a nested dict/list tree on `device`. `Tensor.to`
    keeps the strides of a dense tensor (gemm_layout's K-contiguous int8
    payloads stay K-contiguous) and returns a leaf already there as is."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device, non_blocking=True)
    return tree


def _check_on_device(tree: Any, device: torch.device) -> None:
    """Raise unless every tensor leaf lies on `device`: a tree left on the
    host never serves from a CUDA engine."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            _check_on_device(v, device)
    elif isinstance(tree, torch.Tensor) and (
            tree.device.type != device.type
            or (device.index is not None and tree.device.index != device.index)):
        raise ValueError(f"a parameter lies on {tree.device}, the engine on {device}")


def _check_kernel_shapes(cfg: ModelConfig) -> None:
    """Refuse, on the card, a configuration that some kernel of its path has
    no arm for (the engine never falls back to the plain versions there):
    GQA families need head_dim 128 or 64 (flash, ragged and decode kernels),
    or 256 where only the flash kernel runs (the windowed and softcapped
    families: Gemma-2), and G = n_heads / n_kv_heads of at most 8 for the
    decode kernels. MLA configs are the MLA kernels' own to check."""
    if cfg.kv_lora_rank:
        return
    hd, G = cfg.resolved_head_dim, cfg.n_heads // cfg.n_kv_heads
    flash_only = plain_attention(cfg)
    if hd in (64, 128) or (hd == 256 and flash_only):
        if flash_only or 1 <= G <= 8:
            return
    raise ValueError(
        f"{cfg.name}: head_dim {hd}, {cfg.n_heads} query heads over {cfg.n_kv_heads} KV heads "
        "has no arm in the CUDA kernels (head_dim 64 or 128, or 256 for windowed or softcapped "
        "families, and at most 8 query heads a KV head); the head_dim-32 arms of the tiny "
        "test configs run on the CPU through the plain versions. Serve it on the CPU "
        "(device=\"cpu\")"
    )


def decode_round(
    cfg: ModelConfig,
    params: dict,
    cache_k: Any,  # updated in place
    cache_v: Any,
    state: tuple,  # device-resident (last [B] i32, temp [B] f32, topk [B] i32, topp [B] f32)
    packed: torch.Tensor,  # i32: [lengths | slot_ids | counter] (compact), [lengths | counter]
    *,
    steps: int,
    compact: bool,
    paged: dict | None = None,
    banned: torch.Tensor | None = None,  # [V] bool: ids never sampled
    generator: torch.Generator | None = None,
    cn: tuple | None = None,  # (masks [Ba, W], bias ids, bias values): a masked step
    arrivals: torch.Tensor | None = None,  # the engine's int8 decode arrival buffer
) -> torch.Tensor:
    """One decode round, the JAX engine's `decode_body`: `steps` decode
    steps and their samples, then the round's last tokens written back
    into the token ring `state[0]`. Compacted, row i serves cache row
    slot_ids[i] and gathers its token and sampling parameters by that id;
    else every slot is a row. Reads nothing on the host, so it runs as one
    CUDA graph. The counter (the round id; JAX derives the round's random
    key from it) is not read: the generator carries the stream. Returns
    the sampled tokens [steps, Ba]. With `cn` (the constrained slots'
    single masked step, JAX's `cn_step_fn`) each row's automaton mask and
    logit_bias apply before sampling."""
    last, temp, topk, topp = state
    S = (cache_k["q"] if isinstance(cache_k, dict) else cache_k).shape[3]
    if compact:
        Ba = (packed.shape[0] - 1) // 2
        slot_ids = packed[Ba: 2 * Ba]
        idx = slot_ids.long()
        toks, temp, topk, topp = last[idx], temp[idx], topk[idx], topp[idx]
    else:
        Ba = packed.shape[0] - 1
        slot_ids = None
        toks = last
    lens = packed[:Ba]
    outs = []
    for _ in range(steps):
        logits, cache_k, cache_v = llama_decode_step(
            cfg, params, cache_k, cache_v, toks, lens, slot_ids=slot_ids, paged=paged,
            arrivals=arrivals,
        )
        if banned is not None:
            logits = logits.masked_fill(banned, float("-inf"))
        if cn is not None:
            logits = apply_token_mask(logits, *cn)
        # parked rows (lens >= S) carry stale parameters: they take no part
        # in the choice of the sampling regime
        toks = sample_tokens(logits, generator, temp, topk, topp, active=lens < S)
        outs.append(toks)
        lens = torch.where(lens < S, lens + 1, lens)
    if compact and cn is not None:
        # the masked step's pad rows may aim at a live unconstrained row
        # whose next round reads the ring: they write back what it holds
        last[idx] = torch.where(packed[:Ba] < S, toks, last[idx])
    elif compact:
        # pad rows all aim at one inactive row: the last write wins, on a
        # row that admission overwrites before it is read
        last[idx] = toks
    else:
        last.copy_(toks)
    return torch.stack(outs)


def verify_round(
    cfg: ModelConfig,
    params: dict,
    cache_k: Any,  # updated in place
    cache_v: Any,
    state: tuple,  # the device-resident round state, as `decode_round`'s
    packed: torch.Tensor,  # i32: see `_spec_round`
    *,
    rows: int,  # A, the round's rows (pads included)
    n: int,  # live rows, the first n
    width: int,  # C = K + 1 positions a row
    n_writes: int,
    skey: int,
    paged: dict | None = None,
    banned: torch.Tensor | None = None,
    cn: tuple | None = None,  # (masks [A, C, W], bias ids [A, NB], bias values [A, NB])
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One speculative verify round, JAX's `verify_fn`: a chunk pass over
    [last token, drafts] for each row (`llama_prefill_chunk_batch` with
    every position's logits), the constraint masks applied before
    accept/reject (so the residual resample sees the masked target), then
    `spec_verify` and the final tokens written into the token ring. Column
    0 of the tokens is read from the ring on the device. Pad rows carry
    slot B and write nothing. Returns (n_acc [A], final [A]) int32."""
    last, temp, topk, topp = state
    A, C = rows, width
    B = last.shape[0]
    K = C - 1
    views, off = [], 0
    for size in (A * C, A, A, A, A * K, A, n_writes, n_writes, n_writes):
        views.append(packed[off: off + size])
        off += size
    tokens, slots, starts, nvalid, drafts, ndraft, keep, wslot, wpos = views
    tokens = tokens.reshape(A, C).clone()
    idx = slots.long().clamp(max=B - 1)
    tokens[:, 0] = last[idx]
    logits, _, _ = llama_prefill_chunk_batch(
        cfg, params, cache_k, cache_v, tokens, slots, starts, nvalid, skey=skey,
        all_logits=True, paged=paged, writes=(keep, wslot, wpos),
    )  # [A, C, V]
    if banned is not None:
        logits = logits.masked_fill(banned, float("-inf"))
    if cn is not None:
        logits = apply_token_mask(logits, *cn)
    n_acc, final = spec_verify(
        logits, drafts.reshape(A, K), ndraft, generator, temp[idx], topk[idx], topp[idx],
        active=slots < B, exact=cn is not None,
    )
    last[idx[:n]] = final[:n]
    return n_acc, final


@dataclass
class GenRequest:
    prompt_ids: list[int]
    max_tokens: int = 256
    temperature: float = 0.7
    top_k: int = 0
    top_p: float = 1.0
    stop: list[str] = field(default_factory=list)
    request_id: str = field(default_factory=lambda: uuid.uuid4().hex)
    out: "queue.Queue[Any]" = field(default_factory=queue.Queue)
    created_at: float = field(default_factory=time.time)
    priority: int = 0  # preemption: a higher one may take a lower one's slot
    # constrained decoding: the spec ({"type": "json_schema" | "json_object"
    # | "regex" | "choice", ...}) and the [token id, bias] pairs; None and
    # None: the request never touches the constraint path
    constraint: dict | None = None
    logit_bias: list | None = None
    cn: Any = None  # the compiled cursor, attached when admission pops the request
    # the caller's W3C trace context ("" untraced) and the wall time the
    # loop popped the request: the engine.admit / engine.prefill /
    # engine.decode spans are recorded from them, retroactively
    trace_ctx: str = ""
    admitted_at: float = 0.0
    # admission-shed backoff the API spent before this submit landed (the
    # latency waterfall's "shed" stage)
    shed_wait_s: float = 0.0
    # the tenant this request bills against; "" is unmetered: quotas,
    # per-tenant goodput and SLO-debt preemption all key off a non-empty id
    tenant: str = ""
    # KV migration (TPU_MIGRATE on): export this request where its prefill
    # lands, for a decode-role peer to continue (the disaggregated handoff)
    migrate_after_prefill: bool = False
    # times this request was re-homed: the coordinator moves a request once
    migrations: int = 0


@dataclass
class _Slot:
    req: GenRequest
    generated: int = 0
    text: str = ""
    pending: bytes = b""
    prompt_len: int = 0
    first_token_at: float = 0.0
    done: bool = False
    # KV pool: the last emission's wall time (the "idle" policy's signal;
    # stamped only with the pool on)
    last_emit: float = 0.0
    # admitted off a prefix hit: the entry and its length; a preemption
    # snapshots only the rows past shared_len when it is block-aligned
    shared_entry: Any = None
    shared_len: int = 0
    preempted_s: float = 0.0  # wall spent parked off-slot
    spec: Any = None  # the n-gram drafter (None with TPU_SPEC=0)
    cn: Any = None  # the automaton cursor (None when unconstrained)
    spec_drafted: int = 0
    spec_accepted: int = 0
    # token timeline (perf observatory) and latency waterfall: the last
    # emission's wall, the emission gaps and their tokens, the stall part
    # of those gaps, and the synchronous prefill walls attributed here
    perf_last_emit: float = 0.0
    itl_s_total: float = 0.0
    itl_samples: int = 0
    stall_s: float = 0.0
    prefill_compute_s: float = 0.0


@dataclass
class _PrefillState:
    """A slot whose prompt is mid-way through chunked prefill."""

    req: GenRequest
    ids: list[int]
    done: int = 0  # tokens already written into the cache
    shared_len: int = 0  # prefix-cache hit: tokens of the entry it starts with
    shared_entry: Any = None  # and the entry, carried onto the live slot
    prefill_s: float = 0.0  # synchronous chunk walls attributed (waterfall)


@dataclass
class _PrefillGroup:
    """A staged chunk group: metas row i ↔ descriptor row i. Ragged: the
    packed [T] buffer and its descriptors. Bucketed (`bucket` > 0): tokens
    [Ab, bucket], one row a slot (pad rows carry slot B and write
    nothing), `nvalid` [Ab] and the past-key bound `skey`; rowids,
    positions and last_idx are None."""

    metas: list  # [(slot, _PrefillState, n)]
    tokens: np.ndarray  # [T], or [Ab, bucket]
    rowids: np.ndarray | None  # [T] (pads = R)
    positions: np.ndarray | None  # [T] (pads = max_seq_len)
    slots: np.ndarray  # [R] / [Ab]
    starts: np.ndarray  # [R] / [Ab]
    last_idx: np.ndarray | None  # [R]
    n_tokens: int
    # the cache writes, as the host packed them: packed index, slot and
    # position of every real token
    keep: np.ndarray  # [n_tokens]
    wslot: np.ndarray
    wpos: np.ndarray
    # its last-token logits [R, V] park in the engine's `_x_logits[gid]`
    # once launched, until the boundary sample ("bsample") takes them
    gid: int = 0
    launched: bool = False
    nvalid: np.ndarray | None = None  # bucketed: [Ab]
    bucket: int = 0
    skey: int = 0

    @property
    def padded(self) -> int:
        """The tokens the dispatch computes, pads included."""
        return int(self.tokens.size)


@dataclass
class _DispatchedRound:
    """A decode round in flight: its tokens arrive in `out` (pinned on the
    card) through a copy queued behind it, and `done` is recorded after
    that copy (None on the CPU, where the round ran in the call)."""

    out: torch.Tensor  # [K, Ba] int32, host
    done: Any  # torch.cuda.Event | None
    entries: list  # [(slot, _Slot, column of out)]
    base: np.ndarray  # host lengths before the round
    t0: float
    rid: int
    prefill_tokens: int = 0  # the fused group's tokens (0: none rode along)
    prefill_padded: int = 0
    # a sampled round (perf observatory): (phase, start event, end event,
    # host_s, wait_s, tokens, rows, ctx_mean); the events (None on the CPU,
    # where host_s holds the compute) are read at the round's fetch
    perf: tuple | None = None


@dataclass
class _PendingRound:
    """A fetched round whose tokens are still to be emitted."""

    out: np.ndarray  # [K, Ba]
    entries: list
    base: np.ndarray


class GenerationEngine:
    def __init__(
        self,
        model: str | ModelConfig = "tiny-llm",
        *,
        params: dict | None = None,
        tokenizer: Tokenizer | None = None,
        weights_dir: str = "",
        max_slots: int = 8,
        max_seq_len: int = 512,
        dtype: torch.dtype = torch.bfloat16,
        seed: int = 0,
        decode_chunk: int = 4,
        prefill_chunk: int = 512,
        admit_batch: int = 4,
        target_ttft_ms: float = 2000.0,
        prompt_cache_mb: int = 256,
        quant: str = "",
        kv_quant: str = "",
        decode_compact: str = "auto",
        cuda_graphs: bool = True,
        device: str | torch.device | None = None,
        mesh: Any = None,
        backend: DispatchBackend | None = None,
    ):
        # a mesh (`parallel/mesh.py`) places this rank; its device is the
        # engine's unless the caller names one
        if device is None:
            device = mesh.device if mesh is not None else "cuda"
        self.device = resolve_device(device)
        # a config.json beside the weights describes them and wins over the
        # catalog, as in the JAX engine
        self.cfg = resolve_config(model, weights_dir)
        if self.cfg.arch == "encoder":
            raise ValueError(f"{self.cfg.name} is an encoder: it serves embeddings "
                             "(EmbeddingEngine), not generation")
        if self.device.type == "cuda":
            _check_kernel_shapes(self.cfg)
        # The dispatch plane (module docstring, `dispatch.py`): every device
        # mutation goes through `_dx`, which hands the (op, payload) step to
        # the backend before it runs the op here. A dead engine (`dead`, a
        # failed step under a mesh) rejects submits and releases the
        # followers.
        self.mesh = mesh
        self._backend = backend if backend is not None else LocalArraysBackend()
        self._spmd = bool(self._backend.spmd)
        if self._spmd and mesh is None:
            raise ValueError("a GSPMD dispatch backend requires a mesh")
        self.dead: str = ""
        self._dead_lock = threading.Lock()  # atomizes submit vs death
        self._tp = self._check_mesh(mesh)
        # the model's config on this rank: its local head counts under tp
        self._mcfg = self.cfg if self._tp is None else dataclasses.replace(
            self.cfg, n_heads=self.cfg.n_heads // self._tp.tp,
            n_kv_heads=self.cfg.n_kv_heads // self._tp.tp,
            head_dim=self.cfg.resolved_head_dim)
        self.dtype = dtype
        # the JAX engine's options and warnings: int8 weights, int8 KV, and
        # slot compaction (auto = on with the int8 cache, on one device)
        self.quant = quant
        if self.quant and self.quant != "int8":
            log.warning("unknown quant mode %r (supported: int8); serving unquantized", quant)
            self.quant = ""
        self.kv_quant = kv_quant
        if self.kv_quant and self.kv_quant != "int8":
            log.warning("unknown kv_quant mode %r (supported: int8); using %s cache",
                        kv_quant, dtype)
            self.kv_quant = ""
        dc = (decode_compact or "auto").lower()
        if dc not in ("auto", "on", "off"):
            log.warning("unknown decode_compact mode %r (auto|on|off); using auto", dc)
            dc = "auto"
        # auto stays single-device, as the JAX engine's rule
        single = mesh is None or mesh.size == 1
        self.decode_compact = dc == "on" or (dc == "auto" and self.kv_quant == "int8" and single)
        self.max_slots = max_slots
        self.max_seq_len = max_seq_len
        self.decode_chunk = decode_chunk
        self.prefill_chunk = max(0, prefill_chunk)
        self.admit_batch = max(1, admit_batch)
        self.tokenizer: Tokenizer = tokenizer or load_tokenizer(weights_dir)
        self.target_ttft_ms = float(target_ttft_ms)
        self._sched = TokenBudgetScheduler(
            target_ttft_ms=target_ttft_ms,
            min_budget=min(64, self.prefill_chunk) if self.prefill_chunk else 1,
            tenant_quotas=parse_tenant_quotas(os.environ.get("TPU_TENANT_QUOTAS", "")),
        )
        # packed-buffer capacity: the pow2 floor of a full group's tokens
        cap = max(self.admit_batch * self.prefill_chunk, 1)
        self._ragged_cap = 1 << (cap.bit_length() - 1)
        # ragged chunks, as the JAX engine gates them: not for windows or
        # softcaps, which no ragged kernel covers (those stage bucketed
        # groups), nor under a mesh with dp, sp or ep
        self.ragged_prefill = not plain_attention(self.cfg) and supports_ragged_prefill(mesh)

        self.load_seconds = 0.0  # reading and placing a checkpoint
        if params is None and has_safetensors(weights_dir):
            t0 = time.perf_counter()
            params = load_llama_checkpoint(self.cfg, weights_dir, dtype=dtype,
                                           device=self.device)
            self.load_seconds = time.perf_counter() - t0
        elif params is None:
            g = torch.Generator(device=self.device).manual_seed(seed)
            init = init_llama_params_quantized if self.quant else init_llama_params
            params = init(self.cfg, g, dtype, device=self.device)
        # a tree handed in elsewhere (the model zoo parks its weights in host
        # memory) comes to this engine's device, its strides kept
        params = _tree_to(params, self.device)
        if self.quant:
            params = quantize_params(params)  # a no-op on an int8 tree
        if self._tp is not None:
            # quantized first, then this rank's slice (a row-split int8
            # weight keeps the whole tree's scales); unfused, as JAX under a
            # mesh: the fused wqkv/w13 columns interleave head groups
            params = shard_tree_for(self.cfg, params, self._tp)
        elif self.quant:
            # the single-device fused layout (a no-op on a tree that has it)
            params = fuse_layer_weights(params)
        if self.quant:
            params = gemm_layout(params)  # K-contiguous for the int8 GEMM
        _check_on_device(params, self.device)
        self.params = params
        cache = init_kv_cache(self._mcfg, max_slots, max_seq_len, dtype=dtype, device=self.device,
                              quantized=self.kv_quant == "int8")
        self._ck, self._cv = cache["k"], cache["v"]
        # the whole cache's geometry (no storage): byte accounting, wire
        # checks and host rows use the full heads, on every rank alike
        full = init_kv_cache(self.cfg, max_slots, max_seq_len, dtype=dtype, device="meta",
                             quantized=self.kv_quant == "int8")
        self._full_ck, self._full_cv = full["k"], full["v"]
        # op-owned device state (JAX's): parked group logits by gid, device
        # prefix entries by eid
        self._x_logits: dict[int, torch.Tensor] = {}
        self._x_prefix: dict[int, tuple] = {}
        self._gid_ctr = 0
        self._eid_ctr = 0
        self._init_prefix_cache(prompt_cache_mb)
        # the int8 decode kernel's split arrivals: this engine's own buffer,
        # so two engines' launches on two streams never count into one word
        # (a round graph bakes its address, the engine's for its lifetime)
        self._q8_arrivals = (K.q8_arrivals_buffer(self.device)
                             if self.device.type == "cuda" and self.kv_quant == "int8" else None)
        # kernel launches made on this engine's loop thread (chip checks
        # read them per engine; `K.LAUNCHES` is the process's)
        self.kernel_launches: dict[str, int] = {}

        # The KV pool (memory.py), as the JAX engine builds it: only with
        # TPU_KV_HOST_OFFLOAD on; every use is guarded by `is not None`, so
        # off is a true no-op.
        self._pool: KVPool | None = None
        if os.environ.get("TPU_KV_HOST_OFFLOAD", "0") not in ("", "0", "false", "no", "off"):
            self._pool = KVPool(
                max_slots=max_slots,
                max_seq_len=max_seq_len,
                bytes_per_slot=_nbytes(self._full_ck, self._full_cv) // max(1, max_slots),
                watermark=float(os.environ.get("TPU_ADMIT_WATERMARK", "") or 1.5),
                policy=os.environ.get("TPU_PREEMPT_POLICY", "") or "priority",
            )
            log.info("KV pool enabled: %.1f MB/slot, watermark %.2f, policy %s",
                     self._pool.bytes_per_slot / (1 << 20), self._pool.watermark,
                     self._pool.policy)
        self._snap_ctr = 0  # snapshot ids: the ledger's key for parked pins
        # finished requests and their tokens price the 429's Retry-After;
        # API threads read them
        self.stats_lock = OrderedLock("engine.stats", rank=10)
        self.finished_requests = 0
        self.finished_tokens = 0
        self.total_errors = 0
        # the reporting surface the core server reads, as the JAX engine's:
        # emitted tokens (the engine thread is the only writer), admitted
        # requests, client-observed TTFT samples (ts, ms), (ts, tokens) of
        # the loop's iterations for tps, and the loop's wall clock by phase.
        # All host stamps: nothing here synchronizes with the card.
        self.total_tokens = 0
        self.total_requests = 0
        self._ttft_window: deque[tuple[float, float]] = deque(maxlen=1024)
        # bounded: the JAX engine's list grows until something reads tps
        self._window: deque[tuple[float, int]] = deque(maxlen=4096)
        self._phase_s: dict[str, float] = {
            k: 0.0 for k in ("dispatch", "fetch", "admit", "prefill", "emit", "idle")
        }
        self._last_active_n = 0  # decode rows in the most recent dispatch
        # Stall watchdog, as the JAX engine's: the loop stamps progress each
        # iteration; with work in flight and the stamp older than
        # TPU_STALL_TIMEOUT_S (default 600 s) the engine is `stalled`, its
        # queued requests are errored and the core server marks the device
        # offline. A round shape's first graph capture opens a grace window
        # of one timeout (`_note_exec_shape`), and a kernel build counts as
        # progress (`stall_seconds`), so a cold server does not offline
        # itself.
        self.last_progress = time.time()
        self.stall_timeout_s = float(os.environ.get("TPU_STALL_TIMEOUT_S", "600") or 0)
        self.stalled = False
        self._seen_exec_shapes: set[tuple] = set()
        self._compile_grace_until = 0.0

        # Host mirror of the slots' lengths, advanced at dispatch. Only active
        # (decoding) slots hold an in-range length; free and mid-prefill
        # slots park at max_seq_len so the decode step's append writes
        # nothing there.
        self._lengths = np.full(max_slots, max_seq_len, dtype=np.int32)
        # Device-resident round state (JAX's `_d_last_tok`, `_d_temp`,
        # `_d_topk`, `_d_topp`): a round gathers its input tokens and
        # sampling parameters here and writes its last tokens back;
        # activations write a slot's first token and parameters. Nothing
        # reads them on the host: after a failed step every request is
        # errored, so no host copy is kept for recovery.
        self._d_last = torch.zeros(max_slots, dtype=torch.int32, device=self.device)
        self._d_temp = torch.zeros(max_slots, dtype=torch.float32, device=self.device)
        self._d_topk = torch.zeros(max_slots, dtype=torch.int32, device=self.device)
        self._d_topp = torch.ones(max_slots, dtype=torch.float32, device=self.device)
        self._slots: list[_Slot | None] = [None] * max_slots
        self._prefills: dict[int, _PrefillState] = {}
        self._prefill_q: deque[int] = deque()
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.compact_rounds = 0  # decode rounds that ran compacted

        # Rounds in flight before the oldest is fetched: TPU_PIPELINE_DEPTH,
        # else 2 on the card and 1 on the CPU, as the JAX engine. A finished
        # slot rides up to depth - 1 more rounds before the host sees it.
        depth = os.environ.get("TPU_PIPELINE_DEPTH", "")
        self.pipeline_depth = max(1, int(depth)) if depth else (
            2 if self.device.type == "cuda" else 1)
        # round ids: the fence that keeps a freed slot unused while a round
        # dispatched before the free may still write its rows and ring entry
        self._rid_dispatched = 0
        self._rid_fetched = 0
        self._cooling: dict[int, int] = {}
        self._inflight: deque[_DispatchedRound] = deque()
        self._pending: _PendingRound | None = None
        # the decode round as one CUDA graph a static shape; the CPU has none,
        # and neither has a round whose collectives go through gloo
        self.cuda_graphs = bool(cuda_graphs) and self.device.type == "cuda" and self._tp is None
        if self._tp is not None:
            log.info("rank %d of tp=%d on %s, collectives on %s: decode rounds run eagerly "
                     "(a round with gloo collectives cannot be captured), warm-up off",
                     self._tp.rank, self._tp.tp, self.device, self._tp.backend)
        self._graphs = RoundGraphs(self.device, self._gen) if self.cuda_graphs else None

        # Only real text ids and eos may be sampled: the model vocab may be
        # larger than the tokenizer's, and pad/bos are control ids.
        allowed = np.ones(self.cfg.vocab_size, dtype=bool)
        allowed[self.tokenizer.vocab_size:] = False
        for bad in (self.tokenizer.pad_id, self.tokenizer.bos_id):
            if bad != self.tokenizer.eos_id and 0 <= bad < self.cfg.vocab_size:
                allowed[bad] = False
        self._banned = None if allowed.all() else torch.from_numpy(~allowed).to(self.device)

        # Self-speculative decoding (module docstring), gated as the JAX
        # engine: TPU_SPEC=0 (or TPU_SPEC_K=0) builds no verify function
        self.spec_k = max(0, int(os.environ.get("TPU_SPEC_K", "") or 7))
        self.spec_min_ngram = max(1, int(os.environ.get("TPU_SPEC_MIN_NGRAM", "") or 2))
        self.spec_max_ngram = max(self.spec_min_ngram, 3)
        self.spec_enabled = os.environ.get("TPU_SPEC", "1") != "0" and self.spec_k > 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_emitted = 0
        self.spec_calls = 0
        # a round that accepts under a quarter of its drafts pauses
        # speculation: a verify round emits 1 + accepted tokens a slot, a
        # decode round K
        self._spec_cooldown = 0
        self._verify_fn = self._build_verify() if self.spec_enabled else None

        # Constrained decoding: TPU_CONSTRAIN=0 builds no compiler, so no
        # request carries a cursor and no mask path exists
        self.constrain_enabled = constrain.constrain_enabled()
        self.cn_bias_max = max(1, int(os.environ.get("LLM_MCP_TPU_CN_BIAS_MAX", "") or 64))
        self._constrain = (
            constrain.ConstraintCompiler(
                self.tokenizer, self.cfg.vocab_size,
                cache_size=int(os.environ.get("TPU_CONSTRAIN_CACHE", "") or 64),
            ) if self.constrain_enabled else None
        )
        self.cn_requests = 0
        self.cn_tokens = 0
        self.cn_illegal = 0  # automaton-illegal emissions: stays 0
        self.cn_finished = 0
        self.cn_finished_accepting = 0
        self.cn_spec_drafted = 0
        self.cn_spec_accepted = 0
        self.cn_mask_s = 0.0  # host wall building the mask rows
        self._cn_step_fn = None  # the masked single step, built on first use
        # a constrained round's token-ring writes (slots, tokens), taken by
        # that round's verify or masked step op; None outside `_cn_round`
        self._cn_ring: tuple | None = None

        # KV migration (migration.py), as the JAX engine: TPU_MIGRATE off
        # (the default) builds no queue, so every hook is a no-op. The
        # outbox carries wire payloads a MigrationCoordinator ships; the
        # inbox carries decoded snapshots the loop restores into free slots.
        self._migrate_outbox: "queue.Queue[dict] | None" = None
        self._migrate_in: "queue.Queue[tuple] | None" = None
        # the prefill role: a coordinator sets it, and every admitted
        # request exports once its prefill lands (a request's own flag also)
        self.migrate_after_prefill = False
        self.migrated_out_total = 0
        self.migrated_in_total = 0
        self.migrate_out_bytes_total = 0
        self.migrate_in_bytes_total = 0
        if os.environ.get("TPU_MIGRATE", "0") not in ("", "0", "false", "no", "off"):
            self._migrate_outbox = queue.Queue()
            self._migrate_in = queue.Queue()
            log.info("KV migration enabled (TPU_MIGRATE)")

        self._admit: "queue.Queue[GenRequest]" = queue.Queue()
        self._wake = threading.Event()
        self._stop_evt = threading.Event()
        self._thread: threading.Thread | None = None
        self._init_telemetry()
        self._ops = self._build_ops()

    def _check_mesh(self, mesh) -> Any:
        """The mesh's tp view (None for one rank), after the refusals of
        this slice: dp, pp, sp and ep above 1, MLA or MoE configurations
        under tp, head or vocabulary counts tp does not divide, and a mesh
        of more than one rank without the leader/follower backend (every
        rank is a process here)."""
        if mesh is None or mesh.size == 1:
            return None
        item = "not ported yet (ROADMAP.md queue 1 item 11)"
        for ax in ("dp", "pp", "sp", "ep"):
            if mesh.shape.get(ax, 1) > 1:
                raise ValueError(f"mesh axis {ax}={mesh.shape[ax]}: {item}")
        tp = mesh.shape["tp"]
        cfg = self.cfg
        if cfg.kv_lora_rank or cfg.n_experts:
            raise ValueError(f"{cfg.name}: MLA and MoE under tp={tp} are {item}")
        for what, n in (("n_heads", cfg.n_heads), ("n_kv_heads", cfg.n_kv_heads),
                        ("vocab_size", cfg.vocab_size)):
            if n % tp:
                raise ValueError(f"{cfg.name}: {what} {n} is not divisible by tp={tp}")
        if not self._spmd:
            raise ValueError("a mesh of more than one rank needs the leader/follower backend "
                             "(GSPMDBackend): every rank is a process")
        return mesh

    def _init_telemetry(self) -> None:
        """The observability plane, as the JAX engine builds it: the
        process-shared flight recorder, compile ledger and workload ring,
        and this engine's anomaly monitor, perf observatory and latency
        waterfall (all stdlib modules: the engine hands them scalars)."""
        self._flight = flight.get_recorder()
        self._ledger = flight.get_compile_ledger()
        self._anomaly = flight.AnomalyMonitor(self._flight, target_ttft_ms=self.target_ttft_ms)
        self._perf = perf.PerfObservatory(
            shape=perf.ModelShape.from_config(self.cfg),
            active_layout=perf.layout_name(bool(self.cfg.kv_lora_rank), self.kv_quant == "int8"),
            paged=self._phys is not None,
            block_tokens=self._paging.block_tokens,
            weight_bytes_per_param=1.0 if self.quant == "int8" else self.dtype.itemsize,
            target_ttft_ms=self.target_ttft_ms,
            device_name=(torch.cuda.get_device_name(self.device)
                         if self.device.type == "cuda" else ""),
        )
        self._workload = workload.get_workload()
        self._waterfall = workload.LatencyWaterfall()
        # the previous round's end: a sampled round's "wait" bucket
        self._perf_mark = time.perf_counter()
        self.watchdog_transitions: dict[str, int] = {}
        self._last_round_ts = time.time()  # the decode-stall detector's signal
        # provenance of the compile ledger's entries: "warmup" while a
        # warm-up step runs, else "serve"
        self._compile_src = "serve"
        # on-demand torch.profiler capture (/v1/debug/profile): other threads
        # only arm it; the engine thread starts and stops it at loop
        # boundaries (`_profile_tick`)
        self._profile_pending: tuple[int, str] | None = None
        self._profile_left = 0
        self._profile_dir = ""
        self._profiler = None
        psteps = int(os.environ.get("TPU_FLIGHT_PROFILE_STEPS", "0") or 0)
        self._dump_cb = None
        if psteps > 0:
            self._dump_cb = lambda info, n=psteps: self.start_profile(n)
            self._flight.add_dump_callback(self._dump_cb)
        # the paged ledger's tap: pin / cow / unpin / snap ops become events
        self._paging.on_ops = self._paging_event
        # the warm-up planner (start_warmup), and calls handed to the engine
        # thread: (fn, done event, [exception])
        self._warmup: warmup_mod.WarmupPlanner | None = None
        self._loop_calls: deque[tuple] = deque()
        # this engine's own first uses, (phase, key) -> count and seconds:
        # the warm-up priors it hands on (`warmup_priors`); the ledger is
        # the process's
        self._own_compiles: dict[tuple[str, str], dict[str, Any]] = {}
        self._own_compiles_lock = threading.Lock()

    # -- the dispatch plane (dispatch.py) ----------------------------------

    def _dx(self, op: str, *args):
        """The dispatch funnel: every device mutation the scheduling loop
        makes goes through here. The backend sees the (op, payload) step
        first (followers replay the same closure from the same payload),
        then the op runs here, in this rank's tp scope. Payloads are host
        values; device state lives on `self`, read and written by the op
        closures alone. A step that raises under a mesh kills the engine:
        the frame went out already, so the followers ran (or wedged on) the
        same op, and no local recovery puts every rank back in step."""
        try:
            self._backend.emit(op, args)
            if self._tp is None:
                return self._ops[op](*args)
            with tp_scope(self._tp):
                return self._ops[op](*args)
        except Exception as e:
            if self._spmd:
                self._mark_dead(f"dispatch {op!r} failed: {e}")
            raise

    def run_follower(self) -> None:
        """The replay loop of a rank that does not lead (blocking): every
        received (op, payload) step runs the same op closure the leader
        ran, on this rank's shards and in its tp scope. Returns on the
        leader's stop; raises when the leader is presumed dead."""
        K.bind_engine_tally(self.kernel_launches)
        with torch.inference_mode(), tp_scope(self._tp):
            self._backend.run_follower(self._ops)

    def _mark_dead(self, msg: str) -> None:
        """A poisoned dispatch under a mesh: the step went out to the
        followers and device state cannot be rebuilt in step, so the engine
        goes dead (submits reject, the loop exits and errors every request,
        the followers get the stop frame from the loop's tail)."""
        with self._dead_lock:
            if not self.dead:
                self.dead = msg or "dispatch failed"
                log.error("engine dead: %s", self.dead)
        self._stop_evt.set()
        self._wake.set()

    def _paged_payload(self, slots) -> np.ndarray | None:
        """The paged operand's host part riding a payload: the block table
        (host policy the followers do not keep) when any of `slots` reads a
        block through the pool, else None (the unpaged kernels run)."""
        if self._phys is None or not self._phys.paged(slots):
            return None
        return self._phys.table

    def _table_dev(self, tbl: np.ndarray | None) -> torch.Tensor | None:
        """A payload's table on the device: the cached upload on one rank
        (one upload a mutation), the payload's own under a mesh."""
        if tbl is None:
            return None
        return self._up(tbl) if self._spmd else self._phys.device_table(self.device)

    def _paged_from(self, tbl: np.ndarray | None) -> dict | None:
        dev = self._table_dev(tbl)
        return None if dev is None else {"tbl": dev, "k": self._pool_k, "v": self._pool_v}

    def _host_rows(self, side: Any) -> Any:
        """One cache side's device rows [L, 1, H, T, ...] on the host with
        every head: gathered over tp under a mesh (every rank gets them;
        the leader reads them), pinned and queued on the card."""
        if self._tp is not None:
            side = fused_heads_full(side, self._tp)
        return _map(self._to_host, side) if not (isinstance(side, dict) and not side) else {}

    def _local_rows(self, side: Any) -> Any:
        """Host rows with every head to this rank's heads (a no-op on one
        rank)."""
        if self._tp is None:
            return side
        return fused_heads_local(side, self.cfg.n_kv_heads, self._tp)

    def _ring_write(self, ring: tuple | None) -> None:
        """Token-ring entries from the host (slots, tokens): a constrained
        round's rows, which a compacted round's pad rows may have aimed at."""
        if ring is not None:
            self._d_last[self._up(np.asarray(ring[0], dtype=np.int64))] = self._up(
                np.asarray(ring[1], dtype=np.int32))

    def _build_ops(self) -> dict:
        """The step program's vocabulary: op name -> closure holding all
        the device work of that step. The closures take host payloads,
        read and write device state through `self`, and are the only code
        that touches the caches, the pool, the parked logits, the prefix
        entries and the round state after construction (the warm-up's
        parked steps and the one-rank recovery aside); the dispatch-surface
        pass reconciles this registry with `dispatch.DISPATCH_OPS` and the
        engine's `_dx` sites, both ways."""
        ops: dict[str, Any] = {}

        def op_admit(tokens, lengths, ints, flts, cn=None):
            # prefill, the rows into their slots, the first tokens sampled
            # and written into the round state at their slots
            logits, ks, vs = llama_prefill(
                self._mcfg, self.params, self._up(tokens), self._up(lengths),
                quant_kv=self.kv_quant == "int8")
            bucket = tokens.shape[1]
            n = len(ints) // 2
            for i, slot in enumerate(ints[:n].tolist()):
                _map(lambda c, k: c[:, slot, :, :bucket].copy_(k[:, i]), self._ck, ks)
                _map(lambda c, v: c[:, slot, :, :bucket].copy_(v[:, i]), self._cv, vs)
            return self._sample_rows(logits[:n], ints, flts, cn)

        ops["admit"] = op_admit

        def op_insert(eid, slots, live_n):
            pk, pv = self._x_prefix[eid]
            for slot in slots:
                _map(lambda c, e: c[:, slot, :, :live_n].copy_(e[:, 0, :, :live_n]), self._ck, pk)
                _map(lambda c, e: c[:, slot, :, :live_n].copy_(e[:, 0, :, :live_n]), self._cv, pv)

        ops["insert"] = op_insert

        def op_insrows(hk, hv, slots, live_n):
            # host rows [0, live_n) of every head ride the payload (restore,
            # migrate-in: a follower never saw this KV)
            for c, rows in ((self._ck, self._local_rows(hk)), (self._cv, self._local_rows(hv))):
                for i, b in enumerate(slots):
                    _map(lambda x, r: x[:, b: b + 1, :, :live_n].copy_(
                        r[:, i: i + 1, :, :live_n], non_blocking=True), c, rows)

        ops["insrows"] = op_insrows

        def op_insat(hk, hv, slot, start):
            for c, rows in ((self._ck, self._local_rows(hk)), (self._cv, self._local_rows(hv))):
                _map(lambda x, r: x[:, slot: slot + 1, :, start: start + r.shape[3]].copy_(
                    r, non_blocking=True), c, rows)

        ops["insat"] = op_insat

        def op_chunk(gid, tokens, slots, starts, nvalid, keep, wslot, wpos, skey, tbl):
            t, sl, st, nv, kp, ws, wp = self._upload_parts((
                tokens.reshape(-1), slots, starts, nvalid, keep, wslot, wpos))
            logits, self._ck, self._cv = llama_prefill_chunk_batch(
                self._mcfg, self.params, self._ck, self._cv, t.reshape(tokens.shape), sl, st, nv,
                skey=skey, paged=self._paged_from(tbl), writes=(kp, ws, wp))
            self._x_logits[gid] = logits

        ops["chunk"] = op_chunk

        def op_ragged(gid, tokens, rowids, positions, slots, starts, last_idx, keep, wslot,
                      wpos, tbl):
            t, ri, po, sl, st, li, kp, ws, wp = self._upload_parts((
                tokens, rowids, positions, slots, starts, last_idx, keep, wslot, wpos))
            logits, self._ck, self._cv = llama_prefill_chunk_ragged(
                self._mcfg, self.params, self._ck, self._cv, t, ri, po, sl, st, li,
                paged=self._paged_from(tbl), writes=(kp, ws, wp))
            self._x_logits[gid] = logits

        ops["ragged"] = op_ragged

        def op_bsample(gid, rows, ints, flts, cn=None):
            # the activation sample off a parked group's last-token logits,
            # with the finishing slots' round-state writes; the logits are
            # released either way
            logits = self._x_logits.pop(gid, None)
            if logits is None or len(rows) == 0:
                return None
            return self._sample_rows(logits[list(rows)], ints, flts, cn)

        ops["bsample"] = op_bsample

        def op_decode(key, packed, tbl):
            # one round at (Ba, compact, paged): the graph of the key on the
            # card (captured on its first use), else eager
            fn = functools.partial(self._round_fn, compact=key[1])
            args = (self._up(packed), self._table_dev(tbl))
            return fn(*args) if self._graphs is None else self._graphs.run(key, fn, args)

        ops["decode"] = op_decode

        def op_verify(packed, rows, n, width, n_writes, skey, tbl, cn=None, ring=None):
            self._ring_write(ring)
            return self._verify_fn(
                self._up(packed), rows=rows, n=n, width=width, n_writes=n_writes, skey=skey,
                paged=self._paged_from(tbl), cn=self._cn_dev(cn))

        ops["verify"] = op_verify

        def op_cnstep(packed, cn, tbl, ring=None):
            # the masked single step is built on its first use, leader and
            # follower alike: TPU_CONSTRAIN traffic alone builds it
            self._ring_write(ring)
            if self._cn_step_fn is None:
                self._cn_step_fn = self._build_cn_step()
            return self._cn_step_fn(self._up(packed), self._paged_from(tbl), self._cn_dev(cn))

        ops["cnstep"] = op_cnstep

        def op_samprow(b, temp, topk, topp, last):
            # one slot's round state (a restore)
            self._d_last[b] = last
            self._d_temp[b] = temp
            self._d_topk[b] = topk
            self._d_topp[b] = topp

        ops["samprow"] = op_samprow

        def op_snap(b, Lb, start, srcs):
            # host copies of slot b's rows [start, Lb) with every head; the
            # physical table's indirection rides the payload as (in_arena,
            # row, off) triples, so every rank cuts the same sources
            bt = self._paging.block_tokens

            def cut(arr, pool):
                if isinstance(arr, dict):
                    return {k: cut(arr[k], None if pool is None else pool[k]) for k in arr}
                if srcs is None:
                    return arr[:, b: b + 1, :, start:Lb]
                parts = [arr[:, row: row + 1, :, off: off + bt] if in_arena
                         else pool[:, row: row + 1] for in_arena, row, off in srcs]
                return torch.cat(parts, dim=3)[:, :, :, start:Lb]

            return (self._host_rows(cut(self._ck, self._pool_k)),
                    self._host_rows(cut(self._cv, self._pool_v)))

        ops["snap"] = op_snap

        def op_pfxput(eid, slot, p0):
            # a slot's rows [0, p0) as a device prefix entry
            self._x_prefix[eid] = (
                _map(lambda c: c[:, slot: slot + 1, :, :p0].clone(), self._ck),
                _map(lambda c: c[:, slot: slot + 1, :, :p0].clone(), self._cv))

        ops["pfxput"] = op_pfxput

        def op_pfxdrop(eid):
            self._x_prefix.pop(eid, None)

        ops["pfxdrop"] = op_pfxdrop

        def op_pfximp(eid, hk, hv):
            # wire-decoded host rows (every head) become a device entry of
            # this rank's heads
            self._x_prefix[eid] = (
                _map(lambda c, h: h.to(self.device, c.dtype), self._ck, self._local_rows(hk)),
                _map(lambda c, h: h.to(self.device, c.dtype), self._cv, self._local_rows(hv)))

        ops["pfximp"] = op_pfximp

        def op_pfxexp(eid, p0):
            pk, pv = self._x_prefix[eid]
            return (self._host_rows(_map(lambda x: x[:, :, :, :p0], pk)),
                    self._host_rows(_map(lambda x: x[:, :, :, :p0], pv)))

        ops["pfxexp"] = op_pfxexp

        def op_poolexp(prows, p0):
            # a physical entry's pool rows as one contiguous [L, 1, H, p0,
            # ...] host tree a side
            def cut(pool):
                return torch.cat([pool[:, r: r + 1] for r in prows], dim=3)[:, :, :, :p0]

            return (self._host_rows(_map(cut, self._pool_k)),
                    self._host_rows(_map(cut, self._pool_v)))

        ops["poolexp"] = op_poolexp

        def op_cow(slot, blk, prow):
            # pool row `prow` into block `blk` of the slot's arena row
            bt = self._paging.block_tokens
            for c, p in ((self._ck, self._pool_k), (self._cv, self._pool_v)):
                _map(lambda a, q: a[:, slot, :, blk * bt: (blk + 1) * bt].copy_(q[:, prow]), c, p)

        ops["cow"] = op_cow

        def op_pput(kind, a, b, prow):
            # prefix-pool row stores: "arena" copies a slot block (a = row,
            # b = token offset), "pool" a pool row (a = source row), "host"
            # uploads a wire-decoded block (a, b = its K and V host rows,
            # every head; the tail past its length zeroed)
            bt = self._paging.block_tokens
            if kind == "arena":
                for c, p in ((self._ck, self._pool_k), (self._cv, self._pool_v)):
                    _map(lambda x, q: q[:, prow].copy_(x[:, a, :, b: b + bt]), c, p)
            elif kind == "pool":
                for q in _leaves(self._pool_k, self._pool_v):
                    q[:, prow] = q[:, a]
            else:
                def put(pool, h) -> None:
                    seg = h[:, 0]
                    n = seg.shape[2]
                    pool[:, prow, :, :n].copy_(seg, non_blocking=True)
                    if n < bt:
                        pool[:, prow, :, n:].zero_()

                for p, h in ((self._pool_k, self._local_rows(a)), (self._pool_v, self._local_rows(b))):
                    _map(put, p, h)

        ops["pput"] = op_pput

        return ops

    # -- public surface ----------------------------------------------------

    def start(self) -> "GenerationEngine":
        if self._thread is None:
            # the leader's channel first (a blocking accept of every
            # follower): the loop never emits into a half-built channel
            self._backend.start()
            self._thread = threading.Thread(target=self._run, name="gen-engine", daemon=True)
            self._thread.start()
            if self.stall_timeout_s > 0:
                threading.Thread(target=self._watchdog, name="engine-watchdog",
                                 daemon=True).start()
        return self

    def shutdown(self) -> None:
        """Stop the loop, error every request still held (queued, live or
        offloaded), and free the round graphs and their memory pool; the
        caches and weights go with the engine object."""
        self._stop_evt.set()
        self._wake.set()
        if self._warmup is not None:
            self._warmup.stop()  # the steps left record skip
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=30)
        # release the followers (the loop's tail sent stop already) and drop
        # the command channel
        self._backend.stop()
        self._backend.close()
        self._abort_all("engine shutdown")
        while self._migrate_in is not None and not self._migrate_in.empty():
            # migrated-in snapshots never restored: their consumers wait on
            # queues this engine now owns
            try:
                s = self._migrate_in.get_nowait()[3]
            except queue.Empty:
                break
            self._error(s.req, "engine shutdown")
        if self._graphs is not None and (thread is None or not thread.is_alive()):
            self._graphs.release()  # no replay can be running any more
        if self._dump_cb is not None:
            self._flight.remove_dump_callback(self._dump_cb)  # the recorder outlives us

    def submit(self, req: GenRequest) -> GenRequest:
        with self._dead_lock:
            if self._stop_evt.is_set() or self.dead:
                msg = f"engine dead: {self.dead}" if self.dead else "engine shutdown"
                req.out.put({"type": "error", "error": msg})
                req.out.put(_DONE)
                return req
            self._admit.put(req)
        self._wake.set()
        return req

    def generate_stream(
        self,
        prompt: str,
        *,
        max_tokens: int = 256,
        temperature: float = 0.7,
        top_k: int = 0,
        top_p: float = 1.0,
        stop: list[str] | None = None,
        priority: int = 0,
        tenant: str = "",
        constraint: dict | None = None,
        logit_bias: list | None = None,
    ) -> Iterator[dict[str, Any]]:
        """Yield {"type":"token","text":...} events then a final
        {"type":"done", "usage":..., "finish_reason":..., "ttft_ms":...}.
        `tenant`, `constraint` and `logit_bias` as in `GenRequest`."""
        req = GenRequest(
            prompt_ids=self.tokenizer.encode(prompt),
            max_tokens=max_tokens,
            temperature=temperature,
            top_k=top_k,
            top_p=top_p,
            stop=stop or [],
            priority=int(priority),
            tenant=tenant,
            constraint=constraint,
            logit_bias=logit_bias,
            trace_ctx=tracing.current_traceparent(),
        )
        self.submit(req)
        while True:
            evt = req.out.get()
            if evt is _DONE:
                return
            yield evt
            if evt.get("type") == "done":
                return

    def generate(self, prompt: str, **kw: Any) -> dict[str, Any]:
        """Non-streaming: returns {"text", "usage", "finish_reason"}."""
        parts: list[str] = []
        final: dict[str, Any] = {}
        for evt in self.generate_stream(prompt, **kw):
            if evt["type"] == "token":
                parts.append(evt["text"])
            elif evt["type"] == "done":
                final = evt
            elif evt["type"] == "error":
                raise RuntimeError(evt.get("error", "generation failed"))
        return {
            "text": "".join(parts),
            "usage": final.get("usage", {}),
            "finish_reason": final.get("finish_reason", "stop"),
        }

    def slots_in_use(self) -> int:
        return sum(1 for s in self._slots if s is not None) + len(self._prefills)

    def queue_depth(self) -> int:
        return self._admit.qsize()

    def phase_budget(self) -> dict[str, float]:
        """Accumulated engine-loop wall-clock seconds per phase (host
        clock). Snapshot at two points and subtract to budget a window."""
        return dict(self._phase_s)

    def ttft_percentiles(self, window_s: float = 600.0) -> tuple[float, float, int]:
        """(p50_ms, p95_ms, n) of client-observed TTFT over the recent
        window, nearest rank."""
        now = time.time()
        with self.stats_lock:
            vals = sorted(v for t, v in self._ttft_window if now - t <= window_s)
        if not vals:
            return 0.0, 0.0, 0
        n = len(vals)
        p50 = vals[max(0, (n + 1) // 2 - 1)]
        p95 = vals[max(0, min(n - 1, int(n * 0.95 + 0.5) - 1))]
        return p50, p95, n

    def current_tps(self, window_s: float = 10.0) -> float:
        """Tokens emitted a second over the last `window_s` seconds."""
        now = time.time()
        with self.stats_lock:
            toks = sum(n for t, n in self._window if now - t <= window_s)
        return toks / window_s

    def scheduler_stats(self) -> dict[str, float]:
        """The token-budget scheduler's state (live prefill budget,
        starvation count, cost EMAs) and the decode batch's occupancy."""
        out = self._sched.stats()
        out["decode_batch_occupancy"] = (
            self._last_active_n / self.max_slots if self.max_slots else 0.0
        )
        return out

    def scheduler_tenant_stats(self) -> dict[str, dict[str, float]]:
        """Per-tenant quota detail (bucket level, throttles, charged
        tokens) for /v1/debug/perf; empty without quotas."""
        return self._sched.tenant_stats()

    # -- stall watchdog --------------------------------------------------

    def stall_seconds(self) -> float:
        """Age of the loop's last progress stamp: large with work in flight
        means the loop is wedged inside a device call. 0 inside a compile
        grace window and while a kernel library builds; a build's end
        counts as progress."""
        now = time.time()
        if now < self._compile_grace_until or kbuild.BUILD_STATE["active"]:
            return 0.0
        return max(0.0, now - max(self.last_progress, kbuild.BUILD_STATE["ended_at"]))

    def _note_exec_shape(self, *key) -> bool:
        """Record a dispatch shape; a first sighting (a graph capture, an
        eager phase's first call, with its kernels' first launches) opens a
        grace window of one stall timeout. True on a first sighting: the
        caller times that first use into the compile ledger
        (`_compile_obs`)."""
        if key in self._seen_exec_shapes:
            return False
        self._seen_exec_shapes.add(key)
        now = time.time()
        in_grace = now < self._compile_grace_until
        self._compile_grace_until = max(self._compile_grace_until, now + self.stall_timeout_s)
        if not in_grace:
            # one transition per grace episode, not per shape: overlapping
            # first sightings extend the same window
            self._watchdog_transition("compile_grace")
        return True

    def _watchdog_transition(self, state: str) -> None:
        """Count a watchdog / compile-grace transition and journal it, so
        "shed while a shape was first used" is told apart from a wedge."""
        with self.stats_lock:
            self.watchdog_transitions[state] = self.watchdog_transitions.get(state, 0) + 1
        self._flight.event("watchdog", state=state)

    def _compile_obs(self, phase: str, key: tuple, wall_s: float, hit: bool = False) -> None:
        """A shape's first use: a compile-ledger entry and a flight event,
        with the current provenance (`_compile_src`). The kernel libraries
        loaded since the last entry go in first, one "build" entry each
        (an nvcc build a miss, a library found built a hit). A graph
        capture and an eager first call are misses: nothing of them
        persists between processes."""
        for name, wall, built in kbuild.drain_loads():
            self._ledger_entry("build", (name,), wall, not built)
        self._ledger_entry(phase, key, wall_s, hit)

    def _ledger_entry(self, phase: str, key: tuple, wall_s: float, hit: bool) -> None:
        ks = ":".join(str(p) for p in key)
        e = self._ledger.observe(phase, ks, wall_s, hit=hit, src=self._compile_src)
        with self._own_compiles_lock:
            own = self._own_compiles.setdefault(
                (phase, ks), {"phase": phase, "key": ks, "count": 0, "total_s": 0.0})
            own["count"] += 1
            own["total_s"] += wall_s
        self._flight.event("compile", phase=phase, key=ks, wall_ms=round(wall_s * 1e3, 1),
                           hit=e["hit"], src=e["src"])

    def _first_use(self, phase: str, key: tuple, fn, *args):
        """`fn(*args)`, the dispatch of an eager phase at shape `key`. Its
        first use is synchronised on both sides and timed into the ledger
        (once a shape: the rounds after it pay no sync)."""
        if not self._note_exec_shape(phase, *key):
            return fn(*args)
        self._sync()
        t0 = time.perf_counter()
        out = fn(*args)
        self._sync()
        self._compile_obs(phase, key, time.perf_counter() - t0)
        return out

    def _paging_event(self, ops: list[tuple]) -> None:
        """Paged-ledger observer (paging.py `on_ops`): sharing-relevant
        block ops become flight events. It runs under the paging lock, so
        it only appends to the recorder."""
        for op in ops:
            kind = op[0]
            if kind == "pin":
                self._flight.event("pin", slot=op[1], blocks=len(op[2]))
            elif kind == "cow":
                self._flight.event("cow", slot=op[1], src=op[2], dst=op[3])
            elif kind == "free":
                self._flight.event("unpin", slot=op[1], blocks=len(op[2]))
            elif kind == "snap":
                self._flight.event("snap", snap_id=op[1], slot=op[2], shared=len(op[3]),
                                   private=len(op[4]))

    def _watchdog(self) -> None:
        poll = min(30.0, max(1.0, self.stall_timeout_s / 4))
        msg = "engine stalled: accelerator unresponsive"
        while not self._stop_evt.wait(timeout=poll):
            busy = self.slots_in_use() or self._admit.qsize()
            if busy and self.stall_seconds() > self.stall_timeout_s:
                if not self.stalled:
                    self.stalled = True
                    self._watchdog_transition("stalled")
                    log.error("engine stalled: no loop progress for %.0f s "
                              "(wedged device call?); shedding queued load",
                              self.stall_seconds())
                # requests the blocked loop can never admit: their consumers
                # would hang. Re-check per pop: a resumed loop keeps its work.
                drained = 0
                while self.stall_seconds() > self.stall_timeout_s:
                    try:
                        req = self._admit.get_nowait()
                    except queue.Empty:
                        break
                    self._error(req, msg)
                    drained += 1
                if drained:
                    log.error("engine watchdog errored %d queued requests", drained)
                # live consumers get their terminal error now; a resuming
                # loop skips and frees a slot marked done
                for s in list(self._slots):
                    if s is not None and not s.done and self.stall_seconds() > self.stall_timeout_s:
                        s.done = True
                        self._error(s.req, msg)
            elif self.stalled and self.stall_seconds() <= self.stall_timeout_s:
                self.stalled = False
                self._watchdog_transition("recovered")
                log.warning("engine loop recovered after stall")
            self.check_anomalies()

    def prefix_cache_stats(self) -> dict[str, int]:
        """Snapshot of the prompt-prefix cache (the cache itself belongs to
        the engine thread)."""
        return {
            "entries": len(self._prefix_cache),
            "bytes": self._prefix_cache_bytes,
            "hits": self.prefix_cache_hits,
            "misses": self.prefix_cache_misses,
        }

    def paging_stats(self) -> dict[str, float]:
        """The block ledger's economy and audit (`leaks` is 0 when every
        refcount is owed), plus the physical pool's counters when it is
        on."""
        out = self._paging.stats()
        out["enabled"] = 1.0
        out["leaks"] = float(self._paging.leak_count())
        if self._phys is not None:
            out.update(self._phys.stats())
            out["physical"] = 1.0
            contig, phys = self._phys_hbm_peak
            out["hbm_bytes_contiguous_equiv_peak"] = contig
            out["hbm_bytes_physical_peak"] = phys
            out["hbm_bytes_ratio_peak"] = self._phys_hbm_peak_ratio
        else:
            out["physical"] = 0.0
        return out

    def speculation_stats(self) -> dict[str, float]:
        """Self-speculative decoding's counters, JAX's keys: drafted,
        accepted and emitted tokens, verify calls, the accept rate and the
        tokens a verify call emits."""
        drafted = float(self.spec_drafted)
        calls = float(self.spec_calls)
        return {
            "enabled": 1.0 if self._verify_fn is not None else 0.0,
            "k": float(self.spec_k),
            "min_ngram": float(self.spec_min_ngram),
            "drafted_tokens": drafted,
            "accepted_tokens": float(self.spec_accepted),
            "emitted_tokens": float(self.spec_emitted),
            "verify_calls": calls,
            "accept_rate": (self.spec_accepted / drafted) if drafted else 0.0,
            "tok_per_call": (self.spec_emitted / calls) if calls else 0.0,
        }

    def constrain_stats(self) -> dict[str, Any]:
        """Constrained decoding's counters, JAX's keys: traffic, the
        illegal emissions (0: the mask makes them impossible; the counter
        is the check), the share of finished constrained requests that
        ended in an accepting state, the host's mask time a token, the
        masked verify's acceptance and the compile cache."""
        toks = float(self.cn_tokens)
        fin = float(self.cn_finished)
        drafted = float(self.cn_spec_drafted)
        out: dict[str, Any] = {
            "enabled": 1.0 if self._constrain is not None else 0.0,
            "requests": float(self.cn_requests),
            "tokens": toks,
            "illegal_tokens": float(self.cn_illegal),
            "finished": fin,
            "finished_accepting": float(self.cn_finished_accepting),
            "schema_valid_rate": (
                (self.cn_finished_accepting / fin) if fin else 1.0
            ) if self.cn_illegal == 0 else 0.0,
            "mask_us_per_tok": (self.cn_mask_s * 1e6 / toks) if toks else 0.0,
            "spec_drafted": drafted,
            "spec_accepted": float(self.cn_spec_accepted),
            "spec_accept_rate": (self.cn_spec_accepted / drafted) if drafted else 0.0,
        }
        if self._constrain is not None:
            out["cache"] = self._constrain.stats()
        return out

    # -- observability (JAX's keys) ------------------------------------------

    def check_anomalies(self) -> None:
        """Feed the poll-style detectors (decode-cadence stall, paged-leak
        growth) from host state; the watchdog thread calls it. Event-style
        detectors (TTFT burn, ITL, spec collapse, shed in grace) are fed at
        their sites."""
        now = time.time()
        if now >= self._compile_grace_until:
            # inside grace a shape may legitimately be in its first use
            busy = sum(1 for s in self._slots if s is not None)
            self._anomaly.signal("decode_stall", gap_s=now - self._last_round_ts,
                                 ema_s=self._sched.decode_round_s, busy=busy)
        self._anomaly.signal("paged_leak", leak_count=self._paging.leak_count())

    def flight_stats(self) -> dict[str, Any]:
        """Ring health, anomaly dumps, watchdog transitions and the compile
        ledger's summary (engines_info and the dashboard)."""
        rec = self._flight.stats()
        with self.stats_lock:
            transitions = dict(self.watchdog_transitions)
        return {
            "enabled": 1.0 if self._flight.enabled else 0.0,
            "events_total": float(rec["events_total"]),
            "dropped_events": float(rec["dropped_events"]),
            "dumps": float(rec["dumps"]),
            "last_dump_path": rec["last_dump_path"],
            "anomaly": self._anomaly.stats(),
            "watchdog_transitions": transitions,
            "compile": self._ledger.stats(),
        }

    def anomaly_history(self, limit: int = 20) -> list[dict[str, Any]]:
        return self._anomaly.history(limit)

    def perf_stats(self) -> dict[str, Any]:
        """ITL percentiles, the goodput split, the sampled phase
        attribution and the four-layout roofline (/v1/debug/perf)."""
        return self._perf.stats()

    def drain_itl_samples(self) -> list[float]:
        """ITL samples (s) since the last drain, for llmtpu_itl_seconds."""
        return self._perf.drain_itl()

    def waterfall_stats(self) -> dict[str, Any]:
        """The latency waterfall's stage percentiles, cumulative stage
        seconds and coverage (/v1/debug/latency)."""
        return self._waterfall.stats()

    def waterfall_recent(self, limit: int = 32) -> list[dict[str, Any]]:
        return self._waterfall.recent(limit)

    def workload_stats(self) -> dict[str, Any]:
        """The process-shared workload capture ring's health."""
        return self._workload.stats()

    # -- on-demand profiler capture (/v1/debug/profile) ------------------------

    def start_profile(self, steps: int, trace_dir: str = "") -> dict[str, Any]:
        """Arm a torch.profiler capture of the next `steps` loop iterations
        (any thread: the API, an anomaly dump's callback). The engine thread
        starts and stops it at loop boundaries, so it brackets real device
        work; the trace lands in `trace_dir` as Chrome trace JSON.
        Idempotent while one is armed or running."""
        steps = max(1, int(steps))
        d = trace_dir or os.environ.get("TPU_FLIGHT_PROFILE_DIR") or os.path.join(
            tempfile.gettempdir(), "llmtpu-profile")
        if self._profile_left > 0 or self._profile_pending is not None:
            return self.profile_status()
        self._profile_pending = (steps, d)
        self._wake.set()
        return self.profile_status()

    def profile_status(self) -> dict[str, Any]:
        pending = self._profile_pending
        return {
            "active": self._profile_left > 0,
            "steps_left": int(self._profile_left),
            "pending_steps": int(pending[0]) if pending else 0,
            "trace_dir": self._profile_dir or (pending[1] if pending else ""),
        }

    def _profile_tick(self) -> None:
        """Engine thread only: start a pending capture, count a live one
        down, stop and export it at zero. A profiler that fails to start
        disarms (logged): profiling never takes the loop down."""
        if self._profile_pending is not None:
            steps, d = self._profile_pending
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            try:
                os.makedirs(d, exist_ok=True)
                prof = torch.profiler.profile(activities=acts)
                prof.__enter__()
            except Exception:
                self._profile_pending = None
                log.exception("torch.profiler start failed; capture disarmed")
                return
            self._profiler = prof
            self._profile_left = steps
            self._profile_dir = d
            self._profile_pending = None
            self._flight.event("profile", action="start", steps=steps, dir=d)
            log.info("profiler capture started: %d steps -> %s", steps, d)
            return
        if self._profile_left > 1:
            self._profile_left -= 1
        elif self._profile_left == 1:
            prof, self._profiler = self._profiler, None
            path = os.path.join(self._profile_dir, f"trace-{time.time_ns()}.json")
            try:
                prof.__exit__(None, None, None)
                prof.export_chrome_trace(path)
            except Exception:
                log.exception("torch.profiler stop failed")
            # inactive only once the trace is on disk: a poller of
            # profile_status() then finds it
            self._profile_left = 0
            self._flight.event("profile", action="stop", dir=self._profile_dir)
            log.info("profiler capture finished -> %s", path)

    # -- warm-up (executor/warmup.py) ---------------------------------------------

    def warmup_shape_zoo(self) -> list[tuple[str, tuple]]:
        """The engine's serving-shape zoo, JAX's enumeration in the ledger's
        own vocabulary: every admit (rows, bucket) on the bucket ladder, the
        decode (Ba, compact, phys) ladder, and the zero-context prefill
        shapes (ragged T, or bucketed (rows, bucket, skey)). Later chunk
        skeys, fused groups and verify rounds depend on live traffic and
        join from the ledger's priors only (`start_warmup`)."""
        zoo: list[tuple[str, tuple]] = []
        phys = self._phys is not None
        S = self.max_seq_len
        buckets: list[int] = []
        n = 1
        while True:
            b = fine_bucket(n, S)
            if not buckets or b > buckets[-1]:
                buckets.append(b)
            if b >= S:
                break
            n = b + 1
        ab_cap = 1 << max(0, self.admit_batch - 1).bit_length()
        ab = 1
        while ab <= ab_cap:
            for bk in buckets:
                zoo.append(("admit", (ab, bk)))
            ab <<= 1
        B = self.max_slots
        if self.decode_compact:
            ba = min(8, B)
            while ba < B:
                zoo.append(("decode", (ba, True, phys)))
                ba <<= 1
        zoo.append(("decode", (B, False, phys)))
        if self.ragged_prefill and self.prefill_chunk > 0:
            # the ragged kernels take no past-key bound: skey 0 (JAX's
            # kernel arm)
            t = min(32, self._ragged_cap)
            while t <= self._ragged_cap:
                zoo.append(("pf_rag", (t, 0, phys)))
                t <<= 1
        elif self.prefill_chunk > 0:
            skey0 = min(128, S)
            cap = fine_bucket(self.prefill_chunk, S)
            rows = 1
            while rows <= ab_cap:
                for bk in [b for b in buckets if b <= cap]:
                    zoo.append(("chunk", (rows, bk, skey0, phys)))
                rows <<= 1
        return zoo

    @staticmethod
    def parse_ledger_key(ks: str) -> tuple:
        """Invert `_compile_obs`'s colon-joined key back into a typed tuple."""
        out: list = []
        for part in ks.split(":"):
            if part in ("True", "False"):
                out.append(part == "True")
            else:
                try:
                    out.append(int(part))
                except ValueError:
                    out.append(part)
        return tuple(out)

    def _warmup_key_fits(self, phase: str, key: tuple) -> bool:
        """Whether a plan step's key is dispatchable by this engine's
        config: the ledger is process-wide, so priors may carry other
        engines' shapes. Out-of-config keys record skip."""
        try:
            S = self.max_seq_len
            ab_cap = 1 << max(0, self.admit_batch - 1).bit_length()
            phys = self._phys is not None
            if phase == "admit":
                ab, bucket = int(key[0]), int(key[1])
                return 1 <= ab <= ab_cap and 0 < bucket <= S and fine_bucket(bucket, S) == bucket
            if phase == "decode":
                # an uncompacted round is every slot; a paged one needs the pool
                ba, compact = int(key[0]), bool(key[1])
                rows_ok = 1 <= ba < self.max_slots if compact else ba == self.max_slots
                return rows_ok and (phys or not bool(key[2]))
            if phase == "chunk":
                rows, bucket, skey = int(key[0]), int(key[1]), int(key[2])
                return (self.prefill_chunk > 0 and not self.ragged_prefill
                        and 1 <= rows <= ab_cap and 0 < bucket <= S and 0 <= skey <= S
                        and bool(key[3]) == phys)
            if phase == "pf_rag":
                t = int(key[0])
                return (self.ragged_prefill and self.prefill_chunk > 0
                        and 1 <= t <= self._ragged_cap and bool(key[2]) == phys)
            return True
        except (TypeError, ValueError, IndexError):
            return False

    def warmup_compile(self, phase: str, key: tuple) -> float | None:
        """One warm-up step, the planner's hook: the shape's first use, made
        before traffic, writing nothing a request can read. An admit runs
        one eager prefill at (rows, bucket) and throws its K/V and logits
        away; a prefill chunk runs one eager chunk of pads (rowid R,
        position S; pad slots B) with no write targets; a decode shape runs
        its round with every row parked (lengths = S: the fused append
        writes nothing) through `RoundGraphs` (eager first call, then the
        capture), both the unpaged and, with the pool, the paged graph. The
        token ring and the sampler's generator are restored after it, so
        greedy and seeded sampled output are what they were. The kernel
        libraries load (or build) on the way. Returns the step's wall, None
        for a phase that cannot be planned or a key of another config."""
        if phase not in warmup_mod.PLANNABLE_PHASES or not self._warmup_key_fits(phase, key):
            return None
        src, self._compile_src = self._compile_src, "warmup"
        t0 = time.perf_counter()
        try:
            with torch.inference_mode():
                if phase == "admit":
                    self._warm_admit(int(key[0]), int(key[1]))
                elif phase == "decode":
                    for paged in ((False, True) if key[2] else (False,)):
                        self._warm_decode(int(key[0]), bool(key[1]), paged)
                else:
                    group = (self._pad_group(int(key[0])) if phase == "pf_rag" else
                             self._pad_group(0, (int(key[0]), int(key[1])), int(key[2])))
                    self._group_call(group, tbl=None)
                    self._x_logits.pop(group.gid, None)  # its logits are dropped
            self._sync()
        finally:
            self._compile_src = src
        return time.perf_counter() - t0

    def _warm_admit(self, ab: int, bucket: int) -> None:
        tokens = np.zeros((ab, bucket), dtype=np.int32)
        lengths = np.full((ab,), bucket, dtype=np.int32)
        self._prefill_call(tokens, lengths)

    def _warm_decode(self, Ba: int, compact: bool, paged: bool) -> None:
        S, B = self.max_seq_len, self.max_slots
        if compact:
            packed = np.concatenate([np.full(Ba, S), np.zeros(Ba), [0]]).astype(np.int32)
        else:
            packed = np.concatenate([np.full(B, S), [0]]).astype(np.int32)
        tbl = self._phys.table if paged else None
        ring, gen = self._d_last.clone(), self._gen.get_state()
        self._round_call((Ba, compact, paged), packed, tbl)
        self._d_last.copy_(ring)
        self._gen.set_state(gen)

    def _pad_group(self, T: int, shape: tuple[int, int] = (0, 0), skey: int = 0) -> _PrefillGroup:
        """A chunk group of pads only, with no write targets: ragged [T]
        (rowid R, position S), or bucketed [rows, bucket] (slot B)."""
        R, S, B = self.admit_batch, self.max_seq_len, self.max_slots
        none = np.zeros((0,), dtype=np.int32)
        if T:
            return _PrefillGroup(
                metas=[], tokens=np.zeros((T,), dtype=np.int32),
                rowids=np.full((T,), R, dtype=np.int32), positions=np.full((T,), S, dtype=np.int32),
                slots=np.zeros((R,), dtype=np.int32), starts=np.zeros((R,), dtype=np.int32),
                last_idx=np.zeros((R,), dtype=np.int32), n_tokens=0, keep=none, wslot=none,
                wpos=none)
        rows, bucket = shape
        return _PrefillGroup(
            metas=[], tokens=np.zeros((rows, bucket), dtype=np.int32), rowids=None,
            positions=None, slots=np.full((rows,), B, dtype=np.int32),
            starts=np.zeros((rows,), dtype=np.int32), last_idx=None, n_tokens=0, keep=none,
            wslot=none, wpos=none, nvalid=np.ones((rows,), dtype=np.int32), bucket=bucket,
            skey=skey)

    def start_warmup(self, priors: list[dict] | None = None) -> warmup_mod.WarmupPlanner | None:
        """Build and run the warm-up plan (TPU_WARMUP=0: a TRUE no-op —
        None, no planner, no step). The critical prefix (one admit bucket,
        one prefill shape, one decode shape) runs before this returns, on
        the engine thread when it runs; the rest of the zoo runs one step
        per idle loop iteration (`_warmup_tick`; TPU_WARMUP_BG=0 skips
        it). `priors` takes compile-ledger table rows (the server's boot
        passes the warm-up pack's plan, `warmup_plan.json`); the live
        ledger's are always added. Idempotent; a failing step records `fail`, is
        logged, and the plan goes on."""
        if not warmup_mod.warmup_enabled():
            return None
        if self._tp is not None:
            # its parked steps run the model outside the step program, which
            # would hang the followers in the first collective
            log.info("warm-up off under tp=%d", self._tp.tp)
            return None
        if self._warmup is not None:
            return self._warmup
        rows = list(priors or [])
        rows.extend(self._ledger.table())
        # the ledger is process-wide: a plannable shape of another engine's
        # config is no prior here (it would take a critical slot and skip)
        prior_idx = {
            (ph, ks): v for (ph, ks), v in warmup_mod.priors_from_table(rows).items()
            if ph not in warmup_mod.PLANNABLE_PHASES
            or self._warmup_key_fits(ph, self.parse_ledger_key(ks))}
        zoo = self.warmup_shape_zoo()
        for ph, ks in list(prior_idx):
            # measured shapes join with typed keys; unplannable phases ride
            # along and record skip
            key = self.parse_ledger_key(ks)
            if (ph, key) not in zoo:
                zoo.append((ph, key))
        planner = warmup_mod.WarmupPlanner(
            self.warmup_compile, warmup_mod.plan_steps(zoo, prior_idx), event=self._flight.event)
        self._warmup = planner
        self._on_loop(planner.run_critical)
        if not warmup_mod.warmup_bg_enabled():
            planner.stop()
        self._wake.set()
        return planner

    def warmup_priors(self) -> list[dict]:
        """This engine's own compile-ledger rows in prior form
        (`warmup.pack_priors`): what the model zoo keeps at swap-out so the
        next residency's `start_warmup` plans from measured cost and hits.
        Only the shapes this engine first used: the ledger is the process's,
        and other engines' rows would plan another model's shapes."""
        with self._own_compiles_lock:
            rows = [dict(r) for r in self._own_compiles.values()]
        return warmup_mod.pack_priors(rows)

    def warmup_stats(self) -> dict[str, Any]:
        """Readiness and plan progress (/v1/debug/warmup); no planner reads
        as fully_warm with zero steps."""
        if self._warmup is None:
            return {"state": "fully_warm", "steps": 0, "enabled": False}
        st = self._warmup.stats()
        st["enabled"] = True
        return st

    def _warmup_tick(self) -> bool:
        """One background warm-up step, in a loop iteration in which
        nothing is active, mid-prefill, queued, in flight or offloaded.
        True when a step ran."""
        w = self._warmup
        if w is None or not w.pending():
            return False
        if (self.slots_in_use() or not self._admit.empty() or self._inflight
                or self._pending is not None
                or (self._pool is not None and self._pool.has_preempted())
                or (self._migrate_in is not None and not self._migrate_in.empty())):
            return False
        return w.run_next()

    # -- KV pool: admission ----------------------------------------------------

    def _offered_load(self) -> float:
        """The load the admission watermark compares, in slot-equivalents:
        the ledger's unique blocks (a shared prefix counts once), each live
        or mid-prefill request's committed growth (length + tokens left +
        one decode chunk), parked snapshots' restore needs and the queue at
        the recent admissions' block cost (`offered_blocks`). With nothing
        shared it is the count active + queued + preempted."""
        queued = self._admit.qsize()
        if self._pool is None:
            return float(self.slots_in_use() + queued)
        S, K = self.max_seq_len, self.decode_chunk
        wants: dict[int, int] = {}
        for b, s in enumerate(list(self._slots)):
            if s is None or s.done:
                continue
            rem = max(0, s.req.max_tokens - s.generated)
            wants[b] = min(int(self._lengths[b]) + rem + K, S)
        for slot, st in list(self._prefills.items()):
            wants[slot] = min(len(st.ids) + max(0, st.req.max_tokens) + K, S)
        mgr = self._paging
        return mgr.offered_blocks(wants, queued) / max(1, mgr.blocks_per_slot)

    def memory_stats(self) -> dict[str, float]:
        """The pool's counters, the offered load and the headroom;
        {"enabled": 0.0} without a pool."""
        pool = self._pool
        if pool is None:
            return {"enabled": 0.0}
        out = pool.stats()
        out["enabled"] = 1.0
        offered = self._offered_load()
        out["offered"] = float(offered)
        out["headroom"] = pool.headroom(offered)
        return out

    def admission_state(self, tenant: str = "") -> tuple[bool, float]:
        """(shed, retry_after_s) for the API's load-shedding gate: shed
        while the offered load is at the watermark, with the scheduler's
        drain estimate for the queue and the held snapshots, clamped to
        [1, 600] s. A non-empty `tenant` first consults its token bucket
        (`tenant_admit`): an over-quota tenant sheds here even with pool
        headroom. Side-effect free but the throttle counter; (False, 0.0)
        without a pool or a quota."""
        if tenant:
            ok, retry = self._sched.tenant_admit(tenant)
            if not ok:
                return True, min(600.0, max(1.0, retry))
        pool = self._pool
        if pool is None:
            return False, 0.0
        if pool.admit_ok(self._offered_load()):
            return False, 0.0
        with self.stats_lock:
            fr, ft = self.finished_requests, self.finished_tokens
        mean_tokens = (ft / fr) if fr else 64.0
        n_waiting = self._admit.qsize() + pool.preempted_count()
        retry = self._sched.drain_estimate_s(
            max(1, n_waiting), mean_tokens, self.decode_chunk, self.max_slots
        )
        return True, min(600.0, max(1.0, retry))

    def note_shed(self, n: int = 1, tenant: str = "") -> None:
        """The API shed `n` requests on this engine's behalf (a 429); a
        non-empty `tenant` also charges the shed to its goodput ledger."""
        if self._pool is not None:
            self._pool.note_shed(n)
        if tenant:
            self._perf.note_tenant_shed(tenant, n)
        in_grace = time.time() < self._compile_grace_until
        self._flight.event("shed", n=n, in_grace=in_grace)
        if in_grace:
            # work dropped while a shape was first used, not a wedge
            self._watchdog_transition("shed_in_grace")
        self._anomaly.signal("shed_in_grace", in_grace=in_grace, shed=n)

    # -- prompt-prefix cache and paged KV ----------------------------------

    PREFIX_MIN = 32  # shortest prefix worth caching (tokens)

    def _init_prefix_cache(self, prompt_cache_mb: int) -> None:
        """The ledger, and with physical paging the block tables and the
        prefix pool: the JAX engine's construction and gate."""
        self._prefix_cache: OrderedDict[tuple, dict] = OrderedDict()
        # stored length -> {key: entry}: stored lengths are pow2-floored,
        # so a lookup probes O(log S) buckets
        self._prefix_by_len: dict[int, dict[tuple, dict]] = {}
        self._prefix_cache_bytes = 0
        self._prefix_budget = int(prompt_cache_mb) * (1 << 20) if self.prefill_chunk > 0 else 0
        self._recent_prompts: deque[tuple] = deque(maxlen=16)
        self.prefix_cache_hits = 0
        self.prefix_cache_misses = 0
        # the fleet prefix tier: `_prefix_pub` mirrors the resident entries
        # {key: tokens} behind its own lock, so digests and match probes
        # from other threads never touch the engine thread's OrderedDict;
        # exports and imports are parked on `_prefix_rpc_in` for the engine
        # thread (`_drain_prefix_rpc`)
        self._prefix_pub: dict[tuple, int] = {}
        self._prefix_pub_lock = threading.Lock()
        self._prefix_rpc_in: "queue.Queue[tuple]" = queue.Queue()
        self.prefix_exports_total = 0
        self.prefix_export_bytes_total = 0
        self.prefix_imports_total = 0
        self.prefix_import_bytes_total = 0
        self.prefix_import_rejects_total = 0
        # the pytree byte count, as JAX's: the same budget gives the same
        # prefix partition and pool rows
        cache_bytes = _nbytes(self._full_ck, self._full_cv)
        self._paging = PagedKVManager(
            max_slots=self.max_slots,
            max_seq_len=self.max_seq_len,
            bytes_per_token=cache_bytes // max(1, self.max_slots * self.max_seq_len),
            prefix_budget_bytes=self._prefix_budget,
        )
        self._phys: PhysicalPool | None = None
        self._pool_k = None  # like the cache: a tensor or the fused dict
        self._pool_v = None
        bt = self._paging.block_tokens
        if (
            os.environ.get("TPU_PAGED_PHYSICAL", "1") not in ("", "0", "false", "no", "off")
            and self._prefix_budget > 0
            and self._paging.prefix_partition >= 1
            and self.max_seq_len % bt == 0
            and bt in (32, 64, 128, 256)
        ):
            rows = self._paging.prefix_partition
            self._phys = PhysicalPool(
                n_slots=self.max_slots, seq_len=self.max_seq_len, block_tokens=bt,
                pool_rows=rows,
            )
            self._pool_k = pool_like(self._ck, rows, bt)
            self._pool_v = pool_like(self._cv, rows, bt)
            # the HBM ledger's peak (`_phys_note_hbm`): contiguous-equivalent
            # bytes over the bytes physically resident
            self._phys_hbm_peak_ratio = 1.0
            self._phys_hbm_peak = (0.0, 0.0)
        log.info(
            "paged KV: %d-token blocks, %d arena + %d prefix blocks, physical %s",
            bt, self._paging.slot_partition, self._paging.prefix_partition,
            self._phys is not None,
        )

    @staticmethod
    def _common_len(a: tuple, b: tuple) -> int:
        n = min(len(a), len(b))
        i = 0
        while i < n and a[i] == b[i]:
            i += 1
        return i

    def _match_prefix(self, ids: list[int]) -> dict | None:
        """Longest cached entry that is a STRICT prefix of `ids` (at least
        one suffix token remains: the suffix chunk gives the first logits)."""
        if not self._prefix_budget or not self._prefix_cache:
            return None
        t = tuple(ids)
        best_key, best = None, None
        for P in sorted(self._prefix_by_len, reverse=True):
            if P >= len(t):
                continue
            e = self._prefix_by_len[P].get(t[:P])
            if e is not None:
                best_key, best = t[:P], e
                break
        if best is not None:
            self._prefix_cache.move_to_end(best_key)  # LRU touch
            self.prefix_cache_hits += 1
        else:
            self.prefix_cache_misses += 1
        return best

    def _start_cached(self, ent: dict, group: list) -> None:
        """Admit a group of hits on one entry: the suffixes join the ragged
        chunk queue at start = P. Physical entries are pinned into each
        slot's table (only an unaligned boundary block is copied);
        contiguous entries copy their rows into every slot."""
        P = ent["P"]
        if "eid" in ent:
            self._dx("insert", ent["eid"], [slot for slot, _, _ in group], P)
        for slot, req, ids in group:
            self._prefills[slot] = _PrefillState(req=req, ids=list(ids), done=P, shared_len=P,
                                                 shared_entry=ent)
            self._prefill_q.append(slot)
            ops = self._paging.admit_shared(slot, ent["key"], len(ids))
            if "eid" not in ent:
                self._phys_admit(slot, ent, ops)

    def _maybe_store_prefix(self, slot: int, ids: list[int]) -> None:
        """At activation: if this prompt shares a long prefix with recent
        traffic, store that prefix from the slot's rows [0, P0), which hold
        exactly the prompt's KV whatever the admission path."""
        if not self._prefix_budget:
            return
        t = tuple(ids)
        best = 0
        for other in self._recent_prompts:
            if other is not t:
                best = max(best, self._common_len(t, other))
        p0 = min(best, len(t) - 1)  # a hit keeps >= 1 suffix token
        if p0 < self.PREFIX_MIN:
            return
        p0 = 1 << (p0.bit_length() - 1)  # pow2 floor, as the JAX engine stores
        key = t[:p0]
        if key in self._prefix_cache:
            return
        # one ledger: the entry claims blocks from the prefix partition
        # first, evicting LRU entries until it fits
        while not self._paging.prefix_can_fit(p0) and self._prefix_cache:
            self._evict_lru_prefix()
        if self._paging.prefix_register(key, p0) is None:
            return
        nbytes = self._entry_bytes(p0)
        if self._phys is not None:
            if not self._store_prefix_physical(slot, key):
                self._paging.prefix_release(key)
                self._phys.sweep(self._paging.alive)
                return
            ent = {"P": p0, "bytes": nbytes, "key": key}
        else:
            # a contiguous entry: the rows live in the op-owned `_x_prefix`
            ent = {"P": p0, "bytes": nbytes, "key": key, "eid": self._new_eid()}
            self._dx("pfxput", ent["eid"], slot, p0)
        self._add_prefix_entry(key, ent)
        log.info("prefix cache: stored a %d-token prefix (%d entries)", p0, len(self._prefix_cache))

    def _entry_bytes(self, p0: int) -> int:
        """A p0-token entry's bytes: every leaf's per-(row, token) bytes
        times p0, of the whole cache (every head, as JAX counts)."""
        return sum(x.numel() // (x.shape[1] * x.shape[3]) * p0 * x.element_size()
                   for x in _leaves(self._full_ck, self._full_cv))

    def _new_eid(self) -> int:
        self._eid_ctr += 1
        return self._eid_ctr

    def _add_prefix_entry(self, key: tuple, ent: dict) -> None:
        """Index and publish a new entry, then evict LRU entries over the
        budget (the new one too, when it alone is larger)."""
        self._prefix_cache[key] = ent
        self._prefix_by_len.setdefault(ent["P"], {})[key] = ent
        self._prefix_cache_bytes += ent["bytes"]
        with self._prefix_pub_lock:
            self._prefix_pub[key] = ent["P"]
        while self._prefix_cache_bytes > self._prefix_budget and self._prefix_cache:
            self._evict_lru_prefix()

    def _evict_lru_prefix(self) -> None:
        """Evict the least recently used entry. Its pool rows are reclaimed
        only once no table pins its blocks any more."""
        old_key, old = self._prefix_cache.popitem(last=False)
        self._prefix_cache_bytes -= old["bytes"]
        with self._prefix_pub_lock:
            self._prefix_pub.pop(old_key, None)
        self._paging.prefix_release(old["key"])
        if "eid" in old:
            self._dx("pfxdrop", old["eid"])
        if self._phys is not None:
            self._phys.sweep(self._paging.alive)
        bucket = self._prefix_by_len.get(old["P"])
        if bucket is not None:
            bucket.pop(old_key, None)
            if not bucket:
                del self._prefix_by_len[old["P"]]

    def _store_prefix_physical(self, slot: int, key: tuple) -> bool:
        """Copy a freshly registered entry's blocks into the pool, read
        through the storing slot's own table (a sharer storing a longer
        prefix copies its shared blocks pool to pool). False when the pool
        has no rows; the caller releases the registration."""
        ids = self._paging.prefix_ids(key)
        if ids is None:
            return False
        rows = self._phys.register_prefix(ids)
        if rows is None:
            return False
        for (in_arena, src, off), prow in zip(self._phys.row_sources(slot, len(ids)), rows):
            if in_arena:
                self._pool_put_arena(src, off, prow)
            else:
                self._pool_put_pool(src, prow)
        return True

    # -- the fleet prefix tier (prefix-locality routing, peer fetch) -------

    def prefix_chains(self) -> list[tuple[tuple, int]]:
        """Resident prefix chains as (token key, stored tokens) pairs, the
        digest's source: the published mirror, safe from any thread."""
        with self._prefix_pub_lock:
            return list(self._prefix_pub.items())

    def prefix_digest(self, top_k: int = prefix_fp.DEFAULT_TOP_K) -> dict | None:
        """The resident chains' digest for the device tags
        (`routing/prefix.py` `build_digest`), or None when the prefix cache
        is off or empty: no tag means nothing to match."""
        if not self._prefix_budget:
            return None
        chains = self.prefix_chains()
        if not chains:
            return None
        return prefix_fp.build_digest(chains, self._paging.block_tokens, top_k=top_k)

    def prefix_match_len(self, ids: list[int]) -> int:
        """The longest resident chain that is a strict prefix of `ids`
        (thread-safe: the fetch path compares it with a peer's claim before
        paying for the wire)."""
        t = tuple(ids)
        best = 0
        with self._prefix_pub_lock:
            for key, n in self._prefix_pub.items():
                if best < n < len(t) and key == t[:n]:
                    best = n
        return best

    def prefix_export(self, ids: list[int], timeout_s: float = 30.0) -> bytes | None:
        """The longest resident chain prefixing `ids` as a wire payload (a
        chain that only partly overlaps ships cut to the largest pow2 both
        share). Parked on the engine thread, which alone touches the prefix
        cache and the pool; blocks the caller until served. None on a miss,
        with the cache off, or on a timeout."""
        if not self._prefix_budget:
            return None
        box: dict[str, Any] = {}
        ev = threading.Event()
        self._prefix_rpc_in.put(("export", (list(ids),), box, ev))
        self._wake.set()
        if not ev.wait(timeout_s):
            return None
        return box.get("payload")

    def prefix_export_by_hash(self, hash16: str, timeout_s: float = 30.0) -> bytes | None:
        """Export the resident chain whose digest head hash is `hash16`
        (`routing/prefix.py` `chain_hashes`): a joining server knows the
        fleet's hottest chains only as hashes from the device tags."""
        if not self._prefix_budget:
            return None
        want = str(hash16 or "").strip().lower()
        if not want:
            return None
        bt = self._paging.block_tokens
        for key, _ in sorted(self.prefix_chains(), key=lambda kv: -kv[1]):
            bounds = chain_hashes(list(key), bt)
            if bounds and bounds[-1][1] == want:
                return self.prefix_export(list(key), timeout_s=timeout_s)
        return None

    def prefix_import(self, payload: bytes, timeout_s: float = 30.0) -> bool:
        """Adopt a peer's exported chain into the local cache: decoded on
        the calling thread (into pinned memory on the card), inserted on
        the engine thread. The next admission on it is an ordinary hit. A
        bad payload, another geometry or a full pool is rejected (counted
        in `import_rejects_total`), never raised."""
        if not self._prefix_budget:
            return False
        try:
            header, trees = migration.decode_payload(payload, pin=self.device.type == "cuda")
        except Exception:
            header, trees = {}, {}
        if header.get("kind") != "prefix":
            with self.stats_lock:
                self.prefix_import_rejects_total += 1
            return False
        box: dict[str, Any] = {}
        ev = threading.Event()
        self._prefix_rpc_in.put(("import", (header, trees, len(payload)), box, ev))
        self._wake.set()
        if not ev.wait(timeout_s):
            return False
        return bool(box.get("ok"))

    def _drain_prefix_rpc(self) -> None:
        """Engine thread: serve the parked exports and imports; a failure
        reports through the box (the waiting thread owns its handling)."""
        while True:
            try:
                kind, args, box, ev = self._prefix_rpc_in.get_nowait()
            except queue.Empty:
                return
            try:
                if kind == "export":
                    box["payload"] = self._prefix_export_now(*args)
                else:
                    box["ok"] = self._prefix_import_now(*args)
            except Exception as e:  # the waiter must be released
                log.warning("prefix %s failed: %s", kind, e)
                box["error"] = str(e)
            finally:
                ev.set()

    def _prefix_export_now(self, ids: list[int]) -> bytes | None:
        """Gather the longest resident chain prefixing `ids` into a payload
        (engine thread). The match is not strict: the requester applies
        its own strict-prefix rule. When no whole chain prefixes `ids`, the
        best chain ships cut to the largest pow2 prefix both share (the
        digest claims matches at block granularity, so a peer may dial on
        a partial overlap); pow2, because imports take pow2 lengths only."""
        if not self._prefix_cache:
            return None
        t = tuple(ids)
        key, ent, P0 = None, None, 0
        for P in sorted(self._prefix_by_len, reverse=True):
            if P > len(t):
                continue
            e = self._prefix_by_len[P].get(t[:P])
            if e is not None:
                key, ent, P0 = t[:P], e, P
                break
        if ent is None:
            for P, bucket in self._prefix_by_len.items():
                for k2, e in bucket.items():
                    c = self._common_len(k2, t)
                    trunc = 1 << (c.bit_length() - 1) if c else 0
                    if self.PREFIX_MIN <= trunc < P and trunc > P0:
                        key, ent, P0 = k2, e, trunc
        if ent is None:
            return None
        t0 = time.perf_counter()
        bt = self._paging.block_tokens
        if "eid" in ent:
            hk, hv = self._dx("pfxexp", ent["eid"], P0)
        else:
            lids = self._paging.prefix_ids(key)
            if lids is None or self._phys is None:
                return None
            rows = []
            for lid in lids[: max(1, P0 // bt)]:
                prow = self._phys.phys_of(lid)
                if prow is None:
                    self._phys.missing_pins += 1
                    return None
                rows.append(prow - self._phys.pool_base)
            hk, hv = self._pool_rows_host(rows, P0)
        self._sync_stream()
        header = {"kind": "prefix", "P": P0, "ids": [int(x) for x in key[:P0]],
                  "block_tokens": bt}
        payload = migration.encode_payload(header, {"k": hk, "v": hv})
        self._prefix_cache.move_to_end(key)  # a fetched chain is hot fleet-wide
        wall_ms = (time.perf_counter() - t0) * 1e3
        with self.stats_lock:
            self.prefix_exports_total += 1
            self.prefix_export_bytes_total += len(payload)
        self._flight.event("prefix_out", tokens=P0, wire_bytes=len(payload),
                           wall_ms=round(wall_ms, 1))
        log.info("prefix export: %d tokens, %.1f KB in %.1f ms", P0, len(payload) / 1024,
                 wall_ms)
        return payload

    def _prefix_reject(self) -> bool:
        with self.stats_lock:
            self.prefix_import_rejects_total += 1
        return False

    def _prefix_import_now(self, header: dict, trees: dict, nbytes_wire: int) -> bool:
        """Insert a decoded chain into the local prefix cache (engine
        thread): the ledger registration first (evicting LRU entries to
        fit, as a local store), then pool rows on the physical path or
        device rows on the contiguous one. Only pow2 lengths insert (a
        peer's entries are pow2 by construction), and the geometry must
        match the local cache leaf for leaf."""
        P0 = int(header.get("P") or 0)
        ids = [int(x) for x in header.get("ids") or []]
        hk = trees.get("k")
        hv = trees.get("v")
        hv = {} if hv is None else hv
        if (P0 < self.PREFIX_MIN or P0 & (P0 - 1) or len(ids) != P0 or hk is None
                or not self._prefix_wire_compat(hk, hv, P0)):
            return self._prefix_reject()
        key = tuple(ids)
        if key in self._prefix_cache:
            self._prefix_cache.move_to_end(key)
            return True
        while not self._paging.prefix_can_fit(P0) and self._prefix_cache:
            self._evict_lru_prefix()
        if self._paging.prefix_register(key, P0) is None:
            return self._prefix_reject()
        nbytes = self._entry_bytes(P0)
        if self._phys is not None:
            if not self._import_prefix_physical(key, hk, hv):
                self._paging.prefix_release(key)
                self._phys.sweep(self._paging.alive)
                return self._prefix_reject()
            ent = {"P": P0, "bytes": nbytes, "key": key}
        else:
            ent = {"P": P0, "bytes": nbytes, "key": key, "eid": self._new_eid()}
            self._dx("pfximp", ent["eid"], hk, hv)
        self._add_prefix_entry(key, ent)
        if key not in self._prefix_cache:  # a budget smaller than the entry
            return self._prefix_reject()
        with self.stats_lock:
            self.prefix_imports_total += 1
            self.prefix_import_bytes_total += nbytes_wire
        self._flight.event("prefix_in", tokens=P0, wire_bytes=nbytes_wire)
        log.info("prefix import: %d tokens, %.1f KB wire (%d entries)", P0, nbytes_wire / 1024,
                 len(self._prefix_cache))
        return True

    def _prefix_wire_compat(self, hk: Any, hv: Any, P0: int) -> bool:
        """Whether decoded trees match the cache's geometry (every head):
        the same leaves, layers, heads and trailing dims, one row of P0
        tokens."""
        def same(ref, h) -> bool:
            if isinstance(ref, dict):
                return (isinstance(h, dict) and set(ref) == set(h)
                        and all(same(ref[k], h[k]) for k in ref))
            return (isinstance(h, torch.Tensor) and h.dim() == ref.dim()
                    and h.shape[0] == ref.shape[0] and h.shape[1] == 1
                    and h.shape[2] == ref.shape[2] and h.shape[3] == P0
                    and h.shape[4:] == ref.shape[4:])

        return same(self._full_ck, hk) and same(self._full_cv, hv)

    def _import_prefix_physical(self, key: tuple, hk: Any, hv: Any) -> bool:
        """Upload a decoded chain's blocks into fresh prefix-pool rows (the
        tail block zero-padded: its pad is dead, as the copy on write of an
        unaligned boundary block and the suffix prefill overwrite it)."""
        lids = self._paging.prefix_ids(key)
        if lids is None:
            return False
        rows = self._phys.register_prefix(lids)
        if rows is None:
            return False
        bt = self._paging.block_tokens
        for j, prow in enumerate(rows):
            blk_k, blk_v = (_map(lambda h: h[:, :, :, j * bt: (j + 1) * bt], t) for t in (hk, hv))
            self._dx("pput", "host", blk_k, blk_v, int(prow))
        return True

    def prefix_tier_stats(self) -> dict[str, float]:
        """The fleet prefix tier's counters (the core server's
        engines_info, the dashboard and /v1/debug/prefix)."""
        with self._prefix_pub_lock:
            chains = len(self._prefix_pub)
            longest = max(self._prefix_pub.values(), default=0)
        with self.stats_lock:
            return {
                "enabled": 1.0 if self._prefix_budget else 0.0,
                "chains": float(chains),
                "longest_tokens": float(longest),
                "exports_total": float(self.prefix_exports_total),
                "export_bytes_total": float(self.prefix_export_bytes_total),
                "imports_total": float(self.prefix_imports_total),
                "import_bytes_total": float(self.prefix_import_bytes_total),
                "import_rejects_total": float(self.prefix_import_rejects_total),
            }

    def _phys_admit(self, slot: int, ent: dict, ops: list[tuple]) -> None:
        """Physical side of a hit: carry out the ledger's copy-on-write of
        the boundary block (one whole block from the entry's pool row),
        then re-key the slot's table row."""
        for op in ops:
            if op[0] != "cow":
                continue
            phys = self._phys.phys_of(op[2])
            if phys is None:  # tripwire: unmapped entry block (audited)
                self._phys.missing_pins += 1
                continue
            blk = ent["P"] // self._paging.block_tokens
            self._cow_block(slot, blk, phys - self._phys.pool_base)
            self._phys.cow_copies_total += 1
            self._flight.event("pg_cow", slot=slot, blk=blk, pool_row=phys - self._phys.pool_base)
        self._phys_rebuild(slot)
        self._phys_note_hbm()

    def _phys_note_hbm(self) -> None:
        """At a shared admission, the HBM ledger's sample: what the live
        working set occupies physically (unique blocks, each resident once)
        against what a contiguous engine holds for it (every sharer's rows,
        plus the prefix entries' own); the peak ratio is kept."""
        st = self._paging.stats()
        bb = float(self._paging.bytes_per_block)
        used = st["blocks_used"]
        if bb <= 0 or used <= 0:
            return
        phys = used * bb
        contig = st["logical_blocks"] * bb + float(self._prefix_cache_bytes)
        ratio = contig / phys
        if ratio > self._phys_hbm_peak_ratio:
            self._phys_hbm_peak_ratio = ratio
            self._phys_hbm_peak = (contig, phys)

    def _phys_rebuild(self, slot: int) -> None:
        if self._phys is not None:
            ids, shared_n = self._paging.table_view(slot)
            if self._phys.rebuild(slot, ids, shared_n):
                self._flight.event("pg_tbl", slot=slot, action="rebuild", shared=shared_n)

    def _phys_sweep(self) -> None:
        """Reclaim pool rows after pins were dropped without a table change
        (a snapshot's parked pins)."""
        if self._phys is not None:
            self._phys.sweep(self._paging.alive)

    def _phys_reset(self, slot: int) -> None:
        """Slot released: its table row back to identity, then reclaim the
        pool rows whose ledger ids just died."""
        if self._phys is not None:
            if self._phys.reset(slot):
                self._flight.event("pg_tbl", slot=slot, action="reset")
            self._phys.sweep(self._paging.alive)

    # Device block copies, in place on the engine's stream (the JAX
    # engine's `_cow_block_raw`, `_pool_put_arena_raw`, `_pool_put_pool_raw`,
    # ops "cow" and "pput"), over every leaf: a fused int8 block moves all
    # its payload heads (the packed pseudo-head too) and its plain scales
    # together.

    def _cow_block(self, slot: int, blk: int, prow: int) -> None:
        """Pool row `prow` into block `blk` of the slot's arena row."""
        self._dx("cow", int(slot), int(blk), int(prow))

    def _pool_put_arena(self, row: int, off: int, prow: int) -> None:
        """One block of arena row `row` at token offset `off` into pool row `prow`."""
        self._dx("pput", "arena", int(row), int(off), int(prow))

    def _pool_put_pool(self, src: int, dst: int) -> None:
        self._dx("pput", "pool", int(src), 0, int(dst))

    def kv_scale_audit(self) -> int:
        """Positions (layer, row, head, token) of the arena and the pool
        where the fused int8 cache's packed pseudo-head and its plain
        scales "s" disagree in any bit. Every write and copy path keeps
        them equal, so 0 is sound; a bf16 cache, one without the
        pseudo-head and the MLA latent cache (whose planes carry their
        scales in "s" alone) have nothing to audit."""
        bad = 0
        for c in (self._ck, self._pool_k):
            if not isinstance(c, dict) or c["q"].shape[2] == c["s"].shape[2]:
                continue
            Hs = c["s"].shape[2]
            nb = Hs * c["s"].element_size()
            packed = c["q"][:, :, Hs, :, :nb].reshape(*c["q"].shape[:2], -1, Hs, nb // Hs)
            plain = c["s"].transpose(2, 3).contiguous().view(torch.int8)
            plain = plain.reshape(packed.shape)
            bad += int((packed != plain).any(dim=-1).sum().item())
        return bad

    def _reset_kv(self) -> None:
        """After a failed step: the caches may hold partial writes, and a
        prefix entry pointing at them would give wrong answers. Zero the
        cache, drop every prefix entry, reset every table and zero the pool
        (as the JAX engine's `_recover_cache`); `_abort_all` follows and
        frees every slot's table, which returns the last pool rows."""
        for x in _leaves(self._ck, self._cv):
            x.zero_()
        self._x_logits.clear()
        while self._prefix_cache:
            self._evict_lru_prefix()
        if self._phys is not None:
            for x in _leaves(self._pool_k, self._pool_v):
                x.zero_()
            self._phys.reset_all()

    # -- engine loop -------------------------------------------------------

    def _run(self) -> None:
        K.bind_engine_tally(self.kernel_launches)
        with torch.inference_mode():
            while not self._stop_evt.is_set():
                # watchdog stamp: an idle loop iterates (the wait times
                # out), so staleness accrues only inside a blocked call
                self.last_progress = time.time()
                self._backend.idle()  # liveness beacon while the queue is quiet
                if self.stalled:
                    self.stalled = False
                    self._watchdog_transition("recovered")
                    log.warning("engine loop resumed; clearing stall flag")
                if self._profile_pending is not None or self._profile_left > 0:
                    self._profile_tick()
                self._run_loop_calls()
                before = self.total_tokens
                try:
                    busy = self._step() or self._warmup_tick()
                except Exception as e:  # a failed dispatch must not hang waiters
                    log.exception("engine step failed")
                    self._recover(f"engine step failed: {e}")
                    busy = False
                if self.total_tokens > before:
                    with self.stats_lock:
                        self._window.append((time.time(), self.total_tokens - before))
                if not busy:
                    t0 = time.perf_counter()
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
                    self._phase_s["idle"] += time.perf_counter() - t0
            if self.dead:
                # a dead engine's rounds in flight ran on state the followers
                # no longer share: every request ends with the error
                self._inflight.clear()
                self._pending = None
                self._abort_all(f"engine dead: {self.dead}")
            else:
                try:
                    self._drain()  # in-flight rounds' consumers get their tokens
                except Exception as e:  # pragma: no cover - the device failed at shutdown
                    log.exception("in-flight rounds lost at shutdown")
                    self._recover(f"engine step failed: {e}")
            self._run_loop_calls()  # a caller waiting on the loop is released
        # release the followers: the replay ends where the leader's loop
        # ends (a clean shutdown and a dead engine alike)
        self._backend.stop()

    def _run_loop_calls(self) -> None:
        """Run the calls other threads handed to the engine thread
        (`_on_loop`), each once, passing back its exception."""
        while self._loop_calls:
            fn, done, err = self._loop_calls.popleft()
            try:
                if self._stop_evt.is_set():
                    raise RuntimeError("engine shutdown")
                fn()
            except Exception as e:
                err.append(e)
            finally:
                done.set()

    def _on_loop(self, fn) -> None:
        """Run `fn` on the engine thread when it runs (the round graphs are
        captured and replayed there only), else here; raise what it
        raised."""
        thread = self._thread
        if thread is None or not thread.is_alive() or thread is threading.current_thread():
            with torch.inference_mode():
                fn()
            return
        done, err = threading.Event(), []
        self._loop_calls.append((fn, done, err))
        self._wake.set()
        while not done.wait(timeout=1.0):
            if not thread.is_alive():
                self._run_loop_calls()  # the loop ended before taking it
        if err:
            raise err[0]

    def _step(self) -> bool:
        """One iteration of the pipelined loop (module docstring)."""
        K, S = self.decode_chunk, self.max_seq_len
        if self._pool is not None and self._preempt_wanted():
            # a snapshot needs exact host lengths, and lengths advance at
            # dispatch: fetch and emit every round first. The drain may free
            # a slot, so ask again.
            self._drain()
            if self._preempt_wanted():
                self._preempt_one()
        # dispatchable: active rows whose next K writes fit; a row at the
        # cap waits for its in-flight round's fetch, which finishes it
        active = [
            i for i, s in enumerate(self._slots) if s is not None and self._lengths[i] + K <= S
        ]
        cn_active = [i for i in active if self._slots[i].cn is not None]
        if cn_active:
            # constrained slots leave the pipelined rounds: each of their
            # rounds is synchronous and committed before the next mask
            active = [i for i in active if self._slots[i].cn is None]
            self._cn_round(cn_active)
        if self._verify_fn is not None and active:
            active = self._try_spec(active)
            if active is None:
                return True  # a verify round ran
        group = self._stage_group(len(active))
        timed = self._timed
        if active:
            self._inflight.append(timed("dispatch", self._dispatch_decode, active, group))
            if group is not None:
                timed("prefill", self._finish_prefill_group, group)
        elif group is not None:
            timed("prefill", self._run_prefill_group, group)  # nothing to fuse with
        if self._pending is not None:
            pending, self._pending = self._pending, None
            timed("emit", self._emit_round, pending)
        admitted = timed("admit", self._admit_pending)
        if self._inflight and (len(self._inflight) >= self.pipeline_depth or not active):
            self._pending = timed("fetch", self._complete_round, self._inflight.popleft())
            return True
        return bool(active or cn_active or group is not None or admitted or self._inflight)

    def _timed(self, phase: str, fn, *args):
        """Run `fn(*args)`, adding its host wall time to `phase`."""
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            self._phase_s[phase] += time.perf_counter() - t0

    def _try_spec(self, active: list[int]) -> list[int] | None:
        """The JAX loop's speculative branch: with a draft majority, fetch
        and emit every round in flight (drafts continue the committed
        history; acceptance is data dependent, so lengths cannot advance
        optimistically), draft again over the post-drain history, run the
        verify round with its tokens reserved against the prefill budget,
        the staged group alone behind it, then admit. None when a verify
        round ran; else the dispatchable slots for the pipelined path
        (recounted when the drain freed some)."""
        if self._spec_cooldown > 0:
            self._spec_cooldown -= 1
            return active
        if self._stage_spec(active) is None:
            return active
        self._drain()
        K, S = self.decode_chunk, self.max_seq_len
        active = [
            i for i, s in enumerate(self._slots)
            if s is not None and self._lengths[i] + K <= S and s.cn is None
        ]
        entries = self._stage_spec(active) if active else None
        if entries is None:
            return active
        reserved = sum(1 + len(d) for _, d in entries)
        group = self._stage_group(len(active), reserved)
        self._spec_round(entries)
        if group is not None:
            self._run_prefill_group(group)
        self._admit_pending()
        return None

    def _drain(self) -> None:
        """Emit the fetched round, then fetch and emit every round in flight."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            self._emit_round(pending)
        while self._inflight:
            self._emit_round(self._complete_round(self._inflight.popleft()))

    def _recover(self, msg: str) -> None:
        """After a failed step: deliver the tokens already fetched, drop the
        rounds in flight (they ran on the same caches), then reset the KV
        state and error every request. Under a mesh the engine goes dead
        instead (`_mark_dead`): the followers cannot rebuild in step."""
        if self._spmd:
            self._mark_dead(msg)
            self._inflight.clear()
            self._pending = None
            self._abort_all(f"engine dead: {self.dead}")
            return
        if self._pending is not None:
            pending, self._pending = self._pending, None
            try:
                self._emit_round(pending)
            except Exception:  # pragma: no cover - the requests are errored below
                log.exception("emission failed during recovery")
        self._inflight.clear()
        self._rid_fetched = self._rid_dispatched
        self._cooling.clear()
        self._reset_kv()
        self._abort_all(msg)

    def _up(self, x: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device, without a host sync: on the
        card a pinned copy sent non-blocking (the host allocator keeps the
        pinned block until its copy has run)."""
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type == "cpu":
            return t.clone()
        return t.pin_memory().to(self.device, non_blocking=True)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            device_sync(self.device)  # never inside another engine's capture

    def _samp_payload(self, slots: list[int], reqs: list) -> tuple:
        """An activation sample's host payload: ints [slots | top_k], floats
        [temperature | top_p], and the constrained rows' masks (or None)."""
        n = len(slots)
        cn = self._cn_payload([r.cn for r in reqs], n)
        ints = np.asarray(slots + [r.top_k for r in reqs], dtype=np.int32)
        flts = np.asarray([r.temperature for r in reqs] + [r.top_p for r in reqs],
                          dtype=np.float32)
        return ints, flts, cn

    def _cn_dev(self, cn: tuple | None) -> tuple | None:
        return None if cn is None else tuple(self._up(x) for x in cn)

    def _sample_rows(self, logits: torch.Tensor, ints: np.ndarray, flts: np.ndarray,
                     cn: tuple | None) -> torch.Tensor:
        """Activation (inside ops "admit" and "bsample"): sample each
        prompt's first token from its logits and write it and the request's
        sampling parameters into the device round state at its slot (JAX's
        `op_bsample`); a constrained request's first token is masked by its
        automaton and bias. Returns the tokens on the device."""
        n = len(ints) // 2
        cn = self._cn_dev(cn)
        ints, flts = self._up(ints), self._up(flts)
        idx, topk, temp, topp = ints[:n].long(), ints[n:], flts[:n], flts[n:]
        if self._banned is not None:
            logits = logits.masked_fill(self._banned, float("-inf"))
        if cn is not None:
            logits = apply_token_mask(logits, *cn)
        toks = sample_tokens(logits, self._gen, temp, topk, topp, exact=cn is not None)
        self._d_last[idx] = toks
        self._d_temp[idx] = temp
        self._d_topk[idx] = topk
        self._d_topp[idx] = topp
        return toks

    def _round_fn(self, packed: torch.Tensor, tbl: torch.Tensor | None, *,
                  compact: bool) -> torch.Tensor:
        paged = None if tbl is None else {"tbl": tbl, "k": self._pool_k, "v": self._pool_v}
        return decode_round(
            self._mcfg, self.params, self._ck, self._cv,
            (self._d_last, self._d_temp, self._d_topk, self._d_topp), packed,
            steps=self.decode_chunk, compact=compact, paged=paged, banned=self._banned,
            generator=self._gen, arrivals=self._q8_arrivals,
        )

    def _dispatch_decode(self, active: list[int], group: _PrefillGroup | None):
        """Dispatch one decode round for `active` (no fetch), and the staged
        group fused behind it. Uncompacted, the whole batch runs (parked
        rows ride along and write nothing); compacted, a pow2 bucket Ba of
        the active rows (floor min(8, B)), each reading its cache row
        through `slot_ids`, and at Ba == B the uncompacted round. On the
        card the round is the graph of its (Ba, compact, paged) shape.
        Host lengths advance here, by K a row: the next dispatch stages
        the right positions before this round is fetched."""
        t0 = time.perf_counter()
        B, S, K = self.max_slots, self.max_seq_len, self.decode_chunk
        nact = len(active)
        self._last_active_n = nact
        Ba = pow2_bucket(nact, B, floor=min(8, B)) if self.decode_compact else B
        compact = Ba < B
        rid = self._rid_dispatched + 1
        if compact:
            ids = np.full(Ba, self._pad_row(active), dtype=np.int32)
            ids[:nact] = active
            lens_in = np.full(Ba, S, dtype=np.int32)
            lens_in[:nact] = self._lengths[active]
            packed = np.concatenate([lens_in, ids, [rid]]).astype(np.int32)
        else:
            lens = self._lengths
            cn_rows = [i for i, s in enumerate(self._slots) if s is not None and s.cn is not None]
            if cn_rows:
                # constrained rows decode only in their own masked rounds
                lens = lens.copy()
                lens[cn_rows] = S
            packed = np.concatenate([lens, [rid]]).astype(np.int32)
        tbl = self._paged_payload(active)  # the tables do not change in a round
        key = (Ba, compact, tbl is not None)
        phase = "decode" if group is None else ("fused" if group.bucket else "fused_rag")
        sample = ("decode", *key) in self._seen_exec_shapes and self._perf.should_sample(phase)
        ev = self._perf_events(sample)
        out = self._round_call(key, packed, tbl)
        disp = _DispatchedRound(out=out, done=None, entries=[
            (b, self._slots[b], i if compact else b) for i, b in enumerate(active)
        ], base=self._lengths.copy(), t0=t0, rid=rid)
        # the group's slots are mid-prefill, disjoint from the round's rows:
        # running it behind the round is the two dispatches' result
        if group is not None and self._launch_group(group):
            disp.prefill_tokens, disp.prefill_padded = group.n_tokens, group.padded
        self._perf_events_end(ev)
        if ev is not None:
            # host: staging and launches; the device wall is read at the
            # round's fetch, its one host sync
            disp.perf = (phase, ev, time.perf_counter() - t0, max(0.0, t0 - self._perf_mark),
                         nact * K, nact,
                         float(disp.base[active].mean()) if nact else 0.0)
        self._flight.event(phase, rid=rid, rows=nact, prefill_tokens=disp.prefill_tokens,
                           prefill_padded=disp.prefill_padded)
        if out.device.type == "cuda":
            # the graph's output is rewritten by its next replay: copy it out
            # behind the round, into pinned memory the fetch reads
            disp.out = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            disp.out.copy_(out, non_blocking=True)
            disp.done = torch.cuda.Event()
            disp.done.record()
        for b in active:
            self._lengths[b] = min(int(disp.base[b]) + K, S)
        # ledger: grow the tables to cover the advanced lengths
        self._paging.extend_many({b: int(self._lengths[b]) for b in active})
        self._rid_dispatched = rid
        self.compact_rounds += int(compact)
        return disp

    def _round_call(self, key: tuple, packed: np.ndarray, tbl: np.ndarray | None) -> torch.Tensor:
        """One decode round at key (Ba, compact, paged), op "decode": on the
        card the graph of the key (captured on its first use), on the CPU
        and under a mesh eager. A first use goes into the ledger: the
        graph's eager round and capture (`RoundGraphs.first_call_s`), or
        the eager round's wall."""
        first = self._note_exec_shape("decode", *key)
        t0 = time.perf_counter()
        out = self._dx("decode", key, packed, tbl)
        if first:
            wall = (time.perf_counter() - t0 if self._graphs is None
                    else self._graphs.first_call_s[key])
            self._compile_obs("decode", key, wall)
        return out

    # -- perf observatory sampling -------------------------------------------
    # A sampled dispatch is bracketed by two CUDA events on the engine's
    # stream, read after the host sync the dispatch already has (a round's
    # fetch, an eager phase's result): sampling adds no sync. On the CPU the
    # compute runs inside the call, so the bracket is two host stamps.

    def _perf_sample(self, phase: str, key: tuple) -> bool:
        """Sample this dispatch? Every Nth of its phase; a shape's first use
        is the ledger's, never a sample."""
        return (phase, *key) in self._seen_exec_shapes and self._perf.should_sample(phase)

    def _perf_events(self, sample: bool) -> list | None:
        if not sample:
            return None
        if self.device.type == "cuda":
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return [e, None]
        return [time.perf_counter(), None]

    def _perf_events_end(self, ev: list | None) -> None:
        if ev is None:
            return
        if isinstance(ev[0], float):
            ev[1] = time.perf_counter()
        else:
            ev[1] = torch.cuda.Event(enable_timing=True)
            ev[1].record()

    @staticmethod
    def _perf_device_s(ev: list) -> float:
        if isinstance(ev[0], float):
            return ev[1] - ev[0]
        return ev[0].elapsed_time(ev[1]) / 1e3

    def _observe_phase(self, phase: str, host_s: float, ev: list, wait_s: float, tokens: int,
                       rows: int, ctx_mean: float = 0.0) -> None:
        dev = self._perf_device_s(ev)
        self._perf.observe_phase(phase, host_s, dev, wait_s, tokens=tokens, rows=rows,
                                 ctx_mean=ctx_mean)
        self._flight.event("perf", phase=phase, host_ms=round(host_s * 1e3, 3),
                           device_ms=round(dev * 1e3, 3), wait_ms=round(wait_s * 1e3, 3),
                           rows=rows)

    def _observe_sync_phase(self, phase: str, t0: float, t_launch: float, ev: list, tokens: int,
                            rows: int, ctx_mean: float = 0.0) -> None:
        """A sampled synchronous dispatch, after its host sync."""
        self._observe_phase(phase, t_launch - t0, ev, max(0.0, t0 - self._perf_mark), tokens,
                            rows, ctx_mean)

    def _pad_row(self, rows: list[int]) -> int:
        """The cache row a compacted round's pad rows aim at (they are
        parked: w = S, the append writes nothing): one that is neither in
        the round nor mid-prefill, as in JAX."""
        B = self.max_slots
        in_round = set(rows)
        return next(
            (i for i in range(B) if self._slots[i] is None and i not in self._prefills),
            next((i for i in range(B) if self._slots[i] is None),
                 next(i for i in range(B) if i not in in_round)),
        )

    def _complete_round(self, disp: _DispatchedRound) -> _PendingRound:
        """Fetch a round (its one host sync) and feed the scheduler: a round
        that carried a group teaches its prefill cost over the decode
        round's (`observe_fused`), a plain one the decode round's. A quick
        scan applies emission's counter rules (EOS, `max_tokens`, the
        sequence cap; stop strings wait for emission) and frees the slots
        that finished, so the next dispatch leaves them out; emission,
        deferred, stays the authority on events and text."""
        if disp.done is not None:
            disp.done.synchronize()
        out = disp.out.numpy()
        self._last_round_ts = time.time()  # the decode-stall detector's cadence
        if disp.perf is not None:
            phase, ev, host_s, wait_s, tokens, rows, ctx = disp.perf
            self._observe_phase(phase, host_s, ev, wait_s, tokens, rows, ctx)
        self._perf_mark = time.perf_counter()
        dt = time.perf_counter() - disp.t0
        if disp.prefill_tokens:
            self._sched.observe_fused(dt, disp.prefill_tokens, padded_tokens=disp.prefill_padded)
        else:
            self._sched.observe_decode(dt)
        K, S = out.shape[0], self.max_seq_len
        eos = self.tokenizer.eos_id
        for b, s, col in disp.entries:
            if self._slots[b] is not s:
                continue  # freed (and perhaps admitted again) since dispatch
            if s.done:  # errored by the stall watchdog
                self._free_now(b)
                continue
            g, fin = s.generated, False
            base_b = int(disp.base[b])
            for k in range(K):
                if int(out[k, col]) == eos:
                    fin = True
                    break
                g += 1
                if g >= s.req.max_tokens or base_b + k + 1 + K > S:
                    fin = True
                    break
            if fin:
                self._free_now(b)
        self._rid_fetched = max(self._rid_fetched, disp.rid)
        return _PendingRound(out=out, entries=disp.entries, base=disp.base)

    def _emit_round(self, p: _PendingRound) -> None:
        for b, s, col in p.entries:
            if s.done:
                continue
            parts: list[str] = []
            finish = None
            gen_before = s.generated
            for k in range(p.out.shape[0]):
                emit, finish = self._process_token(s, int(p.out[k, col]), int(p.base[b]) + k)
                if emit:
                    parts.append(emit)
                if finish is not None:
                    break
            self._observe_itl(s, s.generated - gen_before)
            if parts:
                s.req.out.put({"type": "token", "text": "".join(parts)})
                if self._pool is not None:
                    s.last_emit = time.time()
            if finish is not None:
                self._finish_slot(b, s, finish)

    # -- speculation and constraints ----------------------------------------

    def _build_verify(self):
        """The verify round over the engine's caches and round state
        (`verify_round`), run eagerly."""
        def fn(packed: torch.Tensor, **kw):
            return verify_round(
                self._mcfg, self.params, self._ck, self._cv,
                (self._d_last, self._d_temp, self._d_topk, self._d_topp), packed,
                banned=self._banned, generator=self._gen, **kw,
            )
        return fn

    def _build_cn_step(self):
        """The constrained slots' masked single step (JAX's
        `_build_cn_step`): one compacted `decode_round` step with each
        row's automaton mask, run eagerly."""
        def fn(packed: torch.Tensor, paged: dict | None, cn: tuple) -> torch.Tensor:
            return decode_round(
                self._mcfg, self.params, self._ck, self._cv,
                (self._d_last, self._d_temp, self._d_topk, self._d_topp), packed,
                steps=1, compact=True, paged=paged, banned=self._banned, generator=self._gen,
                cn=cn, arrivals=self._q8_arrivals,
            )
        return fn

    def _stage_spec(self, active: list[int]) -> list[tuple[int, list[int]]] | None:
        """Drafts for a verify round, or None to keep the pipelined path.
        Every active slot joins (one without a draft verifies its single
        token), but the round runs only when a majority of them draft: it
        displaces a K-token decode round and drains the pipeline. Every
        row must have room for C = spec_k + 1 positions, or no round runs.
        A constrained slot's draft is cut to its longest legal prefix."""
        if not active:
            return None
        C = self.spec_k + 1
        entries: list[tuple[int, list[int]]] = []
        n_drafting = 0
        for b in active:
            s = self._slots[b]
            if s is None or s.spec is None:
                return None
            if int(self._lengths[b]) + C > self.max_seq_len:
                return None
            d = s.spec.draft(self.spec_k)
            if d and s.cn is not None:
                d = s.cn.filter_draft(d)
            if d:
                n_drafting += 1
            entries.append((b, d))
        if n_drafting == 0 or 2 * n_drafting < len(entries):
            return None
        return entries

    def _spec_round(self, entries: list[tuple[int, list[int]]]) -> None:
        """One verify round, synchronous (the pipeline is drained): pack
        the rows (A = pow2 rows, pads at slot B) into one i32 upload
        `[tokens (A*C) | slots | starts | nvalid | drafts (A*K) | ndraft |
        keep | wslot | wpos]`, run `verify_round` (op "verify", after a
        constrained round's token-ring writes, `_cn_ring`), fetch (n_acc,
        final), emit each row's accepted drafts and final token, and roll
        its length forward to the accepted position."""
        t0 = time.perf_counter()
        B, S, Kd = self.max_slots, self.max_seq_len, self.spec_k
        C = Kd + 1
        n = len(entries)
        A = 1 << (n - 1).bit_length()
        tokens = np.zeros((A, C), dtype=np.int32)  # column 0 comes from the ring
        slots = np.full(A, B, dtype=np.int32)
        starts = np.zeros(A, dtype=np.int32)
        nvalid = np.ones(A, dtype=np.int32)
        drafts = np.zeros((A, Kd), dtype=np.int32)
        ndraft = np.zeros(A, dtype=np.int32)
        for i, (b, d) in enumerate(entries):
            tokens[i, 1: 1 + len(d)] = d
            drafts[i, : len(d)] = d
            slots[i], starts[i] = b, self._lengths[b]
            nvalid[i], ndraft[i] = 1 + len(d), len(d)
        total = int(nvalid[:n].sum())
        skey = min(pow2_bucket(int(starts[:n].max()), S), S)
        # every live row writes its C positions (len + C <= S holds)
        keep = np.arange(n * C, dtype=np.int32)
        wslot = np.repeat(slots[:n], C)
        wpos = (starts[:n, None] + np.arange(C, dtype=np.int32)[None, :]).reshape(-1)
        packed = np.concatenate([tokens.reshape(-1), slots, starts, nvalid, drafts.reshape(-1),
                                 ndraft, keep, wslot, wpos]).astype(np.int32)
        cns = [self._slots[b].cn for b, _ in entries]
        cn = None
        if any(c is not None for c in cns):
            # per-position masks: row j constrains the token at draft offset
            # j; pad rows and positions stay all ones
            t_m = time.perf_counter()
            W = constrain.mask_words(self.cfg.vocab_size)
            masks = np.full((A, C, W), 0xFFFFFFFF, dtype=np.uint32)
            bids, bvals = self._bias_rows(A)
            for i, (b, d) in enumerate(entries):
                c = cns[i]
                if c is None:
                    continue
                rows = c.masks_for_draft(d)
                masks[i, : rows.shape[0]] = rows
                self._bias_row(c, bids[i], bvals[i])
            self.cn_mask_s += time.perf_counter() - t_m
            cn = (masks.view(np.int32), bids, bvals)
        key = (A, C, skey, self._phys is not None, cn is not None)
        sample = self._perf_sample("verify", key)
        first = self._note_exec_shape("verify", *key)
        if first:
            self._sync()
        t_call = time.perf_counter()
        ev = self._perf_events(sample)
        ring, self._cn_ring = self._cn_ring, None
        n_acc, final = self._dx("verify", packed, A, n, C, len(keep), skey,
                                self._paged_payload([b for b, _ in entries]), cn, ring)
        t_launch = time.perf_counter()
        self._perf_events_end(ev)
        n_acc, final = torch.stack([n_acc, final]).cpu().numpy()  # the round's host sync
        if first:
            self._compile_obs("verify", key, time.perf_counter() - t_call)
        elif sample:
            self._observe_sync_phase("verify", t0, t_launch, ev, total, n,
                                     float(starts[:n].mean()) if n else 0.0)
        self._sched.observe_verify(total, time.perf_counter() - t0)
        eos = self.tokenizer.eos_id
        drafted_round = accepted_round = 0
        grown: dict[int, int] = {}
        for i, (b, d) in enumerate(entries):
            s = self._slots[b]
            if s is None or s.done:
                continue
            na = min(int(n_acc[i]), len(d))
            base = int(starts[i])
            drafted_round += len(d)
            accepted_round += na
            s.spec_drafted += len(d)
            s.spec_accepted += na
            parts: list[str] = []
            finish = None
            gen_before = s.generated
            for j, tok in enumerate(list(d[:na]) + [int(final[i])]):
                emit, finish = self._process_token(s, int(tok), base + j)
                self.spec_emitted += int(tok) != eos  # `_process_token`'s count
                if emit:
                    parts.append(emit)
                if finish is not None:
                    break
            self._observe_itl(s, s.generated - gen_before)
            if parts:
                s.req.out.put({"type": "token", "text": "".join(parts)})
                if self._pool is not None:
                    s.last_emit = time.time()
            if finish is not None:
                self._finish_slot(b, s, finish)
            else:
                # the KV is valid through base + na; the final token's is
                # written by the slot's next round
                self._lengths[b] = base + 1 + na
                grown[b] = base + 1 + na
        if grown:
            self._paging.extend_many(grown)
        self.spec_calls += 1
        self.spec_drafted += drafted_round
        self.spec_accepted += accepted_round
        self._last_round_ts = time.time()  # verify rounds are cadence too
        self._flight.event("verify", rows=n, drafted=drafted_round, accepted=accepted_round)
        if cn is not None:
            self.cn_spec_drafted += drafted_round
            self.cn_spec_accepted += accepted_round
            self._flight.event("cn_spec", rows=n, drafted=drafted_round,
                               accepted=accepted_round)
        self._anomaly.signal("spec_collapse", drafted=drafted_round, accepted=accepted_round)
        if drafted_round and accepted_round * 4 < drafted_round:
            self._spec_cooldown = 50

    def _cn_attach(self, req: GenRequest) -> bool:
        """Compile the request's constraint and bias into its cursor
        (`req.cn`; cached by the spec's hash). A bad spec errors the
        request: False."""
        if self._constrain is None or not (req.constraint or req.logit_bias):
            return True
        before = self._constrain.stats_d["misses"]
        t0 = time.perf_counter()
        try:
            req.cn = self._constrain.make(req.constraint, req.logit_bias)
        except constrain.GrammarError as e:
            self._error(req, f"constraint: {e}")
            return False
        self.cn_requests += 1
        self._flight.event("cn_cmp", miss=self._constrain.stats_d["misses"] > before,
                           states=req.cn.cc.n_states() if req.cn.cc is not None else 0,
                           us=int((time.perf_counter() - t0) * 1e6))
        return True

    def _bias_rows(self, n_rows: int) -> tuple[np.ndarray, np.ndarray]:
        NB = self.cn_bias_max
        return (np.full((n_rows, NB), -1, dtype=np.int32),
                np.zeros((n_rows, NB), dtype=np.float32))

    def _bias_row(self, cn, ids: np.ndarray, vals: np.ndarray) -> None:
        nb = min(len(cn.bias_ids), self.cn_bias_max)
        ids[:nb] = cn.bias_ids[:nb]
        vals[:nb] = cn.bias_vals[:nb]

    def _cn_payload(self, cns: list, n_rows: int) -> tuple | None:
        """The mask operand of a round of `n_rows` rows, row i serving
        cursor cns[i] (None: unconstrained): (packed masks [n_rows, W] as
        int32, bias ids, bias values) on the host (the op uploads them), or
        None when nothing is constrained (the unmasked path runs). Pad and
        unconstrained rows get all-ones masks and no bias."""
        if not any(cn is not None for cn in cns):
            return None
        t0 = time.perf_counter()
        W = constrain.mask_words(self.cfg.vocab_size)
        masks = np.full((n_rows, W), 0xFFFFFFFF, dtype=np.uint32)
        bids, bvals = self._bias_rows(n_rows)
        for i, cn in enumerate(cns):
            if cn is not None:
                masks[i] = cn.mask_row()
                self._bias_row(cn, bids[i], bvals[i])
        self.cn_mask_s += time.perf_counter() - t0
        return masks.view(np.int32), bids, bvals

    def _cn_round(self, cn_active: list[int]) -> None:
        """One synchronous round for the constrained slots: a masked verify
        round when their filtered drafts compose (a majority drafts), else
        one masked decode step. Their ring entries are written first from
        the host (each cursor's last consumed token): a compacted round's
        pad rows may have aimed at one of these rows."""
        # the ring writes ride the round's own op ("verify" or "cnstep"),
        # and never outlive this round: a raise before the op leaves none
        # for a later round's rows
        self._cn_ring = (list(cn_active), [self._slots[b].cn.consumed[-1] for b in cn_active])
        try:
            if self._verify_fn is not None and self._spec_cooldown <= 0:
                entries = self._stage_spec(cn_active)
                if entries is not None:
                    self._spec_round(entries)
                    return
            self._cn_step_round(cn_active)
        finally:
            self._cn_ring = None

    def _cn_step_round(self, cn_active: list[int]) -> None:
        """One masked decode step for the constrained slots, compacted
        (`[lengths | slot_ids | counter]`, pads parked at a free row),
        each row's mask from its cursor's current state; the token is
        committed through `_process_token`, which advances the cursor for
        the next step's mask."""
        B, S = self.max_slots, self.max_seq_len
        n = len(cn_active)
        Ba = pow2_bucket(n, B, floor=min(8, B))
        ids = np.full(Ba, self._pad_row(cn_active) if Ba > n else 0, dtype=np.int32)
        ids[:n] = cn_active
        lens_in = np.full(Ba, S, dtype=np.int32)
        lens_in[:n] = self._lengths[cn_active]
        packed = np.concatenate([lens_in, ids, [0]]).astype(np.int32)
        t0 = time.perf_counter()
        cn = self._cn_payload([self._slots[b].cn for b in cn_active], Ba)
        key = (Ba, self._phys is not None)
        sample = self._perf_sample("cnstep", key)
        first = self._note_exec_shape("cnstep", *key)
        if first:
            self._sync()
        t_call = time.perf_counter()
        ev = self._perf_events(sample)
        ring, self._cn_ring = self._cn_ring, None
        out = self._dx("cnstep", packed, cn, self._paged_payload(cn_active), ring)
        t_launch = time.perf_counter()
        self._perf_events_end(ev)
        toks = out[0].cpu().numpy()  # synchronous: the step's host sync
        if first:
            self._compile_obs("cnstep", key, time.perf_counter() - t_call)
        elif sample:
            self._observe_sync_phase("cnstep", t0, t_launch, ev, n, n,
                                     float(lens_in[:n].mean()) if n else 0.0)
        grown: dict[int, int] = {}
        for i, b in enumerate(cn_active):
            s = self._slots[b]
            if s is None or s.done:
                continue
            pos = int(self._lengths[b])
            gen_before = s.generated
            emit, finish = self._process_token(s, int(toks[i]), pos)
            self._observe_itl(s, s.generated - gen_before)
            if emit:
                s.req.out.put({"type": "token", "text": emit})
                if self._pool is not None:
                    s.last_emit = time.time()
            if finish is not None:
                self._finish_slot(b, s, finish)
            else:
                self._lengths[b] = pos + 1
                grown[b] = pos + 1
        if grown:
            self._paging.extend_many(grown)
        self._last_round_ts = time.time()  # masked steps are cadence too
        self._flight.event("cnstep", rows=n)

    # -- admission ---------------------------------------------------------

    def _free_slot(self, reserved: set[int] = frozenset()) -> int | None:
        for i, s in enumerate(self._slots):
            if s is None and i not in self._prefills and i not in reserved:
                fence = self._cooling.get(i)
                if fence is not None:
                    if fence > self._rid_fetched:
                        continue  # a round in flight may still write it
                    del self._cooling[i]
                return i
        return None

    # -- KV pool: preemption with host offload ----------------------------------

    def _aging_s(self) -> float:
        """Seconds after which a waiter (the queue's head or a snapshot)
        overrides priority fairness: starvation is bounded both ways."""
        return RESTORE_AGING_TTFT_MULT * self.target_ttft_ms / 1000.0

    def _preempt_wanted(self) -> bool:
        """Preempt a slot for the queue's head? Only when no slot is free, a
        victim exists, the pool's guards pass, and the head outranks the
        lowest priority live stream or has waited past `_aging_s` (equal
        priorities shed at the API's watermark instead of thrashing)."""
        pool = self._pool
        if pool is None or self._admit.empty() or not pool.may_preempt():
            return False
        live = [s for s in self._slots if s is not None and not s.done]
        if not live or self._free_slot() is not None:
            return False
        try:
            head = self._admit.queue[0]  # the engine thread is the only consumer
        except IndexError:
            return False
        return head.priority > min(s.req.priority for s in live) or (
            time.time() - head.created_at > self._aging_s()
        )

    def _to_host(self, x: torch.Tensor) -> torch.Tensor:
        """A copy of `x` on the host: pinned and queued non-blocking on the
        card (the caller synchronises once for all of them)."""
        if x.device.type == "cpu":
            return x.clone()
        out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        out.copy_(x, non_blocking=True)
        return out

    def _snapshot_rows(self, b: int, end: int, start: int = 0) -> tuple[Any, Any]:
        """Host copies of slot b's committed rows [start, end) of every
        cache leaf: the seq axis is axis 3 in every layout, so one slice
        serves them all (`{}`, the fused int8 cache's V side, stays `{}`).
        start > 0 is the private-only snapshot of a prefix hit. When the
        range overlaps the slot's shared blocks, their arena rows are stale
        (the bytes live in the prefix pool): the range is read block by
        block through the table."""
        srcs = None
        bt = self._paging.block_tokens
        if self._phys is not None:
            _, sn = self._paging.table_view(b)
            if sn > 0 and start < sn * bt:
                srcs = self._phys.row_sources(b, -(-end // bt))
        return self._dx("snap", int(b), int(end), int(start), srcs)

    def _shared_pool_rows(self, b: int, p0: int) -> list[int] | None:
        """Pool rows behind slot b's shared blocks [0, p0), read from the
        live table before the slot is freed (the prefix entry may be
        evicted later, while the parked pins keep the rows alive). None
        without physical paging, or when a shared block is not pooled (a
        tripwire, counted)."""
        if self._phys is None or p0 <= 0:
            return None
        srcs = self._phys.row_sources(b, p0 // self._paging.block_tokens)
        if any(in_arena for in_arena, _, _ in srcs):
            self._phys.missing_pins += 1
            return None
        return [row for _, row, _ in srcs]

    def _sync_stream(self) -> None:
        """Wait for this engine's stream (the host copies queued on it)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _take_snapshot(self, b: int, s: _Slot) -> tuple[KVSnapshot, float]:
        """Slot b's committed rows and round state on the host, for a
        preemption or an export; the caller has made the host length exact
        (a drained pipeline, or a slot in no round in flight). A prefix
        hit snapshots only its private rows; an unaligned shared length's
        boundary block was copied on write into this slot's arena and
        nothing can rebuild it, so that snapshot is whole. Returns the
        snapshot (snap_id -1) and the wall of the copies."""
        L = int(self._lengths[b])
        t0 = time.perf_counter()
        p0 = s.shared_len if (0 < s.shared_len < L and s.shared_entry is not None) else 0
        if self._phys is not None and p0 % self._paging.block_tokens:
            p0 = 0
        pool_rows = self._shared_pool_rows(b, p0)
        k_rows, v_rows = self._snapshot_rows(b, L, start=p0)
        # the round state lives only on the device: one read (and the sync
        # that completes the row copies above)
        state = torch.stack([t[b].double() for t in (self._d_last, self._d_temp, self._d_topk,
                                                      self._d_topp)]).cpu().tolist()
        dt = time.perf_counter() - t0
        snap = KVSnapshot(
            req_id=s.req.request_id, priority=s.req.priority, length=L, bucket=L,
            last_tok=int(state[0]), temperature=state[1], top_k=int(state[2]), top_p=state[3],
            k_rows=k_rows, v_rows=v_rows, nbytes=pytree_nbytes(k_rows) + pytree_nbytes(v_rows),
            preempted_at=time.time(), slot_obj=s, shared_len=p0,
            shared_entry=s.shared_entry if p0 else None, shared_pool_rows=pool_rows,
        )
        return snap, dt

    def _preempt_one(self) -> bool:
        """Offload one victim slot to host memory and free it. The caller
        has drained the pipeline, so the host lengths are exact and the
        ring holds each slot's last token: the snapshot resumes token for
        token. The port copies exactly the committed rows (`memory.py`)."""
        pool = self._pool
        # SLO debt: a slot's surplus is its tenant's goodput ratio over the
        # worst-served tenant's, so the best-served tenant gives capacity
        # back first; with no tenants every surplus is 0.0 and the policy's
        # order is unchanged
        ratios = self._perf.tenant_goodput_ratios()
        floor_ratio = min(ratios.values()) if ratios else 0.0
        cands = [
            {"slot": b, "priority": s.req.priority,
             "last_activity": s.last_emit or s.first_token_at,
             "tokens_remaining": max(0, s.req.max_tokens - s.generated),
             "slo_surplus": (ratios.get(s.req.tenant, floor_ratio) - floor_ratio
                             if ratios and s.req.tenant else 0.0)}
            for b, s in enumerate(self._slots) if s is not None and not s.done
        ]
        victim = pool.pick_victim(cands)
        if victim is None:
            return False
        b = victim["slot"]
        s = self._slots[b]
        snap, dt = self._take_snapshot(b, s)
        L, p0 = snap.length, snap.shared_len
        snap_id = snap.snap_id = self._snap_ctr
        self._snap_ctr += 1
        pool.offload(snap, dt)
        if s.req.trace_ctx:
            tracing.get_tracer().record(
                "engine.preempt", snap.preempted_at - dt, snap.preempted_at,
                parent=s.req.trace_ctx,
                attrs={"request_id": s.req.request_id, "slot": b, "kv_tokens": L,
                       "offload_bytes": snap.nbytes, "policy": pool.policy})
        self._flight.event("preempt", trace_id=self._tid(s.req),
                           request_id=s.req.request_id[:8], slot=b, kv_tokens=L,
                           offload_bytes=snap.nbytes, wall_ms=round(dt * 1e3, 1))
        self._flight.event("offload", snap_id=snap_id, bytes=snap.nbytes, shared_len=p0)
        # ledger: park the shared pins under snap_id and free the private
        # tail, before `_free_now` drops the table; no round is in flight,
        # so the free sets no fence. No terminal event: the request waits.
        self._paging.preempt_slot(b, snap_id)
        self._free_now(b)
        log.info("preempted slot %d (req %s, %d tokens, %.1f MB) in %.1f ms",
                 b, s.req.request_id[:8], L, snap.nbytes / (1 << 20), dt * 1e3)
        return True

    def _restore_pending(self) -> bool:
        """Restore snapshots into free slots, highest priority and longest
        preempted first. A queued request of at least the snapshot's
        priority keeps its claim on the next free slot unless the snapshot
        has aged past `_aging_s` (the mirror of `_preempt_wanted`)."""
        pool = self._pool
        restored = False
        while pool.has_preempted():
            snap = pool.pop_restore()
            if snap is None:
                break
            s = snap.slot_obj
            if s is None or s.done:
                # its request ended: drop the rows and the parked pins
                self._paging.drop_snap(snap.snap_id)
                self._phys_sweep()
                continue
            aged = time.time() - snap.preempted_at > self._aging_s()
            try:
                head = self._admit.queue[0]
            except IndexError:
                head = None
            if head is not None and head.priority >= snap.priority and not aged:
                pool.requeue(snap)
                break
            slot = self._free_slot()
            if slot is None:
                pool.requeue(snap)
                break
            try:
                self._restore_snapshot(slot, snap)
            except Exception as e:
                log.exception("restore of a preempted slot failed")
                # the physical path may have re-tabled the pins already
                self._free_now(slot)
                self._paging.drop_snap(snap.snap_id)
                self._phys_sweep()
                s.done = True
                self._error(s.req, str(e))
                break
            restored = True
        return restored

    def _restore_snapshot(self, b: int, snap: KVSnapshot) -> None:
        """Write a snapshot back into slot b and activate it again. Every
        write goes into the existing storage (`copy_` into views, `fill_`
        of single elements): the captured round graphs read these buffers
        by address. In JAX's order: a physical prefix hit re-pins its
        shared blocks first, then the private rows are written, then the
        table row is rebuilt. A migrated-in snapshot pins a shared prefix
        through `admit_shared` (it has no parked pins here), and its rows
        past `length` (JAX's pow2 bucket) are dead and not written."""
        s = snap.slot_obj
        s.preempted_s += max(0.0, time.time() - snap.preempted_at)
        if s.cn is not None and not snap.migrated:
            # a fresh cursor from the raw spec, replayed over the consumed
            # ids: JAX's restore of a migrated snapshot (the slot's own
            # cursor, which rode along, ends in the same state); a migrated
            # one was rebuilt at its import
            cn = self._constrain.make(s.req.constraint, s.req.logit_bias)
            cn.replay(s.cn.consumed)
            s.cn = s.req.cn = cn
        self._sync()  # rounds in flight end first: the time below is the restore's
        t0 = time.perf_counter()
        start = snap.shared_len
        ledgered = False
        if start and snap.shared_entry is not None:
            ent = snap.shared_entry
            if "eid" in ent:  # a contiguous entry: its device rows back into [0, P)
                self._dx("insert", ent["eid"], [b], start)
            else:  # a physical one: re-pin, no rows move
                if snap.migrated:
                    ops = self._paging.admit_shared(b, snap.shared_key, snap.length)
                else:
                    ops = self._paging.restore_slot(b, snap.snap_id, snap.length)
                self._phys_admit(b, ent, ops)
                ledgered = True
        end = snap.length
        hk, hv = (_map(lambda r: r[:, :, :, : end - start], rows)
                  for rows in (snap.k_rows, snap.v_rows))
        if start:
            self._dx("insat", hk, hv, int(b), int(start))
        else:
            self._dx("insrows", hk, hv, [int(b)], int(end))
        # the round state, then the host side
        self._dx("samprow", int(b), float(snap.temperature), int(snap.top_k),
                 float(snap.top_p), int(snap.last_tok))
        self._lengths[b] = snap.length
        self._slots[b] = s
        if not ledgered:
            # the parked shared pins back into a table with a fresh private
            # tail (a migrated snapshot on a contiguous entry pins it as a
            # hit does); a whole physical snapshot re-keys its table row too
            if snap.migrated and start and snap.shared_key is not None:
                self._paging.admit_shared(b, snap.shared_key, snap.length)
            else:
                self._paging.restore_slot(b, snap.snap_id, snap.length)
            self._phys_rebuild(b)
        self._sync()  # the copies have run: their time is the restore's
        dt = time.perf_counter() - t0
        if self._pool is not None and not snap.migrated:
            self._pool.note_restored(snap, dt)
        kind = "migrate_in" if snap.migrated else "restore"
        self._flight.event(kind, trace_id=self._tid(s.req), request_id=s.req.request_id[:8],
                           slot=b, kv_tokens=snap.length, wall_ms=round(dt * 1e3, 1))
        if s.req.trace_ctx:
            now = time.time()
            tracing.get_tracer().record(
                f"engine.{kind}", now - dt, now, parent=s.req.trace_ctx,
                attrs={"request_id": s.req.request_id, "slot": b, "kv_tokens": snap.length,
                       "preempted_s": round(now - snap.preempted_at, 3),
                       **({"bytes": snap.nbytes} if snap.migrated else {})})

    # -- KV migration: engine-to-engine transfer (migration.py) ------------

    def _pool_rows_host(self, rows: list[int], p0: int) -> tuple[Any, Any]:
        """The prefix-pool rows `rows` gathered into one contiguous
        [L, 1, H, p0, ...] host tree per side (a physical entry keeps no
        row copies of its own)."""
        return self._dx("poolexp", [int(r) for r in rows], int(p0))

    def _wire_item(self, snap: KVSnapshot, source: str, t0: float | None = None) -> dict[str, Any]:
        """Serialize a host snapshot into an outbox item. A private-only
        snapshot ships its shared prefix as the entry's token key (the
        destination re-pins matching blocks of its own cache) plus the
        shared rows as a fallback for a destination that never saw the
        prefix. Records the engine.migrate_out span (from `t0`: an export
        at activation starts it before its snapshot's copy), the flight
        event and the counters."""
        s = snap.slot_obj
        req = s.req
        t0 = time.perf_counter() if t0 is None else t0
        shared_k = shared_v = None
        if snap.shared_len and snap.shared_entry is not None:
            ent = snap.shared_entry
            snap.shared_key = ent["key"]
            if "eid" in ent:
                shared_k, shared_v = self._dx("pfxexp", ent["eid"], int(ent["P"]))
            elif snap.shared_pool_rows is not None:
                shared_k, shared_v = self._pool_rows_host(list(snap.shared_pool_rows),
                                                          snap.shared_len)
            # else a tripwire: the key alone; only a destination holding the
            # entry can adopt it (any other fails the restore cleanly)
            self._sync_stream()
        header = migration.snapshot_header(snap, req, s)
        payload = migration.encode_payload(
            header, {"k": snap.k_rows, "v": snap.v_rows, "shared_k": shared_k,
                     "shared_v": shared_v})
        dt = time.perf_counter() - t0
        with self.stats_lock:
            self.migrated_out_total += 1
            self.migrate_out_bytes_total += len(payload)
        self._flight.event("migrate_out", trace_id=self._tid(req),
                           request_id=req.request_id[:8], kv_tokens=snap.length,
                           wire_bytes=len(payload), source=source)
        if req.trace_ctx:
            now = time.time()
            tracing.get_tracer().record(
                "engine.migrate_out", now - dt, now, parent=req.trace_ctx,
                attrs={"request_id": req.request_id, "kv_tokens": snap.length,
                       "bytes": len(payload), "source": source})
        log.info("migrate-out %s: %d tokens, %.1f KB (%s) in %.1f ms", req.request_id[:8],
                 snap.length, len(payload) / 1024, source, dt * 1e3)
        return {"payload": payload, "out": req.out, "req_id": req.request_id}

    def _migrate_export_slot(self, b: int, s: _Slot) -> None:
        """The disaggregated handoff, on the engine thread where slot b
        activates: its first token is emitted and its rows [0, P) and ring
        entry are written (a round carries only the slots active at its
        dispatch, and b activated after every round in flight was
        dispatched, so none of them writes it; the snapshot's read follows
        them on the stream). The slot is freed without a terminal event:
        the consumer stays blocked until the destination resumes emission
        into the same queue."""
        t0 = time.perf_counter()
        snap, _ = self._take_snapshot(b, s)
        item = self._wire_item(snap, source="prefill", t0=t0)
        self._free_now(b)
        self._migrate_outbox.put(item)

    def migrate_export_one(self) -> dict[str, Any] | None:
        """Coordinator drain hook: pop one offloaded snapshot from the pool
        and serialize it for transfer, on the engine thread (a shared
        prefix's fallback rows are read from the card). Its parked pins
        are dropped: the restore happens elsewhere."""
        if self._migrate_outbox is None or self._pool is None:
            return None
        box: dict[str, Any] = {}

        def run() -> None:
            snap = self._pool.pop_restore()
            if snap is None:
                return
            s = snap.slot_obj
            if s is not None and not s.done:
                box["item"] = self._wire_item(snap, source="pool")
            self._paging.drop_snap(snap.snap_id)
            self._phys_sweep()

        self._on_loop(run)
        return box.get("item")

    def migrate_steal_queued(self) -> GenRequest | None:
        """Coordinator drain hook: pop the oldest queued request. It holds
        no KV: re-homing it is a plain submit on the idle engine, with its
        consumer queue riding along on the request."""
        if self._migrate_outbox is None:
            return None
        try:
            return self._admit.get_nowait()
        except queue.Empty:
            return None

    def migrate_import(self, payload: bytes, out: "queue.Queue[Any] | None" = None) -> GenRequest:
        """Decode a wire payload (into pinned memory on the card) and queue
        its snapshot for restore on the engine loop. `out` re-homes an
        existing consumer queue; None makes a fresh one. Returns the
        reconstructed request. Raises when migration is off or the payload
        cannot run here; the caller errors the original consumer."""
        if self._migrate_in is None:
            raise RuntimeError("KV migration disabled (TPU_MIGRATE=0)")
        if self._stop_evt.is_set() or self.stalled:
            raise RuntimeError("engine unavailable for migrate-in")
        header, snap = migration.wire_to_snapshot(payload, pin=self.device.type == "cuda")
        if snap.bucket > self.max_seq_len:
            raise ValueError(f"snapshot bucket {snap.bucket} exceeds destination "
                             f"max_seq_len {self.max_seq_len}")
        req = GenRequest(
            prompt_ids=[int(t) for t in header["prompt_ids"]],
            max_tokens=int(header["max_tokens"]),
            temperature=snap.temperature,
            top_k=snap.top_k,
            top_p=snap.top_p,
            stop=list(header.get("stop") or []),
            priority=snap.priority,
            request_id=snap.req_id,
            created_at=float(header.get("created_at") or time.time()),
            trace_ctx=header.get("trace_ctx") or "",
            migrations=int(header.get("migrations") or 0) + 1,
            constraint=header.get("constraint"),
            logit_bias=header.get("logit_bias"),
        )
        if out is not None:
            req.out = out
        now = time.time()
        s = _Slot(
            req=req,
            generated=int(header.get("generated") or 0),
            text=header.get("text") or "",
            pending=base64.b64decode(header.get("pending_b64") or ""),
            prompt_len=int(header.get("prompt_len") or len(req.prompt_ids)),
            first_token_at=now,
            last_emit=now,
        )
        snap.slot_obj = s
        # each import is one hop: the ping-pong detector fires when the
        # drain shuttles the same request back and forth
        self._anomaly.signal("migration_pingpong", request_id=req.request_id)
        self._migrate_in.put((snap, header, len(payload), s))
        self._wake.set()
        return req

    def migrate_import_stream(self, payload: bytes) -> Iterator[dict[str, Any]]:
        """Import, then yield the resumed request's events until terminal
        (the transfer endpoint's adapter)."""
        req = self.migrate_import(payload)
        while True:
            evt = req.out.get()
            if evt is _DONE:
                return
            yield evt
            if evt.get("type") == "done":
                return

    def _migrate_restore_pending(self) -> bool:
        """Engine thread: restore migrated-in snapshots into free slots, in
        arrival order; an item stays queued while no slot is free (the
        engine thread is the inbox's only consumer)."""
        restored = False
        while not self._migrate_in.empty():
            slot = self._free_slot()
            if slot is None:
                break
            try:
                snap, header, nbytes, s = self._migrate_in.get_nowait()
            except queue.Empty:
                break
            snap.snap_id = self._snap_ctr
            self._snap_ctr += 1
            if snap.shared_len:
                # the same key at the same stored length in our own cache:
                # adopt the local entry, whose blocks re-pin; else fold the
                # shipped fallback rows into a whole snapshot
                ent = (self._prefix_cache.get(snap.shared_key)
                       if snap.shared_key is not None else None)
                if ent is not None and int(ent["P"]) == snap.shared_len:
                    snap.shared_entry = ent
                    self._prefix_cache.move_to_end(snap.shared_key)
                else:
                    try:
                        migration.flatten_to_whole_bucket(snap)
                    except ValueError as e:
                        s.done = True
                        self._error(s.req, str(e))
                        continue
            if self._constrain is not None and (header.get("constraint")
                                                or header.get("logit_bias")):
                # the automaton from the raw spec, here (the compile cache is
                # the engine thread's), replayed over the consumed ids
                try:
                    s.req.cn = self._constrain.make(header.get("constraint"),
                                                    header.get("logit_bias"))
                except constrain.GrammarError as e:
                    s.done = True
                    self._error(s.req, f"constraint: {e}")
                    continue
                self.cn_requests += 1
                s.req.cn.replay([int(t) for t in header.get("cn_tokens") or []])
                s.cn = s.req.cn
            try:
                self._restore_snapshot(slot, snap)
            except Exception as e:
                log.exception("migrate-in restore failed")
                self._free_now(slot)
                self._paging.drop_snap(snap.snap_id)
                self._phys_sweep()
                s.done = True
                self._error(s.req, str(e))
                break
            with self.stats_lock:
                self.migrated_in_total += 1
                self.migrate_in_bytes_total += int(nbytes)
            restored = True
        return restored

    def migration_stats(self) -> dict[str, float]:
        """Cumulative migration counters; {"enabled": 0.0} with
        TPU_MIGRATE off (as `memory_stats`)."""
        if self._migrate_outbox is None:
            return {"enabled": 0.0}
        with self.stats_lock:
            return {
                "enabled": 1.0,
                "migrated_out_total": float(self.migrated_out_total),
                "migrated_in_total": float(self.migrated_in_total),
                "migrate_out_bytes_total": float(self.migrate_out_bytes_total),
                "migrate_in_bytes_total": float(self.migrate_in_bytes_total),
                "outbox_depth": float(self._migrate_outbox.qsize()),
                "inbox_depth": float(self._migrate_in.qsize()),
            }

    def _admit_pending(self) -> bool:
        admitted = False
        if self._migrate_in is not None and not self._migrate_in.empty():
            # migrated-in snapshots first: their prefill was spent on another
            # engine and their consumers have waited since
            admitted = self._migrate_restore_pending()
        if not self._prefix_rpc_in.empty():
            # parked prefix exports and imports: only the engine thread
            # touches the prefix cache and the pool
            self._drain_prefix_rpc()
        if self._pool is not None and self._pool.has_preempted():
            # snapshots re-enter ahead of the queue (under the fairness rule
            # in `_restore_pending`): their prefill is spent
            admitted = self._restore_pending() or admitted
        while True:
            batch: list[tuple[int, GenRequest, list[int]]] = []
            # prefix-cache hits grouped by entry
            hits: dict[int, tuple[dict, list]] = {}
            reserved: set[int] = set()
            while len(batch) < self.admit_batch:
                slot = self._free_slot(reserved)
                if slot is None:
                    break
                try:
                    req = self._admit.get_nowait()
                except queue.Empty:
                    break
                req.admitted_at = time.time()
                ids = req.prompt_ids
                # leave room for at least one decode chunk after the prompt
                max_prompt = self.max_seq_len - self.decode_chunk
                if len(ids) > max_prompt:  # keep the tail
                    ids = ids[-max_prompt:]
                if req.max_tokens <= 0:
                    req.out.put({
                        "type": "done",
                        "finish_reason": "length",
                        "usage": {
                            "prompt_tokens": len(ids),
                            "completion_tokens": 0,
                            "total_tokens": len(ids),
                        },
                        "ttft_ms": 0.0,
                    })
                    req.out.put(_DONE)
                    continue
                admitted = True
                if not self._cn_attach(req):
                    continue  # a bad constraint spec: the request is errored
                ent = self._match_prefix(ids)
                if ent is not None:
                    # cached prefix: only the suffix prefills, in ragged chunks
                    reserved.add(slot)
                    hits.setdefault(id(ent), (ent, []))[1].append((slot, req, list(ids)))
                    continue
                if self.prefill_chunk and len(ids) > self.prefill_chunk:
                    # long prompt: reserve the slot, prefill chunk by chunk;
                    # the ledger commits the prompt's blocks now
                    self._prefills[slot] = _PrefillState(req=req, ids=list(ids))
                    self._prefill_q.append(slot)
                    self._paging.admit_slot(slot, len(ids))
                    continue
                reserved.add(slot)
                batch.append((slot, req, list(ids)))
            for ent, group in hits.values():
                try:
                    self._start_cached(ent, group)
                except Exception as e:
                    log.exception("prefix-cache admission failed")
                    for slot, req, _ in group:
                        if self._prefills.pop(slot, None) is not None:
                            self._prefill_q.remove(slot)
                        self._paging.free_slot(slot)
                        self._phys_reset(slot)
                        self._error(req, str(e))
            if not batch:
                if hits:
                    continue  # hit slots consumed; more of the queue may admit
                break
            try:
                self._start_batch(batch)
            except Exception as e:
                log.exception("prefill failed")
                for slot, req, _ in batch:
                    s = self._slots[slot]
                    if s is not None and s.req is req:
                        self._free_now(slot)
                    self._error(req, str(e))
            if len(batch) < self.admit_batch:
                break
        return admitted

    def _start_batch(self, batch: list[tuple[int, GenRequest, list[int]]]) -> None:
        """Prefill up to admit_batch short prompts in one batch, insert
        their K/V into their slots and sample their first tokens."""
        t0 = time.perf_counter()
        A = len(batch)
        Ab = 1 << (A - 1).bit_length()  # pow2 rows: pad rows are 1 harmless token
        bucket = fine_bucket(max(len(ids) for _, _, ids in batch), self.max_seq_len)
        tokens = np.zeros((Ab, bucket), dtype=np.int32)
        lengths = np.ones((Ab,), dtype=np.int32)
        for i, (_, _, ids) in enumerate(batch):
            tokens[i, : len(ids)] = ids
            lengths[i] = len(ids)
        sample = self._perf_sample("admit", (Ab, bucket))
        t_launch = time.perf_counter()
        ev = self._perf_events(sample)
        ints, flts, cn = self._samp_payload([slot for slot, _, _ in batch],
                                            [req for _, req, _ in batch])
        # op "admit": prefill, inserts and the first tokens; its first use
        # at a shape is timed into the ledger
        toks0 = self._first_use("admit", tokens.shape, lambda: self._dx(
            "admit", tokens, lengths, ints, flts, cn))
        self._perf_events_end(ev)
        toks0 = toks0.cpu().numpy()  # the host sync
        n_tok = sum(len(ids) for _, _, ids in batch)
        if sample:
            self._observe_sync_phase("admit", t0, t_launch, ev, n_tok, A)
        # latency waterfall: the admission's synchronous wall, by token share
        wall = time.perf_counter() - t0
        for i, (slot, req, ids) in enumerate(batch):
            self._activate_state(slot, req, ids, int(toks0[i]))
            s = self._slots[slot]
            if s is not None:
                s.prefill_compute_s += wall * (len(ids) / max(1, n_tok))

    def _prefill_call(self, tokens: np.ndarray, lengths: np.ndarray) -> tuple:
        """A warm-up admit's prefill at [Ab, bucket], its K/V and logits
        dropped: nothing is written (one rank only: the warm-up is off
        under a mesh). Its first use is timed into the ledger."""
        return self._first_use(
            "admit", tokens.shape, lambda: llama_prefill(
                self._mcfg, self.params, self._up(tokens), self._up(lengths),
                quant_kv=self.kv_quant == "int8"))

    def _activate_state(
        self, slot: int, req: GenRequest, ids: list[int], tok0: int, shared_len: int = 0,
        shared_entry: dict | None = None, prefill_s: float = 0.0,
    ) -> None:
        P = len(ids)
        # the slot's rows [0, P) now hold exactly this prompt's KV: the
        # moment to learn a shared prefix for later admissions
        self._maybe_store_prefix(slot, ids)
        self._recent_prompts.append(tuple(ids))
        # ledger: batch admissions get their table here; the chunked and
        # hit paths reserved one already (ensure extends it)
        mgr = self._paging
        mgr.ensure_slot(slot, P)
        want = min(P + max(0, req.max_tokens) + self.decode_chunk, self.max_seq_len)
        mgr.note_admit_cost(mgr.blocks_for(want) - shared_len // mgr.block_tokens)
        s = _Slot(req=req, prompt_len=P, first_token_at=time.time(),
                  shared_entry=shared_entry if shared_len else None, shared_len=shared_len,
                  cn=req.cn)
        # chunk walls attributed while mid-prefill (latency waterfall)
        s.prefill_compute_s += prefill_s
        ttft_ms = (s.first_token_at - req.created_at) * 1000.0
        with self.stats_lock:
            self.total_requests += 1
            self._ttft_window.append((s.first_token_at, ttft_ms))
        self._flight.event("admit", trace_id=self._tid(req), request_id=req.request_id[:8],
                           slot=slot, prompt_tokens=P, ttft_ms=round(ttft_ms, 1))
        self._anomaly.signal("ttft_burn", ttft_ms=ttft_ms)
        if req.trace_ctx:
            # the caller's trace gets engine.admit (submit to pop) and
            # engine.prefill (pop to first token), from host stamps
            tracer = tracing.get_tracer()
            admitted = req.admitted_at or req.created_at
            tracer.record("engine.admit", req.created_at, admitted, parent=req.trace_ctx,
                          attrs={"request_id": req.request_id})
            tracer.record("engine.prefill", admitted, s.first_token_at, parent=req.trace_ctx,
                          attrs={"request_id": req.request_id, "prompt_tokens": P,
                                 "ttft_ms": round((s.first_token_at - req.created_at) * 1000.0, 1),
                                 "prefill_token_budget": self._sched.last_budget,
                                 "sched_starved_rounds": self._sched.starved_rounds})
        if self._verify_fn is not None:
            # the drafter starts from the prompt; every emitted token joins it
            s.spec = NGramDrafter(self.spec_min_ngram, self.spec_max_ngram)
            s.spec.extend(ids)
        self._slots[slot] = s
        self._lengths[slot] = P  # tok0 is in the token ring already (`_sample_rows`)
        # tok0's K/V is written at position P by the first decode round
        emit, finish = self._process_token(s, tok0, P - 1)
        if emit:
            req.out.put({"type": "token", "text": emit})
        if finish is not None:
            self._finish_slot(slot, s, finish)
        elif self._migrate_outbox is not None and (req.migrate_after_prefill
                                                   or self.migrate_after_prefill):
            # the disaggregated handoff: this engine spent the prefill and
            # emitted the first token; a decode-role peer continues
            self._migrate_export_slot(slot, s)

    # -- chunked (ragged) prefill ------------------------------------------

    def _prefill_backlog(self) -> int:
        return sum(len(st.ids) - st.done for st in self._prefills.values())

    def _stage_group(self, n_active: int, reserved: int = 0) -> _PrefillGroup | None:
        """Stage this iteration's chunk group: ragged, or bucketed for the
        families the ragged path does not cover."""
        if self.ragged_prefill:
            return self._stage_ragged_group(n_active, reserved)
        return self._stage_bucketed_group(n_active, reserved)

    def _chunk_budget(self, n_active: int, reserved: int) -> int:
        """The scheduler's prefill budget for this iteration, less the
        `reserved` tokens a verify round takes (0: no group)."""
        if not self._prefill_q:
            return 0
        oldest = min(self._prefills[s].req.created_at for s in self._prefill_q)
        return self._sched.decide(self._prefill_backlog(), n_active, time.time() - oldest,
                                  reserved_tokens=reserved)

    def _chunk_shape(self, slot: int, cap: int = 0) -> tuple[int, int, int, int]:
        """(start, n, bucket, skey) of a mid-prefill slot's next bucketed
        chunk, as the JAX engine's `_chunk_shape`: n at most `cap` (> 0),
        the bucket its pow2 ceiling, never past the cache row's end, and
        skey the pow2 bound of the past keys (128 for a first chunk)."""
        st = self._prefills[slot]
        start = st.done
        n = min(self.prefill_chunk, len(st.ids) - start)
        if cap > 0:
            n = min(n, cap)
        bucket = min(pow2_bucket(n, self.prefill_chunk), self.max_seq_len - start)
        skey = (min(pow2_bucket(start, self.max_seq_len), self.max_seq_len) if start
                else min(128, self.max_seq_len))
        return start, n, bucket, skey

    def _stage_bucketed_group(self, n_active: int, reserved: int = 0) -> _PrefillGroup | None:
        """The JAX engine's bucketed staging: the first queued slot's chunk
        sets (bucket, skey), and up to admit_batch - 1 more slots join
        whose next chunks share the skey and fit the bucket; rows pad to a
        pow2 count. The write targets are every position of each real row's
        bucket (the ones past n are overwritten later, as in JAX)."""
        budget = self._chunk_budget(n_active, reserved)
        if budget <= 0:
            return None
        B, S = self.max_slots, self.max_seq_len
        first = self._prefill_q[0]
        _, f_n, f_bucket, f_skey = self._chunk_shape(first, cap=budget)
        group, used = [first], f_n
        for slot in list(self._prefill_q)[1:]:
            if len(group) >= self.admit_batch or used >= budget:
                break
            start2, n2, _, s2 = self._chunk_shape(slot, cap=min(budget - used, f_bucket))
            if s2 == f_skey and n2 > 0 and start2 + f_bucket <= S:
                group.append(slot)
                used += n2
        Ab = 1 << (len(group) - 1).bit_length()
        tokens = np.zeros((Ab, f_bucket), dtype=np.int32)
        slots = np.full((Ab,), B, dtype=np.int32)  # pads: slot B, no writes
        starts = np.zeros((Ab,), dtype=np.int32)
        nvalid = np.ones((Ab,), dtype=np.int32)
        metas, keep, wslot, wpos = [], [], [], []
        total, rem = 0, budget
        for i, slot in enumerate(group):
            st = self._prefills[slot]
            start, n, _, _ = self._chunk_shape(slot, cap=min(rem, f_bucket) if i else budget)
            tokens[i, :n] = st.ids[start: start + n]
            slots[i], starts[i], nvalid[i] = slot, start, n
            metas.append((slot, st, n))
            keep.append(np.arange(i * f_bucket, (i + 1) * f_bucket))
            wslot.append(np.full(f_bucket, slot))
            wpos.append(np.arange(start, start + f_bucket))
            total += n
            rem -= n
        cat = (lambda xs: np.concatenate(xs).astype(np.int32))
        return _PrefillGroup(
            metas=metas, tokens=tokens, rowids=None, positions=None, slots=slots,
            starts=starts, last_idx=None, n_tokens=total, keep=cat(keep), wslot=cat(wslot),
            wpos=cat(wpos), nvalid=nvalid, bucket=f_bucket, skey=f_skey,
        )

    def _stage_ragged_group(self, n_active: int, reserved: int = 0) -> _PrefillGroup | None:
        """Pack up to admit_batch mid-prefill slots' next chunks back to
        back into one [T] buffer under the scheduler's budget, less the
        `reserved` tokens a verify round takes this iteration."""
        budget = self._chunk_budget(n_active, reserved)
        if budget <= 0:
            return None
        R = self.admit_batch
        S = self.max_seq_len
        cap = min(budget, self._ragged_cap)
        picked: list[tuple[int, _PrefillState, int, int]] = []
        used = 0
        for slot in list(self._prefill_q):
            if len(picked) >= R or used >= cap:
                break
            st = self._prefills[slot]
            n = min(self.prefill_chunk, len(st.ids) - st.done, cap - used)
            if n <= 0:
                continue
            picked.append((slot, st, st.done, n))
            used += n
        if not picked:
            return None
        T = pow2_bucket(used, self._ragged_cap, floor=min(32, self._ragged_cap))
        tokens = np.zeros((T,), dtype=np.int32)
        rowids = np.full((T,), R, dtype=np.int32)  # pads: row R
        positions = np.full((T,), S, dtype=np.int32)  # pads: position S
        slots = np.zeros((R,), dtype=np.int32)
        starts = np.zeros((R,), dtype=np.int32)
        last_idx = np.zeros((R,), dtype=np.int32)
        wslot = np.zeros((used,), dtype=np.int32)
        metas = []
        off = 0
        for i, (slot, st, start, n) in enumerate(picked):
            tokens[off: off + n] = st.ids[start: start + n]
            rowids[off: off + n] = i
            positions[off: off + n] = np.arange(start, start + n)
            wslot[off: off + n] = slot
            slots[i] = slot
            starts[i] = start
            last_idx[i] = off + n - 1
            metas.append((slot, st, n))
            off += n
        # every real token writes (prompts end before S); pads write nothing
        return _PrefillGroup(
            metas=metas, tokens=tokens, rowids=rowids, positions=positions,
            slots=slots, starts=starts, last_idx=last_idx, n_tokens=used,
            keep=np.arange(used, dtype=np.int32), wslot=wslot, wpos=positions[:used].copy(),
        )

    def _upload_parts(self, parts: tuple) -> list[torch.Tensor]:
        """One packed i32 upload of host arrays; a view of it for each."""
        packed = self._up(np.concatenate(parts))
        views, off = [], 0
        for a in parts:
            views.append(packed[off: off + len(a)])
            off += len(a)
        return views

    def _launch_group(self, group: _PrefillGroup) -> bool:
        """Enqueue a staged group's chunk (no host sync): its descriptors
        and write targets go up as one packed i32 upload, and its
        last-token logits stay on the device, parked under the group's gid
        (ops "ragged" / "chunk"). A ragged group runs
        `llama_prefill_chunk_ragged`, a bucketed one
        `llama_prefill_chunk_batch`. False when it failed (its requests are
        errored)."""
        try:
            self._group_call(group, self._paged_payload([slot for slot, _, _ in group.metas]))
            group.launched = True
            return True
        except Exception as e:
            self._fail_group(group, e)
            return False

    def _group_key(self, group: _PrefillGroup) -> tuple[str, tuple]:
        """The ledger's (phase, key) of a group: ("chunk", (rows, bucket,
        skey, phys)) or ("pf_rag", (T, 0, phys)); the ragged kernels take no
        past-key bound."""
        phys = self._phys is not None
        if group.bucket:
            return "chunk", (group.tokens.shape[0], group.bucket, group.skey, phys)
        return "pf_rag", (group.padded, 0, phys)

    def _group_call(self, group: _PrefillGroup, tbl: np.ndarray | None) -> None:
        """Enqueue a group's chunk (raises on failure), its logits parked
        under a fresh gid; its first use at a shape is timed into the
        ledger."""
        phase, key = self._group_key(group)
        self._gid_ctr += 1
        group.gid = self._gid_ctr
        self._first_use(phase, key, self._group_launch, group, tbl)

    def _group_launch(self, group: _PrefillGroup, tbl: np.ndarray | None) -> None:
        if group.bucket:
            self._dx("chunk", group.gid, group.tokens, group.slots, group.starts, group.nvalid,
                     group.keep, group.wslot, group.wpos, group.skey, tbl)
        else:
            self._dx("ragged", group.gid, group.tokens, group.rowids, group.positions,
                     group.slots, group.starts, group.last_idx, group.keep, group.wslot,
                     group.wpos, tbl)

    def _run_prefill_group(self, group: _PrefillGroup) -> None:
        """A group with no decode round to ride: run it alone and time it
        (the scheduler's per-token prefill cost), then activate."""
        t0 = time.perf_counter()
        phase, key = self._group_key(group)
        sample = self._perf_sample(phase, key)
        ev = self._perf_events(sample)
        if not self._launch_group(group):
            return
        t_launch = time.perf_counter()
        self._perf_events_end(ev)
        self._sync()
        wall = time.perf_counter() - t0
        if sample:
            self._observe_phase(phase, t_launch - t0, ev, max(0.0, t0 - self._perf_mark),
                                group.n_tokens, len(group.metas))
        self._sched.observe_prefill(group.n_tokens, wall, padded_tokens=group.padded)
        # latency waterfall: the synchronous wall, by valid-token share
        for _, st, n in group.metas:
            st.prefill_s += wall * (n / max(1, group.n_tokens))
        if group.bucket:
            self._flight.event("chunk", rows=len(group.metas), tokens=group.n_tokens,
                               bucket=group.bucket, wall_ms=round(wall * 1e3, 2))
        else:
            self._flight.event("pf_rag", rows=len(group.metas), tokens=group.n_tokens,
                               packed=group.padded, wall_ms=round(wall * 1e3, 2))
        self._finish_prefill_group(group)

    def _finish_prefill_group(self, group: _PrefillGroup) -> None:
        """Advance chunk progress of a dispatched group and activate the
        prompts whose last chunk landed, sampling their first tokens from
        the group's logits."""
        if not group.launched:
            return  # the launch failed
        try:
            fin = []
            for i, (slot, st, n) in enumerate(group.metas):
                st.done += n
                if st.done >= len(st.ids):
                    fin.append((i, slot, st))
            # op "bsample" releases the parked logits whether a row finished
            # or not
            ints, flts, cn = self._samp_payload([slot for _, slot, _ in fin],
                                                [st.req for _, _, st in fin])
            toks0 = self._dx("bsample", group.gid, [i for i, _, _ in fin], ints, flts, cn)
            if fin:
                toks0 = toks0.cpu().numpy()
            for k, (_, slot, st) in enumerate(fin):
                self._prefill_q.remove(slot)
                del self._prefills[slot]
                self._activate_state(slot, st.req, st.ids, int(toks0[k]), st.shared_len,
                                     st.shared_entry, st.prefill_s)
        except Exception as e:
            self._fail_group(group, e)
        group.launched = False

    def _fail_group(self, group: _PrefillGroup, e: Exception) -> None:
        log.exception("chunked prefill failed")
        for slot, st, _ in group.metas:
            if self._prefills.pop(slot, None) is not None:
                self._prefill_q.remove(slot)
                self._paging.free_slot(slot)  # reserved, not activated
                self._phys_reset(slot)
                self._error(st.req, str(e))

    # -- emission ----------------------------------------------------------

    def _process_token(self, s: _Slot, tok: int, pos: int) -> tuple[str, str | None]:
        """Advance one slot by one token: (text to emit, finish_reason | None).
        `pos` is the cache position the token's K/V occupies."""
        req = s.req
        finish = None
        emit = ""
        cut = -1
        if s.cn is not None:
            # every emission path passes here: the cursor consumes the token
            # so the next mask reflects it
            self.cn_tokens += 1
            if not s.cn.advance(tok):
                self.cn_illegal += 1
        if tok == self.tokenizer.eos_id:
            finish = "stop"
        else:
            s.generated += 1
            # no lock: the engine thread is the only writer
            self.total_tokens += 1
            if s.spec is not None:
                s.spec.append(tok)
            text, s.pending = self.tokenizer.decode_stream(s.pending, [tok])
            # stop sequences trim before emission; scan the window where a
            # stop could straddle the old/new text boundary
            prev_len = len(s.text)
            total = s.text + text
            for stop_s in req.stop:
                if not stop_s:
                    continue
                i = total.find(stop_s, max(0, prev_len - len(stop_s) + 1))
                if i != -1 and (cut == -1 or i < cut):
                    cut = i
            if cut != -1:
                emit = total[prev_len:cut]
                s.text = total[:cut]
                finish = "stop"
            else:
                emit = text
                s.text = total
            if finish is None and s.generated >= req.max_tokens:
                finish = "length"
            if finish is None and pos + 1 + self.decode_chunk > self.max_seq_len:
                finish = "length"
        if finish is not None and s.pending:
            if cut == -1:
                emit += self.tokenizer.decode_flush(s.pending)
            s.pending = b""
        return emit, finish

    def _finish_slot(self, slot: int, s: _Slot, finish: str) -> None:
        req = s.req
        s.done = True
        # counters first: a caller the events unblock sees them moved
        with self.stats_lock:
            self.finished_requests += 1
            self.finished_tokens += s.generated
        if s.cn is not None and s.cn.constrained:
            # a constrained stream ending anywhere but an accepting state
            # produced an incomplete document (cut by max_tokens, say)
            self.cn_finished += 1
            if s.cn.accepting:
                self.cn_finished_accepting += 1
        ttft_ms = (s.first_token_at - req.created_at) * 1000.0
        itl_mean_ms = s.itl_s_total / s.itl_samples * 1e3 if s.itl_samples else 0.0
        if s.first_token_at:
            # goodput: the request against the joint TTFT + ITL SLO, in its
            # tenant's ledger too
            self._perf.finish_request(ttft_ms, itl_mean_ms, s.generated, tenant=req.tenant)
        if req.tenant:
            # prompt plus generated tokens drain the tenant's bucket
            self._sched.tenant_charge(req.tenant, s.prompt_len + s.generated)
        # recorded before the done event: a caller it unblocks sees the trace
        if req.trace_ctx and s.first_token_at:
            now = time.time()
            attrs = {"request_id": req.request_id, "completion_tokens": s.generated,
                     "output_tokens": s.generated,
                     "tok_per_s": round(s.generated / max(now - s.first_token_at, 1e-9), 1),
                     "itl_mean_ms": round(itl_mean_ms, 2),
                     "finish_reason": finish}
            if s.spec is not None:
                attrs["spec_drafted"] = s.spec_drafted
                attrs["spec_accepted"] = s.spec_accepted
            if s.cn is not None and s.cn.constrained:
                attrs["cn_accepting"] = bool(s.cn.accepting)
            tracing.get_tracer().record("engine.decode", s.first_token_at, now,
                                        parent=req.trace_ctx, attrs=attrs)
        self._observe_finish(req, s, finish)
        req.out.put({
            "type": "done",
            "finish_reason": finish,
            "usage": {
                "prompt_tokens": s.prompt_len,
                "completion_tokens": s.generated,
                "total_tokens": s.prompt_len + s.generated,
            },
            "ttft_ms": (s.first_token_at - req.created_at) * 1000.0,
        })
        req.out.put(_DONE)
        if self._slots[slot] is s:
            self._free_now(slot)

    @staticmethod
    def _tid(req: GenRequest) -> str:
        """The request's 32-hex trace id for flight events ("" untraced)."""
        ids = tracing.parse_traceparent(req.trace_ctx)
        return ids[0] if ids else ""

    def _observe_itl(self, s: _Slot, n_new: int) -> None:
        """One emission round's tokens into the slot's token timeline: the
        gap since its previous emission (its first token for the first
        round), shared evenly by the round's tokens (they were learned at
        one fetch). The part of a gap past TPU_WATERFALL_STALL_MS is the
        waterfall's stall."""
        if n_new <= 0:
            return
        now = time.time()
        gap = max(0.0, now - (s.perf_last_emit or s.first_token_at or now))
        itl = self._perf.observe_itl(gap, n_new)
        s.perf_last_emit = now
        s.itl_s_total += gap
        s.itl_samples += n_new
        thr = workload.stall_threshold_s()
        if gap > thr:
            s.stall_s += gap - thr
        self._anomaly.signal("itl_degradation", itl_ms=itl * 1e3)

    def _observe_finish(self, req: GenRequest, s: _Slot, finish: str) -> None:
        """The latency waterfall's exact partition of the request's wall
        (accumulated stage walls clamped into their windows, residuals in
        prefill_queue and decode) and its workload record (prefix-chain
        head hashes from routing/prefix.py, raw ids only behind
        TPU_WORKLOAD_IDS=1)."""
        fin_ts = time.time()
        admitted = req.admitted_at or req.created_at
        admit_wait = max(0.0, admitted - req.created_at)
        ft = s.first_token_at or admitted
        pf_window = max(0.0, ft - admitted)
        pf_compute = min(max(0.0, s.prefill_compute_s), pf_window)
        dec_window = max(0.0, fin_ts - ft)
        preempt = min(max(0.0, s.preempted_s), dec_window)
        stall = min(max(0.0, s.stall_s), dec_window - preempt)
        shed = max(0.0, req.shed_wait_s)
        stages = {
            "admit_wait": admit_wait,
            "shed": shed,
            "prefill_queue": pf_window - pf_compute,
            "prefill_compute": pf_compute,
            "decode": dec_window - preempt - stall,
            "stall": stall,
            "preempt": preempt,
        }
        total_s = admit_wait + shed + pf_window + dec_window
        tid = self._tid(req)
        self._waterfall.observe(stages, total_s, trace_id=tid, rid=req.request_id[:8],
                                ts=req.created_at)
        self._flight.event("wf", trace_id=tid, request_id=req.request_id[:8],
                           total_ms=round(total_s * 1e3, 2),
                           **{f"{k}_ms": round(v * 1e3, 2) for k, v in stages.items()})
        if self._workload.enabled():
            chain = chain_hashes(req.prompt_ids, self._paging.block_tokens)[: workload.CHAIN_HEAD]
            self._workload.record(
                ts=req.created_at, rid=req.request_id, trace_id=tid, model=self.cfg.name,
                prompt_tokens=len(req.prompt_ids), chain=chain, max_tokens=req.max_tokens,
                temperature=req.temperature, top_k=req.top_k, top_p=req.top_p,
                output_tokens=s.generated, finish=finish, ids=req.prompt_ids, shed_s=shed,
            )
            self._flight.event("wl", trace_id=tid, request_id=req.request_id[:8],
                               prompt_tokens=len(req.prompt_ids), output_tokens=s.generated,
                               finish=finish)

    def _free_now(self, b: int) -> None:
        """Park a slot; while rounds are in flight it cools until each has
        been fetched (`_free_slot`)."""
        self._slots[b] = None
        self._lengths[b] = self.max_seq_len  # park
        # ledger: drop the table (idempotent); its device row back to identity
        self._paging.free_slot(b)
        self._phys_reset(b)
        if self._rid_dispatched > self._rid_fetched:
            self._cooling[b] = self._rid_dispatched

    def _error(self, req: GenRequest, msg: str) -> None:
        with self.stats_lock:
            self.total_errors += 1
        req.out.put({"type": "error", "error": msg})
        req.out.put(_DONE)

    def _abort_all(self, msg: str) -> None:
        """Error every live, mid-prefill and queued request. Every slot and
        ledger table is released before the first error goes out, so a
        caller that sees the error sees the engine's state settled."""
        failed = []
        for b, s in enumerate(self._slots):
            if s is not None and not s.done:
                s.done = True
                failed.append(s.req)
            self._free_now(b)
        for slot in list(self._prefills):
            self._paging.free_slot(slot)
            self._phys_reset(slot)
            failed.append(self._prefills.pop(slot).req)
        self._prefill_q.clear()
        if self._pool is not None:
            # offloaded snapshots wait on a restore that will not come
            for snap in self._pool.drain():
                self._paging.drop_snap(snap.snap_id)
                s = snap.slot_obj
                if s is not None and not s.done:
                    s.done = True
                    failed.append(s.req)
            self._phys_sweep()
        while True:
            try:
                failed.append(self._admit.get_nowait())
            except queue.Empty:
                break
        for req in failed:
            self._error(req, msg)


# ---------------------------------------------------------------------------
# SliceEngine: the multi-rank spelling of the one engine (JAX's). The
# leader/follower behaviour lives in the GSPMDBackend dispatch seam alone;
# this is the constructor that wires it, with JAX's keyword surface.
# ---------------------------------------------------------------------------

SliceRequest = GenRequest


class SliceEngine(GenerationEngine):
    """`GenerationEngine` over a `GSPMDBackend`. Build it in every rank
    with the same arguments and that rank's `mesh`
    (`parallel.distributed.make_global_mesh`); `.start()` on rank 0,
    `.run_follower()` on every other rank (both inherited). Keeps JAX's
    keyword surface: `cmd_addr`, `connect_timeout_s`, the strict
    quant-with-checkpoint error and the `max_slots % dp` check."""

    def __init__(
        self,
        model: str | ModelConfig = "tiny-llm",
        *,
        mesh: Any,
        cmd_addr: str,
        max_slots: int = 8,
        max_seq_len: int = 256,
        dtype: torch.dtype = torch.bfloat16,
        decode_chunk: int = 8,
        quant: str = "",
        weights_dir: str = "",
        tokenizer: Tokenizer | None = None,
        seed: int = 0,
        connect_timeout_s: float = 60.0,
        prefill_chunk: int = 0,
        target_ttft_ms: float = 2000.0,
        **engine_kw: Any,
    ):
        if quant not in ("", "int8") and weights_dir:
            # the engine downgrades an unknown quant mode to a warning; a
            # multi-rank boot must not serve other bytes than asked on
            # every rank
            raise NotImplementedError(
                f"slice engine quant={quant!r} with a checkpoint (only 'int8' is supported)")
        if mesh is not None:
            dp = mesh.shape.get("dp", 1)
            if max_slots % max(dp, 1) != 0:
                raise ValueError(f"max_slots {max_slots} must divide over dp={dp}")
        super().__init__(
            model,
            mesh=mesh,
            backend=GSPMDBackend(cmd_addr, connect_timeout_s=connect_timeout_s,
                                 world_size=mesh.world if mesh is not None else None),
            max_slots=max_slots,
            max_seq_len=max_seq_len,
            dtype=dtype,
            decode_chunk=decode_chunk,
            quant=quant,
            weights_dir=weights_dir,
            tokenizer=tokenizer,
            seed=seed,
            prefill_chunk=prefill_chunk,
            target_ttft_ms=target_ttft_ms,
            **engine_kw,
        )
        self.process_index = mesh.rank if mesh is not None else 0
        self.process_count = mesh.world if mesh is not None else 1
        self.is_leader = self.process_index == 0
