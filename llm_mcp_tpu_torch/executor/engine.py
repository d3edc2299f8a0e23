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

Not ported yet (ROADMAP queue 1): migration (and its constraint state), the
fleet prefix tier, the model zoo, tenants, the flight recorder and its
preempt/restore spans, capture of the ragged group and of the verify and
masked rounds.
"""

from __future__ import annotations

import functools
import logging
import os
import queue
import threading
import time
import uuid
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Iterator

import numpy as np
import torch

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
from ..models.quant import (
    fuse_layer_weights,
    gemm_layout,
    init_llama_params_quantized,
    quantize_params,
)
from ..ops.sampling import apply_token_mask, sample_tokens, spec_verify
from ..utils.device import resolve_device
from ..utils.locks import OrderedLock
from .common import fine_bucket, pow2_bucket
from .drafter import NGramDrafter
from .graphs import RoundGraphs
from .memory import RESTORE_AGING_TTFT_MULT, KVPool, KVSnapshot, pytree_nbytes
from .paging import PagedKVManager
from .physical import PhysicalPool, pool_like
from .scheduler import TokenBudgetScheduler
from .tokenizer import Tokenizer, load_tokenizer

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
        "families, and at most 8 query heads a KV head); the head_dim-32 arms are left to "
        "ROADMAP queue 2. Serve it on the CPU (device=\"cpu\")"
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
            cfg, params, cache_k, cache_v, toks, lens, slot_ids=slot_ids, paged=paged
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


@dataclass
class _PrefillState:
    """A slot whose prompt is mid-way through chunked prefill."""

    req: GenRequest
    ids: list[int]
    done: int = 0  # tokens already written into the cache
    shared_len: int = 0  # prefix-cache hit: tokens of the entry it starts with
    shared_entry: Any = None  # and the entry, carried onto the live slot


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
    logits: torch.Tensor | None = None  # [R, V], once dispatched
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
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        # a config.json beside the weights describes them and wins over the
        # catalog, as in the JAX engine
        self.cfg = resolve_config(model, weights_dir)
        if self.cfg.arch == "encoder":
            raise ValueError(f"{self.cfg.name} is an encoder: it serves embeddings "
                             "(EmbeddingEngine), not generation")
        if self.device.type == "cuda":
            _check_kernel_shapes(self.cfg)
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
        self.decode_compact = dc == "on" or (dc == "auto" and self.kv_quant == "int8")
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
        )
        # packed-buffer capacity: the pow2 floor of a full group's tokens
        cap = max(self.admit_batch * self.prefill_chunk, 1)
        self._ragged_cap = 1 << (cap.bit_length() - 1)
        # ragged chunks, as the JAX engine gates them: not for windows or
        # softcaps, which no ragged kernel covers; those stage bucketed groups
        self.ragged_prefill = not plain_attention(self.cfg)

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
        if self.quant:
            # a no-op on an int8 tree; then the single-device fused layout,
            # stored K-contiguous for the int8 GEMM
            params = gemm_layout(fuse_layer_weights(quantize_params(params)))
        self.params = params
        cache = init_kv_cache(self.cfg, max_slots, max_seq_len, dtype=dtype, device=self.device,
                              quantized=self.kv_quant == "int8")
        self._ck, self._cv = cache["k"], cache["v"]
        self._init_prefix_cache(prompt_cache_mb)

        # The KV pool (memory.py), as the JAX engine builds it: only with
        # TPU_KV_HOST_OFFLOAD on; every use is guarded by `is not None`, so
        # off is a true no-op.
        self._pool: KVPool | None = None
        if os.environ.get("TPU_KV_HOST_OFFLOAD", "0") not in ("", "0", "false", "no", "off"):
            self._pool = KVPool(
                max_slots=max_slots,
                max_seq_len=max_seq_len,
                bytes_per_slot=pytree_nbytes({"k": self._ck, "v": self._cv}) // max(1, max_slots),
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
        # the decode round as one CUDA graph a static shape; the CPU has none
        self.cuda_graphs = bool(cuda_graphs) and self.device.type == "cuda"
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

        self._admit: "queue.Queue[GenRequest]" = queue.Queue()
        self._wake = threading.Event()
        self._stop_evt = threading.Event()
        self._thread: threading.Thread | None = None

    # -- public surface ----------------------------------------------------

    def start(self) -> "GenerationEngine":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, name="gen-engine", daemon=True)
            self._thread.start()
        return self

    def shutdown(self) -> None:
        """Stop the loop, error every request still held (queued, live or
        offloaded), and free the round graphs and their memory pool; the
        caches and weights go with the engine object."""
        self._stop_evt.set()
        self._wake.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=30)
        self._abort_all("engine shutdown")
        if self._graphs is not None and (thread is None or not thread.is_alive()):
            self._graphs.release()  # no replay can be running any more

    def submit(self, req: GenRequest) -> GenRequest:
        if self._stop_evt.is_set():
            req.out.put({"type": "error", "error": "engine shutdown"})
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
        constraint: dict | None = None,
        logit_bias: list | None = None,
    ) -> Iterator[dict[str, Any]]:
        """Yield {"type":"token","text":...} events then a final
        {"type":"done", "usage":..., "finish_reason":..., "ttft_ms":...}.
        `constraint` and `logit_bias` as in `GenRequest`."""
        req = GenRequest(
            prompt_ids=self.tokenizer.encode(prompt),
            max_tokens=max_tokens,
            temperature=temperature,
            top_k=top_k,
            top_p=top_p,
            stop=stop or [],
            priority=int(priority),
            constraint=constraint,
            logit_bias=logit_bias,
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

    def admission_state(self) -> tuple[bool, float]:
        """(shed, retry_after_s) for the API's load-shedding gate: shed
        while the offered load is at the watermark, with the scheduler's
        drain estimate for the queue and the held snapshots, clamped to
        [1, 600] s. Side-effect free; (False, 0.0) without a pool."""
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

    def note_shed(self, n: int = 1) -> None:
        """The API shed `n` requests on this engine's behalf (a 429)."""
        if self._pool is not None:
            self._pool.note_shed(n)

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
        # the pytree byte count, as JAX's: the same budget gives the same
        # prefix partition and pool rows
        cache_bytes = _nbytes(self._ck, self._cv)
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

    def _paged_operand(self, slots) -> dict | None:
        """The model's `paged` operand when any of `slots` reads a block
        through the pool (decided on the host from the tables), else None:
        the unpaged kernels then run."""
        if self._phys is None or not self._phys.paged(slots):
            return None
        return {"tbl": self._phys.device_table(self.device), "k": self._pool_k, "v": self._pool_v}

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
        if "k" in ent:
            for slot, _, _ in group:
                _map(lambda c, e: c[:, slot, :, :P].copy_(e[:, 0]), self._ck, ent["k"])
                _map(lambda c, e: c[:, slot, :, :P].copy_(e[:, 0]), self._cv, ent["v"])
        for slot, req, ids in group:
            self._prefills[slot] = _PrefillState(req=req, ids=list(ids), done=P, shared_len=P,
                                                 shared_entry=ent)
            self._prefill_q.append(slot)
            ops = self._paging.admit_shared(slot, ent["key"], len(ids))
            if "k" not in ent:
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
        # the entry's bytes: every leaf's per-(row, token) bytes times p0
        nbytes = sum(x.numel() // (x.shape[1] * x.shape[3]) * p0 * x.element_size()
                     for x in _leaves(self._ck, self._cv))
        if self._phys is not None:
            if not self._store_prefix_physical(slot, key):
                self._paging.prefix_release(key)
                self._phys.sweep(self._paging.alive)
                return
            ent = {"P": p0, "bytes": nbytes, "key": key}
        else:
            ent = {
                "P": p0, "bytes": nbytes, "key": key,
                "k": _map(lambda c: c[:, slot: slot + 1, :, :p0].clone(), self._ck),
                "v": _map(lambda c: c[:, slot: slot + 1, :, :p0].clone(), self._cv),
            }
        self._prefix_cache[key] = ent
        self._prefix_by_len.setdefault(p0, {})[key] = ent
        self._prefix_cache_bytes += nbytes
        while self._prefix_cache_bytes > self._prefix_budget and self._prefix_cache:
            self._evict_lru_prefix()
        log.info("prefix cache: stored a %d-token prefix (%d entries)", p0, len(self._prefix_cache))

    def _evict_lru_prefix(self) -> None:
        """Evict the least recently used entry. Its pool rows are reclaimed
        only once no table pins its blocks any more."""
        old_key, old = self._prefix_cache.popitem(last=False)
        self._prefix_cache_bytes -= old["bytes"]
        self._paging.prefix_release(old["key"])
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
            self._cow_block(slot, ent["P"] // self._paging.block_tokens, phys - self._phys.pool_base)
            self._phys.cow_copies_total += 1
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
            self._phys.rebuild(slot, ids, shared_n)

    def _phys_sweep(self) -> None:
        """Reclaim pool rows after pins were dropped without a table change
        (a snapshot's parked pins)."""
        if self._phys is not None:
            self._phys.sweep(self._paging.alive)

    def _phys_reset(self, slot: int) -> None:
        """Slot released: its table row back to identity, then reclaim the
        pool rows whose ledger ids just died."""
        if self._phys is not None:
            self._phys.reset(slot)
            self._phys.sweep(self._paging.alive)

    # Device block copies, in place on the engine's stream (the JAX
    # engine's `_cow_block_raw`, `_pool_put_arena_raw`, `_pool_put_pool_raw`),
    # over every leaf: a fused int8 block moves all its payload heads (the
    # packed pseudo-head too) and its plain scales together.

    def _cow_block(self, slot: int, blk: int, prow: int) -> None:
        """Pool row `prow` into block `blk` of the slot's arena row."""
        bt = self._paging.block_tokens
        for c, p in ((self._ck, self._pool_k), (self._cv, self._pool_v)):
            _map(lambda a, b: a[:, slot, :, blk * bt: (blk + 1) * bt].copy_(b[:, prow]), c, p)

    def _pool_put_arena(self, row: int, off: int, prow: int) -> None:
        """One block of arena row `row` at token offset `off` into pool row `prow`."""
        bt = self._paging.block_tokens
        for c, p in ((self._ck, self._pool_k), (self._cv, self._pool_v)):
            _map(lambda a, b: b[:, prow].copy_(a[:, row, :, off: off + bt]), c, p)

    def _pool_put_pool(self, src: int, dst: int) -> None:
        for p in _leaves(self._pool_k, self._pool_v):
            p[:, dst] = p[:, src]

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
        while self._prefix_cache:
            self._evict_lru_prefix()
        if self._phys is not None:
            for x in _leaves(self._pool_k, self._pool_v):
                x.zero_()
            self._phys.reset_all()

    # -- engine loop -------------------------------------------------------

    def _run(self) -> None:
        with torch.inference_mode():
            while not self._stop_evt.is_set():
                try:
                    busy = self._step()
                except Exception as e:  # a failed dispatch must not hang waiters
                    log.exception("engine step failed")
                    self._recover(f"engine step failed: {e}")
                    busy = False
                if not busy:
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
            try:
                self._drain()  # in-flight rounds' consumers get their tokens
            except Exception as e:  # pragma: no cover - the device failed at shutdown
                log.exception("in-flight rounds lost at shutdown")
                self._recover(f"engine step failed: {e}")

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
        if active:
            self._inflight.append(self._dispatch_decode(active, group))
            if group is not None:
                self._finish_prefill_group(group)
        elif group is not None:
            self._run_prefill_group(group)  # nothing to fuse with
        if self._pending is not None:
            pending, self._pending = self._pending, None
            self._emit_round(pending)
        admitted = self._admit_pending()
        if self._inflight and (len(self._inflight) >= self.pipeline_depth or not active):
            self._pending = self._complete_round(self._inflight.popleft())
            return True
        return bool(active or cn_active or group is not None or admitted or self._inflight)

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
        state and error every request."""
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
            torch.cuda.synchronize(self.device)

    def _sample_first(self, logits: torch.Tensor, slots: list[int], reqs: list) -> np.ndarray:
        """Activation: sample each prompt's first token from its logits and
        write it and the request's sampling parameters into the device
        round state at its slot (JAX's `op_bsample`); a constrained
        request's first token is masked by its automaton and bias. Returns
        the tokens on the host, for emission: a host sync."""
        n = len(slots)
        cn = self._cn_payload([r.cn for r in reqs], n)
        ints = self._up(np.asarray(slots + [r.top_k for r in reqs], dtype=np.int32))
        flts = self._up(np.asarray([r.temperature for r in reqs] + [r.top_p for r in reqs],
                                   dtype=np.float32))
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
        return toks.cpu().numpy()

    def _round_fn(self, packed: torch.Tensor, tbl: torch.Tensor | None, *,
                  compact: bool) -> torch.Tensor:
        paged = None if tbl is None else {"tbl": tbl, "k": self._pool_k, "v": self._pool_v}
        return decode_round(
            self.cfg, self.params, self._ck, self._cv,
            (self._d_last, self._d_temp, self._d_topk, self._d_topp), packed,
            steps=self.decode_chunk, compact=compact, paged=paged, banned=self._banned,
            generator=self._gen,
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
        paged = self._phys is not None and self._phys.paged(active)
        # the tables do not change in a round
        tbl = self._phys.device_table(self.device) if paged else None
        fn = functools.partial(self._round_fn, compact=compact)
        if self._graphs is None:
            out = fn(self._up(packed), tbl)
        else:
            out = self._graphs.run((Ba, compact, paged), fn, (self._up(packed), tbl))
        disp = _DispatchedRound(out=out, done=None, entries=[
            (b, self._slots[b], i if compact else b) for i, b in enumerate(active)
        ], base=self._lengths.copy(), t0=t0, rid=rid)
        # the group's slots are mid-prefill, disjoint from the round's rows:
        # running it behind the round is the two dispatches' result
        if group is not None and self._launch_group(group):
            disp.prefill_tokens, disp.prefill_padded = group.n_tokens, group.padded
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
            for k in range(p.out.shape[0]):
                emit, finish = self._process_token(s, int(p.out[k, col]), int(p.base[b]) + k)
                if emit:
                    parts.append(emit)
                if finish is not None:
                    break
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
                self.cfg, self.params, self._ck, self._cv,
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
                self.cfg, self.params, self._ck, self._cv,
                (self._d_last, self._d_temp, self._d_topk, self._d_topp), packed,
                steps=1, compact=True, paged=paged, banned=self._banned, generator=self._gen,
                cn=cn,
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
        keep | wslot | wpos]`, run `verify_round`, fetch (n_acc, final),
        emit each row's accepted drafts and final token, and roll its
        length forward to the accepted position."""
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
            cn = (self._up(masks.view(np.int32)), self._up(bids), self._up(bvals))
        n_acc, final = self._verify_fn(
            self._up(packed), rows=A, n=n, width=C, n_writes=len(keep), skey=skey,
            paged=self._paged_operand([b for b, _ in entries]), cn=cn,
        )
        n_acc, final = torch.stack([n_acc, final]).cpu().numpy()  # the round's host sync
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
            for j, tok in enumerate(list(d[:na]) + [int(final[i])]):
                emit, finish = self._process_token(s, int(tok), base + j)
                self.spec_emitted += int(tok) != eos  # `_process_token`'s count
                if emit:
                    parts.append(emit)
                if finish is not None:
                    break
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
        if cn is not None:
            self.cn_spec_drafted += drafted_round
            self.cn_spec_accepted += accepted_round
        if drafted_round and accepted_round * 4 < drafted_round:
            self._spec_cooldown = 50

    def _cn_attach(self, req: GenRequest) -> bool:
        """Compile the request's constraint and bias into its cursor
        (`req.cn`; cached by the spec's hash). A bad spec errors the
        request: False."""
        if self._constrain is None or not (req.constraint or req.logit_bias):
            return True
        try:
            req.cn = self._constrain.make(req.constraint, req.logit_bias)
        except constrain.GrammarError as e:
            self._error(req, f"constraint: {e}")
            return False
        self.cn_requests += 1
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
        int32, bias ids, bias values) on the device, or None when nothing
        is constrained (the unmasked path runs). Pad and unconstrained
        rows get all-ones masks and no bias."""
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
        return self._up(masks.view(np.int32)), self._up(bids), self._up(bvals)

    def _cn_round(self, cn_active: list[int]) -> None:
        """One synchronous round for the constrained slots: a masked verify
        round when their filtered drafts compose (a majority drafts), else
        one masked decode step. Their ring entries are written first from
        the host (each cursor's last consumed token): a compacted round's
        pad rows may have aimed at one of these rows."""
        last = [self._slots[b].cn.consumed[-1] for b in cn_active]
        self._d_last[self._up(np.asarray(cn_active, dtype=np.int64))] = self._up(
            np.asarray(last, dtype=np.int32))
        if self._verify_fn is not None and self._spec_cooldown <= 0:
            entries = self._stage_spec(cn_active)
            if entries is not None:
                self._spec_round(entries)
                return
        self._cn_step_round(cn_active)

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
        cn = self._cn_payload([self._slots[b].cn for b in cn_active], Ba)
        if self._cn_step_fn is None:
            self._cn_step_fn = self._build_cn_step()
        out = self._cn_step_fn(self._up(packed), self._paged_operand(cn_active), cn)
        toks = out[0].cpu().numpy()  # synchronous: the step's host sync
        grown: dict[int, int] = {}
        for i, b in enumerate(cn_active):
            s = self._slots[b]
            if s is None or s.done:
                continue
            pos = int(self._lengths[b])
            emit, finish = self._process_token(s, int(toks[i]), pos)
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

        def cut(arr, pool):
            if isinstance(arr, dict):
                return {k: cut(arr[k], None if pool is None else pool[k]) for k in arr}
            if srcs is None:
                return self._to_host(arr[:, b: b + 1, :, start:end])
            parts = [arr[:, row: row + 1, :, off: off + bt] if in_arena else pool[:, row: row + 1]
                     for in_arena, row, off in srcs]
            return self._to_host(torch.cat(parts, dim=3)[:, :, :, start:end])

        return cut(self._ck, self._pool_k), cut(self._cv, self._pool_v)

    def _preempt_one(self) -> bool:
        """Offload one victim slot to host memory and free it. The caller
        has drained the pipeline, so the host lengths are exact and the
        ring holds each slot's last token: the snapshot resumes token for
        token. The port copies exactly the committed rows (`memory.py`)."""
        pool = self._pool
        cands = [
            {"slot": b, "priority": s.req.priority,
             "last_activity": s.last_emit or s.first_token_at,
             "tokens_remaining": max(0, s.req.max_tokens - s.generated)}
            for b, s in enumerate(self._slots) if s is not None and not s.done
        ]
        victim = pool.pick_victim(cands)
        if victim is None:
            return False
        b = victim["slot"]
        s = self._slots[b]
        L = int(self._lengths[b])
        t0 = time.perf_counter()
        # a prefix hit snapshots only its private rows; an unaligned shared
        # length's boundary block was copied on write into this slot's arena
        # and nothing can rebuild it, so that snapshot is whole
        p0 = s.shared_len if (0 < s.shared_len < L and s.shared_entry is not None) else 0
        if self._phys is not None and p0 % self._paging.block_tokens:
            p0 = 0
        k_rows, v_rows = self._snapshot_rows(b, L, start=p0)
        # the round state lives only on the device: one read (and the sync
        # that completes the row copies above)
        state = torch.stack([t[b].double() for t in (self._d_last, self._d_temp, self._d_topk,
                                                      self._d_topp)]).cpu().tolist()
        dt = time.perf_counter() - t0
        snap_id = self._snap_ctr
        self._snap_ctr += 1
        snap = KVSnapshot(
            req_id=s.req.request_id, priority=s.req.priority, length=L, bucket=L,
            last_tok=int(state[0]), temperature=state[1], top_k=int(state[2]), top_p=state[3],
            k_rows=k_rows, v_rows=v_rows, nbytes=pytree_nbytes(k_rows) + pytree_nbytes(v_rows),
            preempted_at=time.time(), slot_obj=s, snap_id=snap_id, shared_len=p0,
            shared_entry=s.shared_entry if p0 else None,
        )
        pool.offload(snap, dt)
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
        table row is rebuilt."""
        s = snap.slot_obj
        s.preempted_s += max(0.0, time.time() - snap.preempted_at)
        if s.cn is not None:
            # a fresh cursor from the raw spec, replayed over the consumed
            # ids: JAX's restore of a migrated snapshot (the slot's own
            # cursor, which rode along, ends in the same state)
            cn = self._constrain.make(s.req.constraint, s.req.logit_bias)
            cn.replay(s.cn.consumed)
            s.cn = s.req.cn = cn
        self._sync()  # rounds in flight end first: the time below is the restore's
        t0 = time.perf_counter()
        start = snap.shared_len
        ledgered = False
        if start and snap.shared_entry is not None:
            ent = snap.shared_entry
            if "k" in ent:  # a contiguous entry: its device rows back into [0, P)
                _map(lambda c, e: c[:, b, :, :start].copy_(e[:, 0]), self._ck, ent["k"])
                _map(lambda c, e: c[:, b, :, :start].copy_(e[:, 0]), self._cv, ent["v"])
            else:  # a physical one: re-pin, no rows move
                ops = self._paging.restore_slot(b, snap.snap_id, snap.length)
                self._phys_admit(b, ent, ops)
                ledgered = True
        end = snap.length
        for c, rows in ((self._ck, snap.k_rows), (self._cv, snap.v_rows)):
            _map(lambda x, r: x[:, b: b + 1, :, start:end].copy_(r, non_blocking=True), c, rows)
        # the round state (JAX's `samprow`), then the host side
        self._d_last[b] = snap.last_tok
        self._d_temp[b] = snap.temperature
        self._d_topk[b] = snap.top_k
        self._d_topp[b] = snap.top_p
        self._lengths[b] = snap.length
        self._slots[b] = s
        if not ledgered:
            # the parked shared pins back into a table with a fresh private
            # tail; a whole physical snapshot re-keys its table row too
            self._paging.restore_slot(b, snap.snap_id, snap.length)
            self._phys_rebuild(b)
        self._sync()  # the copies have run: their time is the restore's
        self._pool.note_restored(snap, time.perf_counter() - t0)

    def _admit_pending(self) -> bool:
        admitted = False
        if self._pool is not None and self._pool.has_preempted():
            # snapshots re-enter ahead of the queue (under the fairness rule
            # in `_restore_pending`): their prefill is spent
            admitted = self._restore_pending()
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
        A = len(batch)
        Ab = 1 << (A - 1).bit_length()  # pow2 rows: pad rows are 1 harmless token
        bucket = fine_bucket(max(len(ids) for _, _, ids in batch), self.max_seq_len)
        tokens = np.zeros((Ab, bucket), dtype=np.int32)
        lengths = np.ones((Ab,), dtype=np.int32)
        for i, (_, _, ids) in enumerate(batch):
            tokens[i, : len(ids)] = ids
            lengths[i] = len(ids)
        logits, ks, vs = llama_prefill(self.cfg, self.params, self._up(tokens), self._up(lengths),
                                       quant_kv=self.kv_quant == "int8")
        for i, (slot, _, _) in enumerate(batch):
            _map(lambda c, k: c[:, slot, :, :bucket].copy_(k[:, i]), self._ck, ks)
            _map(lambda c, v: c[:, slot, :, :bucket].copy_(v[:, i]), self._cv, vs)
        toks0 = self._sample_first(logits[:A], [slot for slot, _, _ in batch],
                                   [req for _, req, _ in batch])
        for i, (slot, req, ids) in enumerate(batch):
            self._activate_state(slot, req, ids, int(toks0[i]))

    def _activate_state(
        self, slot: int, req: GenRequest, ids: list[int], tok0: int, shared_len: int = 0,
        shared_entry: dict | None = None,
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
        if self._verify_fn is not None:
            # the drafter starts from the prompt; every emitted token joins it
            s.spec = NGramDrafter(self.spec_min_ngram, self.spec_max_ngram)
            s.spec.extend(ids)
        self._slots[slot] = s
        self._lengths[slot] = P  # tok0 is in the token ring already (`_sample_first`)
        # tok0's K/V is written at position P by the first decode round
        emit, finish = self._process_token(s, tok0, P - 1)
        if emit:
            req.out.put({"type": "token", "text": emit})
        if finish is not None:
            self._finish_slot(slot, s, finish)

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
        last-token logits stay on the device in `group.logits`. A ragged
        group runs `llama_prefill_chunk_ragged`, a bucketed one
        `llama_prefill_chunk_batch`. False when it failed (its requests are
        errored)."""
        try:
            paged = self._paged_operand([slot for slot, _, _ in group.metas])
            if group.bucket:
                tokens, slots, starts, nvalid, keep, wslot, wpos = self._upload_parts((
                    group.tokens.reshape(-1), group.slots, group.starts, group.nvalid,
                    group.keep, group.wslot, group.wpos))
                group.logits, self._ck, self._cv = llama_prefill_chunk_batch(
                    self.cfg, self.params, self._ck, self._cv, tokens.reshape(group.tokens.shape),
                    slots, starts, nvalid, skey=group.skey, paged=paged,
                    writes=(keep, wslot, wpos),
                )
                return True
            tokens, rowids, positions, slots, starts, last_idx, keep, wslot, wpos = (
                self._upload_parts((group.tokens, group.rowids, group.positions, group.slots,
                                    group.starts, group.last_idx, group.keep, group.wslot,
                                    group.wpos)))
            group.logits, self._ck, self._cv = llama_prefill_chunk_ragged(
                self.cfg, self.params, self._ck, self._cv, tokens, rowids, positions, slots,
                starts, last_idx, paged=paged, writes=(keep, wslot, wpos),
            )
            return True
        except Exception as e:
            self._fail_group(group, e)
            return False

    def _run_prefill_group(self, group: _PrefillGroup) -> None:
        """A group with no decode round to ride: run it alone and time it
        (the scheduler's per-token prefill cost), then activate."""
        t0 = time.perf_counter()
        if not self._launch_group(group):
            return
        self._sync()
        self._sched.observe_prefill(
            group.n_tokens, time.perf_counter() - t0, padded_tokens=group.padded
        )
        self._finish_prefill_group(group)

    def _finish_prefill_group(self, group: _PrefillGroup) -> None:
        """Advance chunk progress of a dispatched group and activate the
        prompts whose last chunk landed, sampling their first tokens from
        the group's logits."""
        if group.logits is None:
            return  # the launch failed
        try:
            fin = []
            for i, (slot, st, n) in enumerate(group.metas):
                st.done += n
                if st.done >= len(st.ids):
                    fin.append((i, slot, st))
            if fin:
                toks0 = self._sample_first(group.logits[[i for i, _, _ in fin]],
                                           [slot for _, slot, _ in fin],
                                           [st.req for _, _, st in fin])
            for k, (_, slot, st) in enumerate(fin):
                self._prefill_q.remove(slot)
                del self._prefills[slot]
                self._activate_state(slot, st.req, st.ids, int(toks0[k]), st.shared_len,
                                     st.shared_entry)
        except Exception as e:
            self._fail_group(group, e)
        group.logits = None

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
