#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`llm_mcp_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py             # every phase below, one card
    python3 chip_smoke.py --kernels   # phases 1-2 and the MLA kernel checks,
                                      # with the bf16 decode chunk sweep
    python3 chip_smoke.py --hd256     # the head_dim-256 flash rows alone
                                      # (its build, ptxas report, rows)
    python3 chip_smoke.py --planted   # the faults of PLANTED, each in a copy
                                      # (--planted=a,b: the named ones)

Phases; any failure exits non-zero and prints no result line (a result
outside its tolerance is reported and the later phases still run, so that
one run reads every check; the script then exits non-zero):

  1. build the CUDA kernels from `llm_mcp_tpu_torch/kernels/csrc/` (one
     nvcc per source, in parallel) and print ptxas's register report; no
     instantiation of the flash prefill kernels (head_dim 128, 64 and
     256), the ragged prefill kernels, the bf16 or int8 decode kernels
     (head_dim 128 and 64), the MLA ragged kernel or the MLA decode
     kernels may spill;
  2. hold each kernel against its plain PyTorch version at the main
     path's shapes in bf16, element by element (|err| <= 1e-3 + 1e-2*|ref|;
     the appends bit for bit), and time kernel, plain version, library
     call (where one computes the same function; for the head_dim-256 flash
     rows, an 8192-token prompt and Gemma-2's admission shape, flex_attention
     under torch.compile) and the bound with CUDA
     events. The prefill tile's rows (flash at head_dim 128 and 256, ragged
     bf16, ragged at G = 7 and 6) are also called REPEATS times more, each
     output equal to the first bit for bit. With `--kernels` the three bf16
     decode arms at each split size of DECODE_CHUNKS (the sweep behind
     `DECODE_CHUNK_BF16`), at these rows and at the breakdown's 8 rows
     of fill 1024. `decode_attention` (post-append, on no served path) runs
     at the decode shapes over the cache with this step's K/V written;
     every served phase checks that it launched no time, and its row
     prints that count. The paged kernels run on tables whose shared blocks were
     copied to the prefix pool with the arena's donor blocks scrambled and
     one block per row in another slot's arena home, at 64-token blocks
     (timed) and at 32 and 128 (checked). The five int8 entry points run
     at the int8 path's shapes (a fused [32, 16, 17, 4096, 128] cache, 8
     compacted rows), each against its plain version with the same
     requantization group; the int8 decode rows are timed cold (the layer
     turned over all 32 layers, about 1 GB against the 50 MB L2) with warm
     (layer 1 again) and every-row-parked times beside, and its exact arm
     is checked at S = 4072 (no int8 group divides it) and reported. The
     head_dim-64 arms (`kernel_phase_hd64`) run at Llama-3.2-1B's heads
     (G = 4) and Qwen2.5-0.5B's (G = 7): flash, ragged and decode, bf16
     and int8, contiguous and paged, the fused appends bit for bit (the
     64-byte packed-scale row), the whole row at S = 1000 and the
     post-append decode; their prefill rows held to bit-equal repeats;
  3. check the first two Llama-3.1-8B layers (full width, the served
     weights) on a small input: prefill, one decode step and one ragged
     chunk, unpaged and paged, through the kernels on the card against the
     same model functions on the host CPU, where the wrappers take the
     plain versions; and each paged call against the same call on
     contiguous rows holding the same bytes;
  4. serve Llama-3.1-8B (full depth and width, random bf16 weights from a
     seed, the engine's defaults: prompt cache 256 MiB, 64-token blocks,
     each decode round one CUDA graph, rounds pipelined two deep; every
     launch count below adds the graphs' replays)
     over HTTP and answer four concurrent chat completions (three short
     prompts, one of about 1500 tokens that goes through ragged chunks;
     three streaming), with every kernel launch counter set to 0 just
     before and read just after: each unpaged kernel must have launched;
  5. serve prefix traffic on the same server: a cold request under a
     1100-token system message, a second one that stores its 1024-token
     prefix, one hit alone, four concurrent hits, and a trio under a short
     system message
     whose third request hits a 32-token entry unaligned (copy on write);
     the counters are reset around it and both paged kernels must have
     launched, with the ledger sound (no leak, no table left, no missing
     pin) once all are done;
  6. time one decode step (8 rows, unpaged and with the first 16 blocks
     from the pool), the engine's decode round over the same rows (four
     steps with sampling) eager and captured as one CUDA graph, and one
     512-token ragged chunk of the same model, with device time by kernel
     from torch.profiler; then the capture A/B: the four chats on fresh
     engines with the round eager and captured (queued before the loop
     starts, the prefill budget fixed), each mode plain and under the
     profiler: greedy tokens identical, wall per round, TTFT, decode tok/s,
     idle share and launches a step both ways;
  7. drop the bf16 engine and serve the int8 configuration (int8 weights,
     int8 KV cache, 16 slots): the 2-layer model check at int8, then the
     chats and prefix traffic of 4 and 5 over HTTP with the counters set
     to 0 just before and read just after: all five int8 entry points must
     have launched and no bf16-cache kernel, decode must have run
     compacted, the ledger must audit clean and the packed scales must
     equal "s" bit for bit; then the breakdown and the capture A/B of 6 at
     int8 (8 decode rows of 16 slots through slot_ids). Before it, the int8 GEMM behind `qdot`
     is timed at the decode step's shapes with the weight row-major and
     K-contiguous (the layout the engine stores);
  8. drop the int8 engine and serve DeepSeek-V2-Lite (MLA latent attention
     and DeepSeek MoE, full depth and width, int8 weights, 16 slots, the
     engine's defaults), first with the int8 latent cache, then with bf16
     latents: for each, the 2-layer model check (the dense layer 0 and one
     MoE layer, unpaged and paged, against the host CPU; paged bit for bit
     against identity tables on the card), the chats and
     the prefix traffic over HTTP with the counters set to 0 just before
     and read just after (its MLA kernels launched, no GQA-cache kernel,
     the ledger clean, compacted decode at int8), and at int8 the
     breakdown and the capture A/B of 6. Before the served
     phases (with the other kernel checks) the MLA kernels are held
     against their plain versions at V2-Lite's shapes: the int8 decode
     kernel with the whole-row group and paged at 64-, 32- and 128-token
     blocks at S = 4096, and with the 512-key group (contiguous) and the
     exact group (64-token tables) on rows of 16384 keys, timed cold (the
     layer turned over every layer of the planes, more bytes than the L2
     holds) and warm (one layer again); the ragged kernel with bf16
     and int8 latents, contiguous and paged;
  9. the KV pool (`TPU_KV_HOST_OFFLOAD=1` in this phase only): fresh
     Llama-3.1-8B int8 engines (8 slots, captured rounds, pipeline depth 2)
     each serve a preempt -> host offload -> restore cycle: seven ~1000-token
     prompts and a victim admitted off a prefix hit (block-aligned: its
     snapshot holds only its private rows; unaligned: whole), then an
     urgent request of higher priority that finds no free slot and
     preempts the victim. The victim's text must equal its uncontended
     text, the ledger and packed scales audit clean, and the int8 decode
     kernels launch after the restore; offload and restore GB/s and the
     urgent request's TTFT (contended and idle) are reported, with the
     host copies of one such snapshot timed step by step. Then a chat
     over HTTP at `TPU_ADMIT_WATERMARK=1.0` with both slots of a 2-slot
     engine held must get 429 with a Retry-After of 1-600 s; then the
     aligned cycle on
     DeepSeek-V2-Lite int8 (4 slots, ~400-token prompts);
 10. speculation and constraints. On the bf16 server of 4, constrained
     chats over HTTP (a json_schema, a regex, a choice and a forced tool
     call, concurrent, greedy): every output must parse or match, an
     out-of-range logit_bias must answer 400, the constrained slots'
     masked single steps must launch the decode kernel and a masked verify
     round must run; the masked step is timed against the unmasked eager
     step on the same inputs, with the host's mask time per token. Then
     `spec_phase` for Llama-3.1-8B bf16, Llama-3.1-8B int8 and
     DeepSeek-V2-Lite int8 (fresh engines on the served weights): two
     greedy requests with a repetitive prompt, driven by hand with
     `TPU_SPEC` on and off; the tokens must be identical and a verify
     round must have run; the accept rate, tokens per verify call, the
     verify round's wall and device ms and tok/s both ways are reported.
 11. the decoder families (FAMILIES): Qwen2.5-7B int8 (full depth, G = 7,
     plus prefix traffic), Gemma-2-9B bf16 (full depth, head_dim 256,
     max_seq_len 8192, plus a prompt past its 4096-token window),
     R1-Distill-Qwen-1.5B bf16 (G = 6), Llama-3.2-1B bf16 (full depth,
     head_dim 64, plus prefix traffic) and Qwen2.5-0.5B int8 (full depth,
     head_dim 64, G = 7, plus prefix traffic) and, at 4 layers,
     Mistral-7B, Qwen3-8B and R1-Distill-Llama-8B bf16 and Mixtral-8x7B
     int8, each on fresh random weights: the four chats over HTTP (its kernels
     launched; the windowed and softcapped families no decode or ragged
     kernel), every stream finished with [DONE], and greedy tokens
     identical with the round captured and eager, the captured run
     replaying rounds from its graphs; the head_dim-64 models launched
     their `_hd64` arms and no 128 arm. Their kernel arms (head_dim-256
     flash, ragged at G = 7 and 6, decode at G = 7, the head_dim-64
     arms) are held against their plain versions with the other kernel
     checks;
 12. a checkpoint: a Qwen2.5-7B tree at full width and 2 layers written as
     two safetensors shards with an index, config.json and the fixture's
     tokenizer.json, served by `weights_dir`: logits and greedy tokens
     bit for bit those of `params_from_numpy`'s engine; load seconds and
     GB/s; the native BPE built with g++ against the Python merge core.
 13. embeddings (`embed_phase`, run while the bf16 server of 4 is up, its
     generator idle): a server with that generator and an embedding engine
     (`max_seq_len` 4096, `max_batch` 64, full depth, random weights)
     answers `/v1/embeddings` for nomic-embed-text bf16 (one input a
     request), qwen3-embedding-8b bf16 (64 inputs of 16-512 tokens,
     `dimensions` 1024) and qwen3-embedding-8b int8 (the same batch). For
     each: the 2-layer cut on the card against the host in float32
     (cosine >= 0.9995), one input alone against the batch (cosine >=
     0.999), unit vectors of the requested length, the flash kernel
     launched 36 times a Qwen3 forward and nothing for nomic (counters set
     to 0 just before each request), embeds/s, p50 latency and peak
     memory; and one chat's tok/s beside batch-64 requests against alone.
     Row 1d (`kernel_phase_embed`, with the other kernel checks) is the
     flash kernel at that batch: 64 rows, 32/8 heads, S = 512.

After each model's engines are shut down and dropped, the device memory
allocated must be back within RELEASE_SLACK of its value before they were
built; otherwise the objects that still refer to the weights are logged.

The last lines are the card (`nvidia-smi` name, power limit), one JSON
line with the kernels and one with the run's result. Imports nothing of
JAX and nothing of the JAX package.
"""

from __future__ import annotations

import functools
import gc
import itertools
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import weakref
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
INT8_OPS = 1979e12  # H100 SXM dense int8 tensor-core peak
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
# Element by element, |kernel - plain| <= atol + rtol * |plain|. Both sides
# accumulate in f32 and round the output to bf16 once, so they may differ
# by one bf16 step (at most 2^-7 relative); atol covers values near zero.
# Append copies values and must match bit for bit.
ATTN_TOL = {"atol": 1e-3, "rtol": 1e-2}
# The int8 kernels are held to the same rule against their plain versions
# with the same requantization group; the int8 append is bitwise.
BITWISE = {"atol": 0.0, "rtol": 0.0}
TOL = {"append_kv_bf16": BITWISE, "decode_attend_bf16": ATTN_TOL, "decode_attention": ATTN_TOL,
       "append_kv_bf16_fused": BITWISE, "append_kv_q8_fused": BITWISE,
       "decode_attend_q8_row": ATTN_TOL,
       "decode_attend_bf16_paged": ATTN_TOL, "flash_prefill_attention": ATTN_TOL,
       "ragged_prefill_attend_bf16": ATTN_TOL, "ragged_prefill_attend_bf16_paged": ATTN_TOL,
       "append_kv_q8": BITWISE, "decode_attend_q8": ATTN_TOL, "decode_attend_q8_paged": ATTN_TOL,
       "ragged_prefill_attend_q8": ATTN_TOL, "ragged_prefill_attend_q8_paged": ATTN_TOL,
       "decode_attend_q8_mla": ATTN_TOL, "decode_attend_q8_mla_paged": ATTN_TOL,
       "ragged_prefill_attend_mla": ATTN_TOL, "ragged_prefill_attend_mla_paged": ATTN_TOL,
       "ragged_prefill_attend_mla_q8": ATTN_TOL, "ragged_prefill_attend_mla_q8_paged": ATTN_TOL}
# the kernel arms and shapes the decoder families and the embedders add
# (kernel_phase_families, kernel_phase_embed): row -> (its source, the
# Pallas body it replaces, the phase whose served launches it reports); the
# launches count under the row's `counter`
FAMILY_ROWS = {
    "flash_prefill_attention_embed": ("llm_mcp_tpu_torch/kernels/csrc/flash_prefill.cu",
                                      "llm_mcp_tpu/kernels/attention.py:178",
                                      "qwen3-embedding-8b bf16"),
    **{n: ("llm_mcp_tpu_torch/kernels/csrc/flash_prefill_hd256.cu",
           "llm_mcp_tpu/kernels/attention.py:178", "gemma2-9b bf16")
       for n in ("flash_prefill_attention_hd256", "flash_prefill_attention_hd256_admit")},
    **{f"ragged_prefill_attend_{a}_g{g}{p}": (
        "llm_mcp_tpu_torch/kernels/csrc/ragged_prefill.cu",
        "llm_mcp_tpu/kernels/attention.py:" + ("2752" if a == "bf16" else "2908"),
        {("bf16", 7): "checkpoint", ("q8", 7): "qwen2.5-7b int8",
         ("bf16", 6): "deepseek-r1-distill-qwen-1.5b bf16", ("q8", 6): None}[a, g])
       for a in ("bf16", "q8") for g in (7, 6) for p in ("", "_paged")},
    **{f"decode_attend_{a}_g7{p}": (
        "llm_mcp_tpu_torch/kernels/csrc/decode_attend.cu",
        "llm_mcp_tpu/kernels/attention.py:" + {("bf16", ""): "1142", ("bf16", "_paged"): "1312",
                                               ("q8", ""): "330", ("q8", "_paged"): "581"}[a, p],
        "checkpoint" if a == "bf16" else "qwen2.5-7b int8")
       for a in ("bf16", "q8") for p in ("", "_paged")},
}
TOL.update({n: ATTN_TOL for n in FAMILY_ROWS})
# the head_dim-64 arms (kernel_phase_hd64): row -> (its source, the Pallas
# body it replaces, the served phase whose launches it reports: G = 4 rows
# Llama-3.2-1B bf16's, G = 7 rows Qwen2.5-0.5B int8's, where that served
# configuration runs the arm)
_HD64 = "llm_mcp_tpu_torch/kernels/csrc/"
HD64_ROWS = {
    "flash_prefill_attention_hd64": (_HD64 + "flash_prefill_hd64.cu",
                                     "llm_mcp_tpu/kernels/attention.py:178", "llama-3.2-1b bf16"),
    **{f"ragged_prefill_attend_{a}_g{g}{p}_hd64": (
        _HD64 + "ragged_prefill_hd64.cu",
        "llm_mcp_tpu/kernels/attention.py:" + ("2752" if a == "bf16" else "2908"),
        {("bf16", 4): "llama-3.2-1b bf16", ("q8", 7): "qwen2.5-0.5b int8"}.get((a, g)))
       for a in ("bf16", "q8") for g in (4, 7) for p in ("", "_paged")},
    **{f"decode_attend_{a}_g{g}{p}_hd64": (
        _HD64 + "decode_attend_hd64.cu",
        "llm_mcp_tpu/kernels/attention.py:" + {("bf16", ""): "1142", ("bf16", "_paged"): "1312",
                                               ("q8", ""): "330", ("q8", "_paged"): "581"}[a, p],
        {("bf16", 4): "llama-3.2-1b bf16", ("q8", 7): "qwen2.5-0.5b int8"}.get((a, g)))
       for a in ("bf16", "q8") for g in (4, 7) for p in ("", "_paged")},
    "append_kv_bf16_fused_hd64": (_HD64 + "decode_attend_hd64.cu",
                                  "llm_mcp_tpu/kernels/attention.py:2508", "llama-3.2-1b bf16"),
    "append_kv_q8_fused_hd64": (_HD64 + "decode_attend_hd64.cu",
                                "llm_mcp_tpu/kernels/attention.py:2349", "qwen2.5-0.5b int8"),
    "decode_attend_q8_row_hd64": (_HD64 + "decode_attend_hd64.cu",
                                  "llm_mcp_tpu/kernels/attention.py:330", None),
    "decode_attention_hd64": (_HD64 + "decode_attend_hd64.cu",
                              "llm_mcp_tpu/kernels/attention.py:298", None),
}
TOL.update({n: BITWISE if "fused" in n else ATTN_TOL for n in HD64_ROWS})
SOURCES = {
    "append_kv_bf16": ("llm_mcp_tpu_torch/kernels/csrc/append_kv.cu",
                       "llm_mcp_tpu/kernels/attention.py:2508"),
    "decode_attend_bf16": ("llm_mcp_tpu_torch/kernels/csrc/decode_attend.cu",
                           "llm_mcp_tpu/kernels/attention.py:1142"),
    "decode_attention": ("llm_mcp_tpu_torch/kernels/csrc/decode_attend.cu",
                         "llm_mcp_tpu/kernels/attention.py:298"),
    "flash_prefill_attention": ("llm_mcp_tpu_torch/kernels/csrc/flash_prefill.cu",
                                "llm_mcp_tpu/kernels/attention.py:178"),
    "ragged_prefill_attend_bf16": ("llm_mcp_tpu_torch/kernels/csrc/ragged_prefill.cu",
                                   "llm_mcp_tpu/kernels/attention.py:2752"),
    "decode_attend_bf16_paged": ("llm_mcp_tpu_torch/kernels/csrc/decode_attend.cu",
                                 "llm_mcp_tpu/kernels/attention.py:1312"),
    "ragged_prefill_attend_bf16_paged": ("llm_mcp_tpu_torch/kernels/csrc/ragged_prefill.cu",
                                         "llm_mcp_tpu/kernels/attention.py:2752"),
    "append_kv_q8": ("llm_mcp_tpu_torch/kernels/csrc/append_kv_q8.cu",
                     "llm_mcp_tpu/kernels/attention.py:2349"),
    "decode_attend_q8": ("llm_mcp_tpu_torch/kernels/csrc/decode_attend.cu",
                         "llm_mcp_tpu/kernels/attention.py:330"),
    # the whole-row arm: JAX's whole-S body where no int8 block divides S
    "decode_attend_q8_row": ("llm_mcp_tpu_torch/kernels/csrc/decode_attend.cu",
                             "llm_mcp_tpu/kernels/attention.py:330"),
    # the appends as the decode kernels write them (append=True)
    "append_kv_bf16_fused": ("llm_mcp_tpu_torch/kernels/csrc/decode_attend.cu",
                             "llm_mcp_tpu/kernels/attention.py:2508"),
    "append_kv_q8_fused": ("llm_mcp_tpu_torch/kernels/csrc/decode_attend.cu",
                           "llm_mcp_tpu/kernels/attention.py:2349"),
    "decode_attend_q8_paged": ("llm_mcp_tpu_torch/kernels/csrc/decode_attend.cu",
                               "llm_mcp_tpu/kernels/attention.py:581"),
    "ragged_prefill_attend_q8": ("llm_mcp_tpu_torch/kernels/csrc/ragged_prefill.cu",
                                 "llm_mcp_tpu/kernels/attention.py:2908"),
    "ragged_prefill_attend_q8_paged": ("llm_mcp_tpu_torch/kernels/csrc/ragged_prefill.cu",
                                       "llm_mcp_tpu/kernels/attention.py:2908"),
    "decode_attend_q8_mla": ("llm_mcp_tpu_torch/kernels/csrc/decode_attend_mla.cu",
                             "llm_mcp_tpu/kernels/attention.py:1693"),
    "decode_attend_q8_mla_paged": ("llm_mcp_tpu_torch/kernels/csrc/decode_attend_mla.cu",
                                   "llm_mcp_tpu/kernels/attention.py:1924"),
    **{n: ("llm_mcp_tpu_torch/kernels/csrc/ragged_prefill_mla.cu",
           "llm_mcp_tpu/kernels/attention.py:3061")
       for n in ("ragged_prefill_attend_mla", "ragged_prefill_attend_mla_paged",
                 "ragged_prefill_attend_mla_q8", "ragged_prefill_attend_mla_q8_paged")},
}
# the kernels each served phase must launch (its counters are reset just
# before it and read just after); the decode step appends from inside its
# decode calls (`*_fused`), so the standalone appends launch no time there
CHAT_KERNELS = ("append_kv_bf16_fused", "decode_attend_bf16", "flash_prefill_attention",
                "ragged_prefill_attend_bf16")
PREFIX_KERNELS = ("decode_attend_bf16_paged", "ragged_prefill_attend_bf16_paged")
# the int8 served phase (chats and prefix traffic on the int8 engine) must
# launch all five int8 entry points, and the admission prefill
Q8_KERNELS = ("append_kv_q8_fused", "decode_attend_q8", "decode_attend_q8_paged",
              "ragged_prefill_attend_q8", "ragged_prefill_attend_q8_paged")
STANDALONE_APPENDS = ("append_kv_bf16", "append_kv_q8")
Q8_SLOTS = 16  # the int8 engine's max_slots: 4 chats decode compacted at Ba = 8
BLOCK_TOKENS = 64  # the engine's default block size (TPU_KV_BLOCK_TOKENS unset)
SHARED_TOKENS = 1024  # prefix shared through the pool in the paged kernel cases
DECODE_CHUNKS = (64, 128, 256)  # the bf16 decode split sizes the sweep times
# the int8 decode's exact arm is checked at a length no int8 group divides
# past JAX's whole-S budget (2849 keys at Llama-3.1-8B's widths), its
# whole-row arm at one inside it (timed cold over ROW_LAYERS layers)
EXACT_S, EXACT_LAYERS = 4072, 4
ROW_S, ROW_LAYERS = 1000, 16
ALSO_REPLACES = {"decode_attend_bf16": ["llm_mcp_tpu/kernels/attention.py:1200"],
                 "decode_attend_q8": ["llm_mcp_tpu/kernels/attention.py:423"],
                 "decode_attend_q8_mla": ["llm_mcp_tpu/kernels/attention.py:1789"]}
# DeepSeek-V2-Lite (MLA + DeepSeek MoE), served at int8 weights with the int8
# latent cache (the JAX package's configuration of record) and with bf16
# latents; each served phase must launch its MLA kernels and no GQA-cache one
MLA_MODEL = "deepseek-v2-lite"
MLA_Q8_KERNELS = ("decode_attend_q8_mla", "decode_attend_q8_mla_paged",
                  "ragged_prefill_attend_mla_q8", "ragged_prefill_attend_mla_q8_paged")
MLA_BF16_KERNELS = ("ragged_prefill_attend_mla", "ragged_prefill_attend_mla_paged")
GQA_CACHE_KERNELS = ("append_kv_bf16", "append_kv_bf16_fused", "decode_attend_bf16",
                     "decode_attend_bf16_paged", "flash_prefill_attention",
                     "ragged_prefill_attend_bf16", "ragged_prefill_attend_bf16_paged",
                     "append_kv_q8", "decode_attend_q8_row") + Q8_KERNELS
# The model check runs the first CHECK_LAYERS layers in bf16 on the card and
# on the host CPU. GEMMs and attention round and sum in other orders on the
# two, so it compares logits and caches by cosine similarity.
CHECK_LAYERS = 2
MODEL_COSINE = 0.9995
# speculation and constraints (phase 10)
SPEC_PROMPT = ("Repeat this list exactly, again and again: "
               + "alpha beta gamma delta epsilon zeta eta theta; " * 8)
SPEC_TOKENS = 96
CN_SCHEMA = {"type": "object",
             "properties": {"tool": {"enum": ["search", "fetch", "read"]},
                            "urgent": {"type": "boolean"}, "level": {"enum": ["low", "high"]}},
             "required": ["tool", "urgent", "level"]}
CN_REGEX = "(alpha beta gamma delta ){4}done"
CN_CHOICES = ["yes", "no", "maybe"]

FAILURES: list[str] = []  # checks that failed; reported together at the end


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check_failed(msg: str) -> None:
    """A result outside its tolerance: noted, and the run goes on so that
    every check is read; the script then exits non-zero with no result."""
    print(f"chip_smoke: CHECK FAILED: {msg}", file=sys.stderr, flush=True)
    FAILURES.append(msg)


_T0 = time.time()


def log(msg: str) -> None:
    """One line of the run's log, with the seconds since the script started."""
    print(f"chip_smoke: [{time.time() - _T0:.1f} s] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2, queue_ahead: bool = True) -> float:
    """ms per call of `fn` between CUDA events around `iters` calls. A
    wrapper's host work can take longer than its kernel, so with
    `queue_ahead` the card first sleeps for about as long as the host needs
    to queue the calls: the events then time the device, not the host's
    issue rate. Without it, the wall time of calls as the host issues them."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = time.perf_counter() - t0
    if queue_ahead:
        torch.cuda._sleep(int(min(iters * one, 1.0) * 2e9))  # cycles, about 1 s at most
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cold_warm_ms(call, layers: int, iters: int) -> tuple[float, float]:
    """(cold, warm) ms per call of `call(layer)`, by `time_ms`: cold turns
    the layer over `layers` layers, so that the calls read more bytes than
    the 50 MB L2 holds, as a decode step's 27 layers do; warm repeats layer
    1, whose bytes the L2 then serves."""
    it = itertools.cycle(range(layers))
    return time_ms(lambda: call(next(it)), iters), time_ms(lambda: call(1), iters)


def device_ms_by_kernel(fn, n: int = 10) -> dict[str, float] | str:
    """Device time per call of each kernel `fn` launches (torch.profiler
    over n calls): the split and the combine of a decode wrapper."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            m = re.search(r"\w*kernel\w*", e.key)
            out[m.group(0) if m else e.key[:60]] = e.self_device_time_total / 1e3 / n
    log(f"device ms by kernel: {json.dumps(out)}")
    return out or "not measured"


def compare(name, out, ref) -> tuple[float, float]:
    """Max abs error and the largest |out - ref| / limit over elements."""
    o, r = out.float(), ref.float()
    diff = (o - r).abs()
    limit = TOL[name]["atol"] + TOL[name]["rtol"] * r.abs()
    ratio = torch_where_ratio(diff, limit)
    err = diff.max().item()
    if not (o.isfinite().all() and math.isfinite(err)) or not (diff <= limit).all():
        n_bad = int((~(diff <= limit)).sum().item())
        check_failed(f"{name}: {n_bad} of {diff.numel()} elements beyond "
                     f"|err| <= {TOL[name]['atol']} + {TOL[name]['rtol']}*|ref| "
                     f"(max_abs_err {err}, worst err/limit {ratio})")
    return err, ratio


REPEATS = 20  # calls of a prefill tile kernel held bit for bit against its first


def repeat_check(name, call, n: int = REPEATS) -> int:
    """Call `call` n more times: each output must equal the first bit for
    bit (the tile's reductions have a fixed order, so a race in it shows as
    an output that moves between calls). Returns n."""
    import torch

    first = call()
    bad = sum(not torch.equal(call(), first) for _ in range(n))
    if bad:
        check_failed(f"{name}: {bad} of {n} repeated calls differ from the first")
    return n


def torch_where_ratio(diff, limit) -> float:
    """max |err| / limit over the elements that differ (0 if none)."""
    import torch

    return torch.where(diff > 0, diff / limit, torch.zeros_like(diff)).max().item()


def _record(res, name, out, ref, ms, plain_ms, bytes_, ops_ms, library_ms, shape):
    """One kernel row: error against the plain version, times, and the
    bound: the larger of the bytes over the HBM rate and `ops_ms`, the
    operations over the peak rate of their type."""
    err, ratio = compare(name, out, ref)
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    res[name] = {
        "max_abs_err": err, "tol": TOL[name], "worst_err_over_limit": ratio,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, ops_ms), "bound_by": "bytes" if t_bytes >= ops_ms else "operations",
        "library_ms": library_ms, "shape": shape,
    }
    log(f"{name}: err {err:.3g} (err/limit {ratio:.3g}) ms {ms:.4f} plain {plain_ms:.4f} "
        f"bound {res[name]['bound_ms']:.4f} ({res[name]['bound_by']}) library {library_ms}")


def fused_append_check(name, call, standalone, plain, cache, timed=False, library=None) -> dict:
    """A decode arm's fused append, bit for bit: `call(c, append)` runs the
    arm on the cache leaves `c` (a dict; the call reads and writes layer
    1), `standalone(c)` and `plain(c)` append layer 1's rows with the
    standalone kernel and with the plain version. The output with append
    must equal the output without, and the cache after it the cache after
    the call without and the plain append (its `max_abs_err`), and the
    cache after the call without and the standalone append; each leaf is
    compared whole. With `timed`, also the call's ms with the write and
    without, in turns (without, with, with, without: the write's cost is
    their difference), the plain append's ms and the library call's
    (`library()`). Returns the report; a mismatch is a failed check of
    row `name`."""
    import torch

    def after(append_):
        c = {k: v.clone() for k, v in cache.items()}
        o = call(c, False)
        append_(c)
        return o, c

    out, ref = after(plain)
    _, want = after(standalone)
    got = {k: v.clone() for k, v in cache.items()}
    fused = call(got, True)
    torch.cuda.synchronize()
    err = max((got[k].float() - ref[k].float()).abs().max().item() for k in cache)
    report = {"max_abs_err": err, "output_equal": torch.equal(fused, out),
              "cache_equal_plain": {k: torch.equal(got[k], ref[k]) for k in cache},
              "cache_equal_standalone": {k: torch.equal(got[k], want[k]) for k in cache}}
    if not report["output_equal"]:
        check_failed(f"{name}: the decode output with append differs from the output without")
    for against in ("plain", "standalone"):
        if not all(report["cache_equal_" + against].values()):
            check_failed(f"{name}: the cache after the fused append differs from the {against} "
                         f"append's: {report['cache_equal_' + against]} (max_abs_err against the "
                         f"plain append {err})")
    if timed:
        with_, without = [], []
        for append in (False, True, True, False):
            (with_ if append else without).append(time_ms(lambda: call(got, append), 50))
        report.update(with_ms=sum(with_) / 2, without_ms=sum(without) / 2,
                      ms=(sum(with_) - sum(without)) / 2, plain_ms=time_ms(lambda: plain(got), 20),
                      library_ms=None if library is None else time_ms(library, 50))
    log(f"{name} fused append: {json.dumps(report)}")
    return report


def _fused_row(res, name, check, bytes_, shape) -> None:
    """A fused append's row from its timed `fused_append_check`: ms is the
    decode call's time with the write minus without; the bound is the
    bytes of the call's write (the step's new rows read once, the cache
    rows written once) over the HBM rate."""
    res[name] = {
        "max_abs_err": check["max_abs_err"], "tol": TOL[name],
        "worst_err_over_limit": 0.0 if check["max_abs_err"] == 0 else math.inf,
        "ms": check["ms"], "plain_ms": check["plain_ms"],
        "bound_ms": bytes_ / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": check["library_ms"], "shape": shape, "fused_check": check,
    }
    log(f"{name}: ms {check['ms']:.6f} (with {check['with_ms']:.5f}, without "
        f"{check['without_ms']:.5f}) plain {check['plain_ms']:.4f} bound "
        f"{res[name]['bound_ms']:.6f} library {check['library_ms']}")


def _ragged_sdpa(qr, kr, vr, rowids, starts, kp, vp):
    """The ragged kernels' library yardstick: one SDPA call with a
    block-causal mask over every descriptor row's prefix (kp/vp
    [R, Hkv, S, hd], gathered outside the timed call) and the packed
    chunk's own keys. Returns the call."""
    import torch
    import torch.nn.functional as F

    T, Hkv, G, hd = qr.shape
    dev = qr.device
    rid = rowids.long()
    col_row = torch.cat([torch.full((s_,), r, device=dev) for r, s_ in enumerate(starts)])
    u = torch.arange(T, device=dev)
    mask = torch.cat([rid[:, None] == col_row[None, :],
                      (rid[:, None] == rid[None, :]) & (u[None, :] <= u[:, None])], 1)
    qh = qr.permute(1, 2, 0, 3).reshape(Hkv * G, T, hd)
    keys = torch.cat([kp[r, :, :s_] for r, s_ in enumerate(starts)] + [kr.transpose(0, 1)], 1)
    vals = torch.cat([vp[r, :, :s_] for r, s_ in enumerate(starts)] + [vr.transpose(0, 1)], 1)
    return lambda: F.scaled_dot_product_attention(
        qh[None], keys[None], vals[None], attn_mask=mask, enable_gqa=True)


def decode_chunk_sweep(K, q, nk, nv, ck, cv, ak, av, pg, lens, ids, scale) -> dict:
    """The bf16 decode split size: each of DECODE_CHUNKS set in turn as
    `K.DECODE_CHUNK_BF16`, at the kernel phase's rows (fills 511..4095, one
    parked) and at the breakdown's (8 rows at fill 1024), for the three
    arms: contiguous, paged (the phase's 64-token tables over ak/av) and
    post-append (this step's K/V written at w). Each call is held against
    its plain version and timed; returns {shapes: {arm: {chunk: ms}}}."""
    import torch

    S = ck.shape[3]
    B = q.shape[0]
    dev = q.device
    out: dict[str, dict] = {}
    chosen = K.DECODE_CHUNK_BF16
    for label, ln, rows in (
        ("kernel_phase_rows", lens, ids),
        ("fill_1024", torch.full((B,), 1024, dtype=torch.int32, device=dev),
         torch.arange(B, dtype=torch.int32, device=dev)),
    ):
        live = ln < S
        li = torch.arange(B, device=dev)[live]
        kpost, vpost = ck[1][rows.long()], cv[1][rows.long()]
        kpost[li, :, ln.long()[live]] = nk[live]
        vpost[li, :, ln.long()[live]] = nv[live]
        arms = {
            "decode_attend_bf16": (
                lambda: K.decode_attend_bf16(q, nk, nv, ck, cv, 1, ln, slot_ids=rows,
                                             scale=scale),
                K.decode_attend_plain(q, nk, nv, ck, cv, 1, ln, rows, scale)),
            "decode_attend_bf16_paged": (
                lambda: K.decode_attend_bf16(q, nk, nv, ak, av, 1, ln, slot_ids=rows,
                                             scale=scale, **pg),
                K.decode_attend_paged_plain(q, nk, nv, ak, av, 1, ln, pg["block_tables"],
                                            pg["pool_k"], pg["pool_v"], rows, scale)),
            "decode_attention": (
                lambda: K.decode_attention(q, kpost, vpost, ln),
                K.decode_attention_plain(q, kpost, vpost, ln)),
        }
        table: dict[str, dict] = {}
        for arm, (call, ref) in arms.items():
            for chunk in DECODE_CHUNKS:
                K.DECODE_CHUNK_BF16 = chunk
                try:
                    compare(arm, call(), ref)
                    table.setdefault(arm, {})[chunk] = time_ms(call, 50)
                finally:
                    K.DECODE_CHUNK_BF16 = chosen
        out[label] = table
        del kpost, vpost
    out["chosen"] = chosen
    log(f"bf16 decode chunk sweep (ms): {json.dumps(out)}")
    return out


def kernel_phase() -> dict[str, dict]:
    """Each kernel vs its plain version at the main path's shapes."""
    import torch
    import torch.nn.functional as F

    from llm_mcp_tpu_torch.kernels import attention as K

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    L, B, Hkv, G, S, hd = 32, 8, 8, 4, 4096, 128  # llama-3.1-8b, max_slots 8, 4096
    H = Hkv * G
    scale = hd**-0.5
    ck, cv = rn(L, B, Hkv, S, hd), rn(L, B, Hkv, S, hd)
    res: dict[str, dict] = {}

    record = functools.partial(_record, res)

    # append: one decode step's K/V for all 32 layers, 8 rows
    nk, nv = rn(L, B, Hkv, hd), rn(L, B, Hkv, hd)
    lens = i32([5, 700, 1500, 2047, 2048, 3000, 4000, 4095])
    ids = i32([3, 0, 7, 1, 6, 2, 5, 4])
    ak, av = ck.clone(), cv.clone()
    K.append_kv_bf16(ak, av, nk, nv, lens, slot_ids=ids)
    pk, pv = K.append_kv_plain(ck.clone(), cv.clone(), nk, nv, lens, ids)
    torch.cuda.synchronize()
    if not (torch.equal(ak, pk) and torch.equal(av, pv)):
        check_failed("append_kv_bf16 differs from its plain version")
    li = torch.arange(L, device=dev)[:, None, None]
    bi = ids.long()[None, :, None]
    hi_ = torch.arange(Hkv, device=dev)[None, None, :]
    wi = lens.long()[None, :, None]
    # the timed calls rewrite the same values, so ak still equals pk after
    record(
        "append_kv_bf16", ak, pk,
        time_ms(lambda: K.append_kv_bf16(ak, av, nk, nv, lens, slot_ids=ids), 50),
        time_ms(lambda: K.append_kv_plain(ak, av, nk, nv, lens, ids), 20),
        4 * L * B * Hkv * hd * 2, 0.0,
        time_ms(lambda: (ak.index_put_((li, bi, hi_, wi), nk),
                         av.index_put_((li, bi, hi_, wi), nv)), 50),
        {"cache": [L, B, Hkv, S, hd], "new": [L, B, Hkv, hd]},
    )
    del ak, av, pk, pv

    # decode: 8 rows at fills from 1/8 to full, one parked at S (as idle
    # slots are on the served path), rows permuted through slot_ids;
    # pre-append cache
    q, nk1, nv1 = rn(B, Hkv, G, hd), rn(B, Hkv, hd), rn(B, Hkv, hd)
    lens = i32([511, 1023, 1535, 2047, S, 3071, 3583, 4095])
    ids = i32([3, 0, 7, 1, 6, 2, 5, 4])
    out = K.decode_attend_bf16(q, nk1, nv1, ck, cv, 1, lens, slot_ids=ids, scale=scale)
    ref = K.decode_attend_plain(q, nk1, nv1, ck, cv, 1, lens, ids, scale)
    # a parked row reads its new vectors only, no cache
    keys = sum(w + 1 if w < S else 1 for w in lens.tolist())
    qs = q.reshape(B, H, 1, hd)
    live = lens < S
    kpost, vpost = ck[1][ids.long()], cv[1][ids.long()]
    rows = torch.arange(B, device=dev)[live]
    kpost[rows, :, lens.long()[live]] = nk1[live]
    vpost[rows, :, lens.long()[live]] = nv1[live]
    pos = torch.arange(S, device=dev)[None, :]
    amask = torch.where(live[:, None], pos <= lens[:, None], pos < 1)[:, None, None, :]
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qs, kpost, vpost, attn_mask=amask, enable_gqa=True)
    record(
        "decode_attend_bf16", out, ref,
        time_ms(lambda: K.decode_attend_bf16(q, nk1, nv1, ck, cv, 1, lens, slot_ids=ids,
                                             scale=scale), 50),
        time_ms(lambda: K.decode_attend_plain(q, nk1, nv1, ck, cv, 1, lens, ids, scale), 10),
        keys * Hkv * hd * 2 * 2 + (2 * q.numel() + 2 * nk1.numel()) * 2,
        4.0 * hd * G * Hkv * keys / BF16_FLOPS * 1e3, time_ms(lib, 50),
        {"q": [B, Hkv, G, hd], "cache": [L, B, Hkv, S, hd], "lengths": lens.tolist(),
         "slot_ids": ids.tolist()},
    )
    res["decode_attend_bf16"]["device_ms_by_kernel"] = device_ms_by_kernel(
        lambda: K.decode_attend_bf16(q, nk1, nv1, ck, cv, 1, lens, slot_ids=ids, scale=scale))
    # the fused append at these rows, on the first two layers (layer 1
    # written); the library yardstick writes the same rows by index_put_
    sub2 = {"k": ck[:2].clone(), "v": cv[:2].clone()}
    lv = lens < S
    bi1, wi1 = ids.long()[lv][:, None], lens.long()[lv][:, None]
    hi1 = torch.arange(Hkv, device=dev)[None, :]
    nk_l, nv_l = nk1[lv], nv1[lv]  # the live rows, gathered outside the timed call
    check = fused_append_check(
        "append_kv_bf16_fused",
        lambda c, append: K.decode_attend_bf16(q, nk1, nv1, c["k"], c["v"], 1, lens, slot_ids=ids,
                                               scale=scale, append=append),
        lambda c: K.append_kv_bf16(c["k"][1:2], c["v"][1:2], nk1[None], nv1[None], lens,
                                   slot_ids=ids),
        lambda c: K.append_kv_plain(c["k"][1:2], c["v"][1:2], nk1[None], nv1[None], lens, ids),
        sub2, timed=True,
        library=lambda: (sub2["k"][1].index_put_((bi1, hi1, wi1), nk_l),
                         sub2["v"][1].index_put_((bi1, hi1, wi1), nv_l)))
    _fused_row(res, "append_kv_bf16_fused", check, 4 * int(lv.sum()) * Hkv * hd * 2,
               {"decode": "the decode_attend_bf16 row's call", "layers_written": 1,
                "lengths": lens.tolist(), "slot_ids": ids.tolist(),
                "ms": "decode call with the write minus without",
                "library": "index_put_ of the same rows"})
    del sub2

    # decode_attention: the same rows over the post-append cache (kpost:
    # this step's K/V written at w), inclusive lengths; the row at S
    # attends all S. No served path calls it.
    kpost, vpost = kpost.contiguous(), vpost.contiguous()
    out = K.decode_attention(q, kpost, vpost, lens)
    ref = K.decode_attention_plain(q, kpost, vpost, lens)
    keys_post = sum(min(w, S - 1) + 1 for w in lens.tolist())
    pmask = (pos <= lens[:, None])[:, None, None, :]
    record(
        "decode_attention", out, ref,
        time_ms(lambda: K.decode_attention(q, kpost, vpost, lens), 50),
        time_ms(lambda: K.decode_attention_plain(q, kpost, vpost, lens), 10),
        keys_post * Hkv * hd * 2 * 2 + 2 * q.numel() * 2,
        4.0 * hd * G * Hkv * keys_post / BF16_FLOPS * 1e3,
        time_ms(lambda: F.scaled_dot_product_attention(
            qs, kpost, vpost, attn_mask=pmask, enable_gqa=True), 50),
        {"q": [B, Hkv, G, hd], "cache": [B, Hkv, S, hd], "lengths": lens.tolist(),
         "library": "SDPA, inclusive length mask, same rows",
         "served": "none: no model, engine or API of either package calls it"},
    )

    # flash prefill: an admission batch of 4 prompts in a 512 bucket
    Bp, Sp = 4, 512
    qp, kp, vp = rn(Bp, H, Sp, hd), rn(Bp, Hkv, Sp, hd), rn(Bp, Hkv, Sp, hd)
    lp = i32([512, 400, 300, 200])
    out = K.flash_prefill_attention(qp, kp, vp, lp, scale=scale)
    ref = K.flash_prefill_plain(qp, kp, vp, lp, scale=scale)
    pairs = sum(min(t + 1, n) for n in lp.tolist() for t in range(Sp))
    kx, vx = kp.repeat_interleave(G, 1), vp.repeat_interleave(G, 1)
    record(
        "flash_prefill_attention", out, ref,
        time_ms(lambda: K.flash_prefill_attention(qp, kp, vp, lp, scale=scale), 20),
        time_ms(lambda: K.flash_prefill_plain(qp, kp, vp, lp, scale=scale), 10),
        (2 * qp.numel() + 2 * kp.numel()) * 2, 4.0 * hd * H * pairs / BF16_FLOPS * 1e3,
        time_ms(lambda: F.scaled_dot_product_attention(qp, kx, vx, is_causal=True), 20),
        {"q": [Bp, H, Sp, hd], "lengths": lp.tolist()},
    )
    res["flash_prefill_attention"]["repeats_bitwise"] = repeat_check(
        "flash_prefill_attention", lambda: K.flash_prefill_attention(qp, kp, vp, lp, scale=scale))
    # the same inputs under a 200-key window and a softcap (Mistral-7B's
    # and Gemma-2's masks at this width), checked and not timed
    wkw = dict(window=200, softcap=30.0, scale=scale)
    err, ratio = compare("flash_prefill_attention",
                         K.flash_prefill_attention(qp, kp, vp, lp, **wkw),
                         K.flash_prefill_plain(qp, kp, vp, lp, **wkw))
    res["flash_prefill_attention"]["window_check"] = {
        **wkw, "max_abs_err": err, "worst_err_over_limit": ratio}
    del kx, vx

    # ragged prefill: 4 rows (1900 tokens) with cached prefixes, packed into
    # the T = 2048 bucket with a tail of pads (rowid R), as the engine packs
    T, R = 2048, 4
    starts, ns = [0, 512, 1024, 1536], [500, 480, 460, 460]
    n_pad = T - sum(ns)
    rowids = i32(sum(([r] * n for r, n in enumerate(ns)), []) + [R] * n_pad)
    offsets = i32([sum(ns[:r]) for r in range(R + 1)])
    slots, st = i32([2, 5, 0, 7]), i32(starts)
    qr, kr, vr = rn(T, Hkv, G, hd), rn(T, Hkv, hd), rn(T, Hkv, hd)
    args = (qr, kr, vr, ck, cv, 3, rowids, offsets, slots, st)
    out = K.ragged_prefill_attend_bf16(*args, scale=scale)
    ref = K.ragged_prefill_plain(*args, scale=scale)
    # past + causal self pairs of every row; the pads attend earlier pads
    pairs = sum(s * n + n * (n + 1) // 2 for s, n in zip(starts, ns)) + n_pad * (n_pad + 1) // 2
    ragged_sdpa = functools.partial(_ragged_sdpa, qr, kr, vr, rowids, starts)
    rlib = ragged_sdpa(ck[3][slots.long()], cv[3][slots.long()])
    record(
        "ragged_prefill_attend_bf16", out, ref,
        time_ms(lambda: K.ragged_prefill_attend_bf16(*args, scale=scale), 10),
        time_ms(lambda: K.ragged_prefill_plain(*args, scale=scale), 5),
        (2 * qr.numel() + 2 * kr.numel() + 2 * sum(starts) * Hkv * hd) * 2,
        4.0 * hd * H * pairs / BF16_FLOPS * 1e3, time_ms(rlib, 10),
        {"q": [T, Hkv, G, hd], "rows": R, "tokens": ns, "pads": n_pad, "starts": starts,
         "library": "SDPA, one call, block-causal mask over the prefixes and the chunk"},
    )
    res["ragged_prefill_attend_bf16"]["repeats_bitwise"] = repeat_check(
        "ragged_prefill_attend_bf16", lambda: K.ragged_prefill_attend_bf16(*args, scale=scale))
    del rlib
    # -- paged: the same work, read through block tables -----------------
    # Each row's first SHARED_TOKENS come from the prefix pool (copied from
    # row 0, as a stored prefix is); the arena's donor blocks are scrambled,
    # so a read that goes to the arena where the table says pool fails; one
    # more block per row lives in another slot's arena home.
    def paged_case(bt: int):
        nbs, nsh = S // bt, SHARED_TOKENS // bt
        pk = ck[:, 0, :, : nsh * bt].reshape(L, Hkv, nsh, bt, hd).transpose(1, 2).contiguous()
        pv = cv[:, 0, :, : nsh * bt].reshape(L, Hkv, nsh, bt, hd).transpose(1, 2).contiguous()
        ak, av = ck.clone(), cv.clone()
        ak[:, :, :, : nsh * bt] = rn(L, B, Hkv, nsh * bt, hd)
        av[:, :, :, : nsh * bt] = rn(L, B, Hkv, nsh * bt, hd)
        tbl = torch.arange(B * nbs, dtype=torch.int32, device=dev).reshape(B, nbs)
        tbl[:, :nsh] = B * nbs + torch.arange(nsh, dtype=torch.int32, device=dev)
        for b in range(B):  # block nsh of row b lives in row (b + 3) % B's home
            tbl[b, nsh] = ((b + 3) % B) * nbs + nsh
            ak[:, b, :, nsh * bt: (nsh + 1) * bt] = rn(L, Hkv, bt, hd)
            av[:, b, :, nsh * bt: (nsh + 1) * bt] = rn(L, Hkv, bt, hd)
        return ak, av, {"block_tables": tbl, "pool_k": pk, "pool_v": pv}

    lens = i32([511, 1023, 1535, 2047, S, 3071, 3583, 4095])
    ids = i32([3, 0, 7, 1, 6, 2, 5, 4])
    others: dict[str, dict] = {}  # the checked block sizes, by kernel
    for bt in (32, 128, BLOCK_TOKENS):  # the timed case last
        ak, av, pg = paged_case(bt)
        dargs = (q, nk1, nv1, ak, av, 1, lens)
        out = K.decode_attend_bf16(*dargs, slot_ids=ids, scale=scale, **pg)
        ref = K.decode_attend_paged_plain(*dargs, pg["block_tables"], pg["pool_k"],
                                          pg["pool_v"], ids, scale)
        rargs = (qr, kr, vr, ak, av, 3, rowids, offsets, slots, st)
        rout = K.ragged_prefill_attend_bf16(*rargs, scale=scale, **pg)
        rref = K.ragged_prefill_paged_plain(*rargs, pg["block_tables"], pg["pool_k"],
                                            pg["pool_v"], scale)
        pg2 = {"block_tables": pg["block_tables"], "pool_k": pg["pool_k"][:2].contiguous(),
               "pool_v": pg["pool_v"][:2].contiguous()}
        paged_fused = fused_append_check(
            "append_kv_bf16_fused",
            lambda c, append: K.decode_attend_bf16(q, nk1, nv1, c["k"], c["v"], 1, lens,
                                                   slot_ids=ids, scale=scale, append=append,
                                                   **pg2),
            lambda c: K.append_kv_bf16(c["k"][1:2], c["v"][1:2], nk1[None], nv1[None], lens,
                                       slot_ids=ids),
            lambda c: K.append_kv_plain(c["k"][1:2], c["v"][1:2], nk1[None], nv1[None], lens,
                                        ids),
            {"k": ak[:2].clone(), "v": av[:2].clone()})
        res["append_kv_bf16_fused"].setdefault("paged", {})[bt] = paged_fused
        del pg2
        if bt != BLOCK_TOKENS:
            for name, o, r in (("decode_attend_bf16_paged", out, ref),
                               ("ragged_prefill_attend_bf16_paged", rout, rref)):
                err, ratio = compare(name, o, r)
                log(f"{name} at {bt}-token blocks: err {err:.3g} (err/limit {ratio:.3g})")
                others.setdefault(name, {})[bt] = {
                    "max_abs_err": err, "worst_err_over_limit": ratio}
            del ak, av, pg
            continue
        tbl = pg["block_tables"]
        nbs = S // bt
        # library yardstick: SDPA on the contiguous-equivalent rows (gathered
        # through the tables, outside the timed call)
        kg = K.paged_gather(ak[1], pg["pool_k"][1], tbl[ids.long()])
        vg = K.paged_gather(av[1], pg["pool_v"][1], tbl[ids.long()])
        kg[rows, :, lens.long()[live]] = nk1[live]
        vg[rows, :, lens.long()[live]] = nv1[live]
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qs, kg, vg, attn_mask=amask, enable_gqa=True)
        blocks = sum(-(-(w + 1) // bt) if w < S else 0 for w in lens.tolist())
        record(
            "decode_attend_bf16_paged", out, ref,
            time_ms(lambda: K.decode_attend_bf16(*dargs, slot_ids=ids, scale=scale, **pg), 50),
            time_ms(lambda: K.decode_attend_paged_plain(
                *dargs, tbl, pg["pool_k"], pg["pool_v"], ids, scale), 10),
            keys * Hkv * hd * 2 * 2 + (2 * q.numel() + 2 * nk1.numel()) * 2 + blocks * 4,
            4.0 * hd * G * Hkv * keys / BF16_FLOPS * 1e3, time_ms(lib, 50),
            {"q": [B, Hkv, G, hd], "cache": [L, B, Hkv, S, hd], "block_tokens": bt,
             "pool": list(pg["pool_k"].shape), "lengths": lens.tolist(),
             "slot_ids": ids.tolist(), "shared_tokens": SHARED_TOKENS,
             "library": "SDPA, length mask, on the rows gathered through the tables"},
        )
        del kg, vg
        if "--kernels" in sys.argv[1:]:
            res["decode_attend_bf16"]["chunk_sweep"] = decode_chunk_sweep(
                K, q, nk1, nv1, ck, cv, ak, av, pg, lens, ids, scale)
        # ragged: the same SDPA over the prefixes gathered through the tables
        rlib = ragged_sdpa(K.paged_gather(ak[3], pg["pool_k"][3], tbl[slots.long()]),
                           K.paged_gather(av[3], pg["pool_v"][3], tbl[slots.long()]))
        P_ = sum(starts)
        blocks_r = sum(-(-s_ // bt) for s_ in starts)
        record(
            "ragged_prefill_attend_bf16_paged", rout, rref,
            time_ms(lambda: K.ragged_prefill_attend_bf16(*rargs, scale=scale, **pg), 10),
            time_ms(lambda: K.ragged_prefill_paged_plain(
                *rargs, tbl, pg["pool_k"], pg["pool_v"], scale), 5),
            (2 * qr.numel() + 2 * kr.numel() + 2 * P_ * Hkv * hd) * 2 + blocks_r * 4,
            4.0 * hd * H * pairs / BF16_FLOPS * 1e3, time_ms(rlib, 10),
            {"q": [T, Hkv, G, hd], "rows": R, "tokens": ns, "pads": n_pad, "starts": starts,
             "block_tokens": bt, "shared_tokens": SHARED_TOKENS,
             "library": "SDPA, one call, block-causal mask over the gathered prefixes and the chunk"},
        )
        del rlib, ak, av, pg
    for name, by_bt in others.items():
        res[name]["other_block_sizes"] = by_bt
    del ck, cv, kpost, vpost
    torch.cuda.empty_cache()
    return res


def kernel_phase_q8() -> dict[str, dict]:
    """The five int8 entry points against their plain versions at the int8
    served path's shapes: a fused [32, 16, 17, 4096, 128] cache (16 slots,
    made by `fuse_prompt_kv` from random bf16 K/V, so scales are as the
    engine writes them) read by 8 compacted rows through slot_ids, with
    the requantization group the wrappers pass (256 keys contiguous, bt
    paged); the paged ones at 64-token blocks (timed), 32 and 128
    (checked). The library yardstick is SDPA over the same rows
    dequantized to bf16 outside the timed call."""
    import torch
    import torch.nn.functional as F

    from llm_mcp_tpu_torch.kernels import attention as K
    from llm_mcp_tpu_torch.models.llama import fuse_prompt_kv

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4321)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    L, B, Hkv, G, S, hd, Ba = 32, Q8_SLOTS, 8, 4, 4096, 128, 8
    H, Hs, Hf = Hkv * G, 2 * Hkv, 2 * Hkv + 1
    scale = hd**-0.5
    res: dict[str, dict] = {}
    record = functools.partial(_record, res)

    def fill(c, rows, lo, hi):
        """Rows `rows` (a slice or index) of c over tokens [lo, hi),
        quantized from fresh random bf16 K/V, layer by layer."""
        for li in range(L):
            n = len(range(*rows.indices(c["q"].shape[1]))) if isinstance(rows, slice) else 1
            e = fuse_prompt_kv(rn(n, Hkv, hi - lo, hd), rn(n, Hkv, hi - lo, hd))
            c["q"][li, rows, :, lo:hi] = e["q"] if isinstance(rows, slice) else e["q"][0]
            c["s"][li, rows, :, lo:hi] = e["s"] if isinstance(rows, slice) else e["s"][0]

    cache = {"q": torch.empty((L, B, Hf, S, hd), dtype=torch.int8, device=dev),
             "s": torch.empty((L, B, Hs, S), dtype=torch.bfloat16, device=dev)}
    fill(cache, slice(None), 0, S)
    ids = i32([3, 0, 12, 1, 6, 9, 15, 4])  # compacted rows: slot_ids into 16 slots

    def dequant(pay, ss):
        """[R, Hf, T, hd] int8 and [R, Hs, T] scales -> bf16 K and V rows."""
        k = (pay[:, :Hkv].float() * ss[:, :Hkv, :, None].float()).to(torch.bfloat16)
        v = (pay[:, Hkv:Hs].float() * ss[:, Hkv:, :, None].float()).to(torch.bfloat16)
        return k, v

    # append: one step's K/V for all 32 layers, 8 rows (one parked)
    nk, nv = rn(L, Ba, Hkv, hd), rn(L, Ba, Hkv, hd)
    lens = i32([5, 700, 1500, 2047, 2048, 3000, S, 4095])
    got = {k: v.clone() for k, v in cache.items()}
    K.append_kv_q8(got, {}, nk, nv, lens, slot_ids=ids)
    want = K.append_kv_q8_plain({k: v.clone() for k, v in cache.items()}, nk, nv, lens, ids)
    torch.cuda.synchronize()
    # bitwise over the whole cache ("q" with the pseudo-head, and "s");
    # the element-wise line reads the written rows
    if not (torch.equal(got["q"], want["q"]) and torch.equal(got["s"], want["s"])):
        check_failed("append_kv_q8: the cache differs from its plain version's")
    wl = lens < S
    b_w, w_w = ids.long()[wl], lens.long()[wl]
    live_rows = int(wl.sum().item())
    record(
        "append_kv_q8", got["q"][:, b_w, :, w_w], want["q"][:, b_w, :, w_w],
        time_ms(lambda: K.append_kv_q8(got, {}, nk, nv, lens, slot_ids=ids), 50),
        time_ms(lambda: K.append_kv_q8_plain(got, nk, nv, lens, ids), 20),
        live_rows * L * (2 * Hkv * hd * 2 + Hf * hd + Hs * 2), 0.0, None,
        {"cache": [L, B, Hf, S, hd], "new": [L, Ba, Hkv, hd], "lengths": lens.tolist(),
         "library": "none: no one PyTorch call quantizes, packs and writes"},
    )
    del got, want

    # decode: 8 compacted rows at fills 1/8 to full, one parked
    q, nk1, nv1 = rn(Ba, Hkv, G, hd), rn(Ba, Hkv, hd), rn(Ba, Hkv, hd)
    lens = i32([511, 1023, 1535, 2047, S, 3071, 3583, 4095])
    group = K.q8_group(S)
    keys = sum(w + 1 if w < S else 1 for w in lens.tolist())
    live = lens < S
    rows = torch.arange(Ba, device=dev)[live]
    qs = q.reshape(Ba, H, 1, hd)
    pos = torch.arange(S, device=dev)[None, :]
    amask = torch.where(live[:, None], pos <= lens[:, None], pos < 1)[:, None, None, :]
    dbytes = keys * Hkv * (2 * hd + 2 * 2) + (2 * q.numel() + 2 * nk1.numel()) * 2
    dops_ms = 4.0 * hd * G * Hkv * keys / INT8_OPS * 1e3

    def sdpa_rows(pay, ss):
        k, v = dequant(pay, ss)
        k[rows, :, lens.long()[live]] = nk1[live]
        v[rows, :, lens.long()[live]] = nv1[live]
        return lambda: F.scaled_dot_product_attention(qs, k, v, attn_mask=amask, enable_gqa=True)

    out = K.decode_attend_q8(q, nk1, nv1, cache, {}, 1, lens, slot_ids=ids, scale=scale)
    ref = K.decode_attend_q8_plain(q, nk1, nv1, cache, 1, lens, ids, scale, group)
    lib = sdpa_rows(cache["q"][1][ids.long()], cache["s"][1][ids.long()])
    timing = (f"ms cold: the layer turned over {L} layers ({L * dbytes / 1e6:.0f} MB "
              f"attended, 50 MB L2); warm_ms: layer 1")
    parked = torch.full_like(lens, S)
    cold, warm = cold_warm_ms(lambda li: K.decode_attend_q8(
        q, nk1, nv1, cache, {}, li, lens, slot_ids=ids, scale=scale), L, 64)
    record(
        "decode_attend_q8", out, ref, cold,
        time_ms(lambda: K.decode_attend_q8_plain(q, nk1, nv1, cache, 1, lens, ids, scale,
                                                 group), 10),
        dbytes, dops_ms, time_ms(lib, 50),
        {"q": [Ba, Hkv, G, hd], "cache": [L, B, Hf, S, hd], "lengths": lens.tolist(),
         "slot_ids": ids.tolist(), "group": group, "timing": timing,
         "library": "SDPA, length mask, on the rows dequantized to bf16"},
    )
    # the call's fixed cost: every row parked, no key read
    res["decode_attend_q8"].update(
        warm_ms=warm,
        all_parked_ms=time_ms(lambda: K.decode_attend_q8(
            q, nk1, nv1, cache, {}, 1, parked, slot_ids=ids, scale=scale), 50),
        device_ms_by_kernel=device_ms_by_kernel(lambda: K.decode_attend_q8(
            q, nk1, nv1, cache, {}, 1, lens, slot_ids=ids, scale=scale)))
    log(f"decode_attend_q8: cold {cold:.5f} ms, warm {warm:.5f} ms, all rows parked "
        f"{res['decode_attend_q8']['all_parked_ms']:.5f} ms")
    del lib

    def q8_fused(c_, lens_, **kw):
        """fused_append_check of the int8 decode on the first two layers of
        c_ (layer 1 written)."""
        return dict(
            call=lambda c, append: K.decode_attend_q8(q, nk1, nv1, c, {}, 1, lens_, slot_ids=ids,
                                                      scale=scale, append=append, **kw),
            standalone=lambda c: K.append_kv_q8({k: v[1:2] for k, v in c.items()}, {},
                                                nk1[None], nv1[None], lens_, slot_ids=ids),
            plain=lambda c: K.append_kv_q8_plain({k: v[1:2] for k, v in c.items()}, nk1[None],
                                                 nv1[None], lens_, ids),
            cache={k: v[:2].clone() for k, v in c_.items()})

    check = fused_append_check(
        "append_kv_q8_fused", **q8_fused(cache, lens), timed=True)
    _fused_row(res, "append_kv_q8_fused", check,
               int(live.sum()) * (2 * Hkv * hd * 2 + Hf * hd + Hs * 2),
               {"decode": "the decode_attend_q8 row's call (group 256)", "layers_written": 1,
                "lengths": lens.tolist(), "slot_ids": ids.tolist(),
                "ms": "decode call with the write minus without",
                "library": "none: no one PyTorch call quantizes, packs and writes"})

    # ragged: 4 rows (1900 tokens) with cached int8 prefixes in T = 2048
    T, R = 2048, 4
    starts, ns = [0, 512, 1024, 1536], [500, 480, 460, 460]
    n_pad = T - sum(ns)
    rowids = i32(sum(([r] * n for r, n in enumerate(ns)), []) + [R] * n_pad)
    offsets = i32([sum(ns[:r]) for r in range(R + 1)])
    slots, st = i32([2, 5, 12, 7]), i32(starts)
    qr, kr, vr = rn(T, Hkv, G, hd), rn(T, Hkv, hd), rn(T, Hkv, hd)
    past = sum(s_ * n for s_, n in zip(starts, ns))
    selfp = sum(n * (n + 1) // 2 for n in ns) + n_pad * (n_pad + 1) // 2
    rops_ms = (4.0 * hd * H * past / INT8_OPS + 4.0 * hd * H * selfp / BF16_FLOPS) * 1e3
    rbytes = (2 * qr.numel() + 2 * kr.numel()) * 2 + sum(starts) * Hkv * (2 * hd + 2 * 2)

    def sdpa_ragged(pay, ss):
        return _ragged_sdpa(qr, kr, vr, rowids, starts, *dequant(pay, ss))

    rargs = (qr, kr, vr, cache, 3, rowids, offsets, slots, st)
    out = K.ragged_prefill_attend_q8(*rargs, scale=scale)
    ref = K.ragged_prefill_q8_plain(*rargs, scale)
    rlib = sdpa_ragged(cache["q"][3][slots.long()], cache["s"][3][slots.long()])
    rshape = {"q": [T, Hkv, G, hd], "rows": R, "tokens": ns, "pads": n_pad, "starts": starts,
              "library": "SDPA, one call, block-causal mask over the prefixes dequantized "
                         "to bf16 and the chunk"}
    record(
        "ragged_prefill_attend_q8", out, ref,
        time_ms(lambda: K.ragged_prefill_attend_q8(*rargs, scale=scale), 10),
        time_ms(lambda: K.ragged_prefill_q8_plain(*rargs, scale), 5),
        rbytes, rops_ms, time_ms(rlib, 10), rshape,
    )
    del rlib

    # paged: each row's first SHARED_TOKENS from pool rows copied from row 0,
    # the arena's donors refilled with other values, block nsh of each row
    # in another slot's home
    others: dict[str, dict] = {}
    for bt in (32, 128, BLOCK_TOKENS):  # the timed case last
        nbs, nsh = S // bt, SHARED_TOKENS // bt
        pool = {
            "q": cache["q"][:, 0, :, : nsh * bt].reshape(L, Hf, nsh, bt, hd).transpose(1, 2)
            .contiguous(),
            "s": cache["s"][:, 0, :, : nsh * bt].reshape(L, Hs, nsh, bt).transpose(1, 2)
            .contiguous(),
        }
        arena = {k: v.clone() for k, v in cache.items()}
        fill(arena, slice(None), 0, nsh * bt)
        tbl = torch.arange(B * nbs, dtype=torch.int32, device=dev).reshape(B, nbs)
        tbl[:, :nsh] = B * nbs + torch.arange(nsh, dtype=torch.int32, device=dev)
        for b in range(B):  # block nsh of row b lives in row (b + 3) % B's home
            tbl[b, nsh] = ((b + 3) % B) * nbs + nsh
        fill(arena, slice(None), nsh * bt, (nsh + 1) * bt)
        pg = {"block_tables": tbl, "pool_k": pool}
        res["append_kv_q8_fused"].setdefault("paged", {})[bt] = fused_append_check(
            "append_kv_q8_fused", **q8_fused(arena, lens, block_tables=tbl,
                                             pool_k={k: v[:2].contiguous()
                                                     for k, v in pool.items()}))
        dargs = (q, nk1, nv1, arena, {}, 1, lens)
        out = K.decode_attend_q8(*dargs, slot_ids=ids, scale=scale, **pg)
        ref = K.decode_attend_q8_plain(q, nk1, nv1, arena, 1, lens, ids, scale, bt, tbl, pool)
        prargs = (qr, kr, vr, arena, 3, rowids, offsets, slots, st)
        rout = K.ragged_prefill_attend_q8(*prargs, scale=scale, block_tables=tbl, pool=pool)
        rref = K.ragged_prefill_q8_plain(*prargs, scale, tbl, pool)
        if bt != BLOCK_TOKENS:
            for name, o, r in (("decode_attend_q8_paged", out, ref),
                               ("ragged_prefill_attend_q8_paged", rout, rref)):
                err, ratio = compare(name, o, r)
                log(f"{name} at {bt}-token blocks: err {err:.3g} (err/limit {ratio:.3g})")
                others.setdefault(name, {})[bt] = {"max_abs_err": err, "worst_err_over_limit": ratio}
            del arena, pool, pg
            continue
        blocks = sum(-(-(w + 1) // bt) if w < S else 0 for w in lens.tolist())
        lib = sdpa_rows(K.paged_gather(arena["q"][1], pool["q"][1], tbl[ids.long()]),
                        K.paged_gather(arena["s"][1], pool["s"][1], tbl[ids.long()]))
        cold, warm = cold_warm_ms(lambda li: K.decode_attend_q8(
            q, nk1, nv1, arena, {}, li, lens, slot_ids=ids, scale=scale, **pg), L, 64)
        record(
            "decode_attend_q8_paged", out, ref, cold,
            time_ms(lambda: K.decode_attend_q8_plain(q, nk1, nv1, arena, 1, lens, ids, scale,
                                                     bt, tbl, pool), 10),
            dbytes + blocks * 4, dops_ms, time_ms(lib, 50),
            {"q": [Ba, Hkv, G, hd], "cache": [L, B, Hf, S, hd], "block_tokens": bt,
             "group": bt, "pool": list(pool["q"].shape), "lengths": lens.tolist(),
             "slot_ids": ids.tolist(), "shared_tokens": SHARED_TOKENS, "timing": timing,
             "library": "SDPA, length mask, on the rows gathered through the tables and "
                        "dequantized to bf16"},
        )
        res["decode_attend_q8_paged"].update(
            warm_ms=warm,
            all_parked_ms=time_ms(lambda: K.decode_attend_q8(
                q, nk1, nv1, arena, {}, 1, parked, slot_ids=ids, scale=scale, **pg), 50),
            device_ms_by_kernel=device_ms_by_kernel(lambda: K.decode_attend_q8(
                *dargs, slot_ids=ids, scale=scale, **pg)))
        log(f"decode_attend_q8_paged: cold {cold:.5f} ms, warm {warm:.5f} ms, all rows parked "
            f"{res['decode_attend_q8_paged']['all_parked_ms']:.5f} ms")
        del lib
        rlib = sdpa_ragged(K.paged_gather(arena["q"][3], pool["q"][3], tbl[slots.long()]),
                           K.paged_gather(arena["s"][3], pool["s"][3], tbl[slots.long()]))
        record(
            "ragged_prefill_attend_q8_paged", rout, rref,
            time_ms(lambda: K.ragged_prefill_attend_q8(*prargs, scale=scale, block_tables=tbl,
                                                       pool=pool), 10),
            time_ms(lambda: K.ragged_prefill_q8_plain(*prargs, scale, tbl, pool), 5),
            rbytes + sum(-(-s_ // bt) for s_ in starts) * 4, rops_ms, time_ms(rlib, 10),
            dict(rshape, block_tokens=bt, shared_tokens=SHARED_TOKENS,
                 library="SDPA, one call, block-causal mask over the prefixes gathered "
                         "through the tables and dequantized to bf16, and the chunk"),
        )
        del rlib, arena, pool, pg
    for name, by_bt in others.items():
        res[name]["other_block_sizes"] = by_bt
    del cache
    torch.cuda.empty_cache()

    # the exact arm: S = 4072, which no int8 group divides (q8_group 0, JAX's
    # exact f32 fallback), held against the plain version with group 0 and
    # timed cold over its EXACT_LAYERS layers (warm: layer 1); reported
    # beside the decode row, not a row of its own
    Sx = EXACT_S
    xc = {"q": torch.empty((EXACT_LAYERS, B, Hf, Sx, hd), dtype=torch.int8, device=dev),
          "s": torch.empty((EXACT_LAYERS, B, Hs, Sx), dtype=torch.bfloat16, device=dev)}
    for li in range(EXACT_LAYERS):
        e = fuse_prompt_kv(rn(B, Hkv, Sx, hd), rn(B, Hkv, Sx, hd))
        xc["q"][li], xc["s"][li] = e["q"], e["s"]
    xlens = i32([511, 1023, 1535, 2047, Sx, 3071, 3583, Sx - 1])
    if K.q8_decode_plan(Sx, hd, Hkv, H)[0] != 0:
        check_failed(f"decode_attend_q8: the plan at S={Sx} is not the exact arm")
    out = K.decode_attend_q8(q, nk1, nv1, xc, {}, 1, xlens, slot_ids=ids, scale=scale)
    ref = K.decode_attend_q8_plain(q, nk1, nv1, xc, 1, xlens, ids, scale, 0)
    err, ratio = compare("decode_attend_q8", out, ref)
    cold, warm = cold_warm_ms(lambda li: K.decode_attend_q8(
        q, nk1, nv1, xc, {}, li, xlens, slot_ids=ids, scale=scale), EXACT_LAYERS, 32)
    xkeys = sum(w + 1 if w < Sx else 1 for w in xlens.tolist())
    res["decode_attend_q8"]["exact_group"] = {
        "S": Sx, "group": 0, "lengths": xlens.tolist(), "max_abs_err": err,
        "worst_err_over_limit": ratio, "ms": cold, "warm_ms": warm,
        "bound_ms": (xkeys * Hkv * (2 * hd + 2 * 2) + (2 * q.numel() + 2 * nk1.numel()) * 2)
        / HBM_BYTES_PER_S * 1e3,
        "timing": f"ms cold: the layer turned over {EXACT_LAYERS} layers; warm_ms: layer 1"}
    log(f"decode_attend_q8 at S={Sx} (exact group): "
        f"{json.dumps(res['decode_attend_q8']['exact_group'])}")
    res["append_kv_q8_fused"]["exact"] = fused_append_check(
        "append_kv_q8_fused", **q8_fused(xc, xlens))
    del xc
    torch.cuda.empty_cache()

    # the whole-row arm: S = 1000, which no int8 block divides and which fits
    # JAX's whole-S budget (its whole-S body requantizes p over the whole
    # row): a score pass, then the split kernel; held against the plain
    # version with group S, timed cold over ROW_LAYERS layers (warm: layer 1)
    Sr = ROW_S
    rc = {"q": torch.empty((ROW_LAYERS, B, Hf, Sr, hd), dtype=torch.int8, device=dev),
          "s": torch.empty((ROW_LAYERS, B, Hs, Sr), dtype=torch.bfloat16, device=dev)}
    for li in range(ROW_LAYERS):
        e = fuse_prompt_kv(rn(B, Hkv, Sr, hd), rn(B, Hkv, Sr, hd))
        rc["q"][li], rc["s"][li] = e["q"], e["s"]
    rlens = i32([124, 249, 374, 499, Sr, 749, 874, Sr - 1])
    if K.q8_decode_plan(Sr, hd, Hkv, H)[0] != Sr:
        check_failed(f"decode_attend_q8_row: the plan at S={Sr} is not the whole row")
    K.reset_launches()
    out = K.decode_attend_q8(q, nk1, nv1, rc, {}, 1, rlens, slot_ids=ids, scale=scale)
    if K.LAUNCHES["decode_attend_q8_row"] != 1:
        check_failed("decode_attend_q8_row: the call did not take the whole-row arm")
    ref = K.decode_attend_q8_plain(q, nk1, nv1, rc, 1, rlens, ids, scale, Sr)
    rkeys = sum(w + 1 if w < Sr else 1 for w in rlens.tolist())
    rlive = rlens < Sr
    rpos = torch.arange(Sr, device=dev)[None, :]
    rmask = torch.where(rlive[:, None], rpos <= rlens[:, None], rpos < 1)[:, None, None, :]
    kd, vd = dequant(rc["q"][1][ids.long()], rc["s"][1][ids.long()])
    rrows = torch.arange(Ba, device=dev)[rlive]
    kd[rrows, :, rlens.long()[rlive]] = nk1[rlive]
    vd[rrows, :, rlens.long()[rlive]] = nv1[rlive]
    cold, warm = cold_warm_ms(lambda li: K.decode_attend_q8(
        q, nk1, nv1, rc, {}, li, rlens, slot_ids=ids, scale=scale), ROW_LAYERS, 64)
    record(
        "decode_attend_q8_row", out, ref, cold,
        time_ms(lambda: K.decode_attend_q8_plain(q, nk1, nv1, rc, 1, rlens, ids, scale, Sr), 10),
        rkeys * Hkv * (2 * hd + 2 * 2) + (2 * q.numel() + 2 * nk1.numel()) * 2,
        4.0 * hd * G * Hkv * rkeys / INT8_OPS * 1e3,
        time_ms(lambda: F.scaled_dot_product_attention(qs, kd, vd, attn_mask=rmask,
                                                       enable_gqa=True), 50),
        {"q": [Ba, Hkv, G, hd], "cache": [ROW_LAYERS, B, Hf, Sr, hd], "lengths": rlens.tolist(),
         "slot_ids": ids.tolist(), "group": Sr,
         "timing": f"ms cold: the layer turned over {ROW_LAYERS} layers; warm_ms: layer 1",
         "library": "SDPA, length mask, on the rows dequantized to bf16"},
    )
    res["decode_attend_q8_row"].update(
        warm_ms=warm,
        all_parked_ms=time_ms(lambda: K.decode_attend_q8(
            q, nk1, nv1, rc, {}, 1, torch.full_like(rlens, Sr), slot_ids=ids, scale=scale), 50),
        device_ms_by_kernel=device_ms_by_kernel(lambda: K.decode_attend_q8(
            q, nk1, nv1, rc, {}, 1, rlens, slot_ids=ids, scale=scale)))
    log(f"decode_attend_q8_row: cold {cold:.5f} ms, warm {warm:.5f} ms, all rows parked "
        f"{res['decode_attend_q8_row']['all_parked_ms']:.5f} ms")
    res["append_kv_q8_fused"]["whole_row"] = fused_append_check(
        "append_kv_q8_fused", **q8_fused(rc, rlens))
    del rc, kd, vd
    torch.cuda.empty_cache()
    return res


def _sdpa_backend(fn) -> str:
    """The first SDPA backend (flash, cuDNN, memory-efficient, math) that
    takes `fn`'s call, as the library yardstick's note."""
    import warnings

    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for b in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
              SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with warnings.catch_warnings(), sdpa_kernel([b]):
                warnings.simplefilter("ignore")  # each refusal warns why
                fn()
            torch.cuda.synchronize()
            return b.name
        except RuntimeError:
            continue
    return "none"


def kernel_phase_mla() -> dict[str, dict]:
    """The MLA kernels against their plain versions at DeepSeek-V2-Lite's
    shapes (16 heads, R = 512, dr = 64, 27 layers, 16 slots of 4096): the
    int8 decode kernel read by 8 compacted rows (fills 511..4095, one
    parked) with the whole-row group JAX serves at this shape (timed);
    paged at 64-token blocks (timed, group 64), 32 (JAX's exact fallback:
    128 blocks) and 128 (checked); rows of 16384 keys, past the whole-S
    budget, where JAX serves its blocked arm's 512-key groups and, through
    64-token tables (256 blocks), its exact fallback (checked and timed);
    every decode row is timed cold, the layer turned over the planes'
    layers, and warm (layer 1 again); the ragged kernel on T = 2048 (4 rows over prefixes
    0/512/1024/1536 and a pad tail) with bf16 and int8 latents, contiguous
    and paged (64 timed, 32 and 128 checked). Latents are made by
    `quantize_kv` from random bf16 rows, as the engine writes them. The
    library yardstick is SDPA over the keys dequantized to [lat * ls |
    rop * rs] (width 576) and the values lat * ls (width 512), gathered
    outside the timed call."""
    import torch
    import torch.nn.functional as F

    from llm_mcp_tpu_torch.kernels import attention as K
    from llm_mcp_tpu_torch.models.llama import quantize_kv

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5150)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    L, B, H, S, R, dr, Ba = 27, Q8_SLOTS, 16, 4096, 512, 64, 8
    scale = (128 + 64) ** -0.5
    res: dict[str, dict] = {}
    record = functools.partial(_record, res)

    def planes(rows, tokens, quantized, layers=L):
        """(latents, rope keys) of `rows` rows of `tokens`, layer by layer."""
        out = []
        for w in (R, dr):
            if not quantized:
                out.append(rn(layers, rows, 1, tokens, w))
                continue
            q = torch.empty((layers, rows, 1, tokens, w), dtype=torch.int8, device=dev)
            sc = torch.empty((layers, rows, 1, tokens), dtype=torch.bfloat16, device=dev)
            for li in range(layers):
                e = quantize_kv(rn(rows, 1, tokens, w))
                q[li], sc[li] = e["q"], e["s"]
            out.append({"q": q, "s": sc})
        return out

    def deq(plane, li, rows_idx, tbl=None, pool=None):
        """Layer li's rows dequantized to bf16 [n, S, w], through tables."""
        if isinstance(plane, dict):
            pq = K._mla_plane(plane["q"], li, rows_idx, tbl, None if pool is None else pool["q"])
            ps = K._mla_plane(plane["s"], li, rows_idx, tbl, None if pool is None else pool["s"])
            return (pq.float() * ps.float()[..., None]).to(torch.bfloat16)
        return K._mla_plane(plane, li, rows_idx, tbl, pool)

    def paged_planes(cc, cr, bt, quantized):
        """Tables whose first SHARED_TOKENS of every row read pool rows
        copied from row 0, the arena's donor blocks refilled with other
        values, and block nsh of each row in another slot's arena home."""
        layers, _, _, seq = (cc["q"] if quantized else cc).shape[:4]
        nbs, nsh = seq // bt, SHARED_TOKENS // bt

        def split(plane):  # row 0's first nsh blocks as pool rows [layers, nsh, 1, bt, ...]
            return plane[:, 0, 0, : nsh * bt].reshape(layers, nsh, 1, bt,
                                                      *plane.shape[4:]).contiguous()

        def refill(plane, new):
            out = plane.clone()
            out[:, :, :, : (nsh + 1) * bt] = new
            return out

        pools = [_tree(split, p) for p in (cc, cr)]
        fresh = planes(B, nsh * bt + bt, quantized, layers)
        arenas = [_tree(refill, p, f) for p, f in zip((cc, cr), fresh)]
        tbl = torch.arange(B * nbs, dtype=torch.int32, device=dev).reshape(B, nbs)
        tbl[:, :nsh] = B * nbs + torch.arange(nsh, dtype=torch.int32, device=dev)
        for b in range(B):
            tbl[b, nsh] = ((b + 3) % B) * nbs + nsh
        return arenas[0], arenas[1], pools[0], pools[1], tbl

    # -- decode: int8 latents, 8 compacted rows of 16 slots ---------------
    cc, cr = planes(B, S, True)
    qt, qr, nc, nr = rn(Ba, H, R), rn(Ba, H, dr), rn(Ba, R), rn(Ba, dr)
    lens = i32([511, 1023, 1535, 2047, S, 3071, 3583, 4095])
    ids = i32([3, 0, 12, 1, 6, 9, 15, 4])
    keys = sum(w + 1 if w < S else 1 for w in lens.tolist())
    dbytes = keys * (R + dr + 2 * 2) + (qt.numel() + qr.numel() + nc.numel() + nr.numel()
                                       + qt.numel()) * 2
    # per (key, head): s8 latent dot and PV (4R int8 ops), the rope dot in f32
    dops_ms = (4.0 * R * H * keys / INT8_OPS + 2.0 * dr * H * keys / F32_FLOPS) * 1e3
    qs = torch.cat([qt, qr], -1)[:, :, None]  # [Ba, H, 1, 576]

    def sdpa_decode(c_, r_, lens_, tbl=None, pc=None, pr=None):
        """SDPA over the rows dequantized, each position w taking the
        exact new vectors, masked past w (a parked row sees key 0)."""
        live_ = lens_ < c_["q"].shape[3]
        rows = torch.arange(Ba, device=dev)[live_]
        pos = torch.arange(c_["q"].shape[3], device=dev)[None, :]
        amask = torch.where(live_[:, None], pos <= lens_[:, None], pos < 1)[:, None, None, :]
        lat = deq(c_, 1, ids.long(), tbl, pc)
        rop = deq(r_, 1, ids.long(), tbl, pr)
        lat[rows, lens_.long()[live_]] = nc[live_]
        rop[rows, lens_.long()[live_]] = nr[live_]
        k = torch.cat([lat, rop], -1)[:, None]
        v = lat[:, None]
        fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qs, k, v, attn_mask=amask, scale=scale, enable_gqa=True)
        return fn, _sdpa_backend(fn)

    group = K.mla_decode_group(S, R, dr, H)
    if group != S:
        check_failed(f"decode_attend_q8_mla: the served group is {group}, the whole row wanted")
    dargs = (qt, qr, nc, nr, cc, cr, 1, lens)
    out = K.decode_attend_q8_mla(*dargs, slot_ids=ids, scale=scale)
    ref = K.decode_attend_q8_mla_plain(*dargs, ids, scale, group)
    lib, backend = sdpa_decode(cc, cr, lens)
    dshape = {"qt": [Ba, H, R], "latents": [L, B, 1, S, R], "lengths": lens.tolist(),
              "slot_ids": ids.tolist(), "group": group,
              "splits": K.mla_decode_plan(S, group, Ba, H)[0],
              "timing": f"ms cold: the layer turned over {L} layers "
                        f"({L * dbytes / 1e6:.0f} MB attended, 50 MB L2); warm_ms: layer 1",
              "library": f"SDPA ({backend}), length mask, keys [lat*ls | rop*rs] width 576, "
                         f"values lat*ls width 512, dequantized to bf16"}
    cold, warm = cold_warm_ms(lambda li: K.decode_attend_q8_mla(
        qt, qr, nc, nr, cc, cr, li, lens, slot_ids=ids, scale=scale), L, 54)
    record(
        "decode_attend_q8_mla", out, ref, cold,
        time_ms(lambda: K.decode_attend_q8_mla_plain(*dargs, ids, scale, group), 5),
        dbytes, dops_ms, time_ms(lib, 20), dshape,
    )
    # the kernels' fixed cost: every row parked, one split each and no key read
    parked = torch.full_like(lens, S)
    res["decode_attend_q8_mla"].update(
        warm_ms=warm,
        all_parked_ms=time_ms(lambda: K.decode_attend_q8_mla(
            qt, qr, nc, nr, cc, cr, 1, parked, slot_ids=ids, scale=scale), 50),
        device_ms_by_kernel=device_ms_by_kernel(
            lambda: K.decode_attend_q8_mla(*dargs, slot_ids=ids, scale=scale)))
    log(f"decode_attend_q8_mla: cold {cold:.5f} ms, warm {warm:.5f} ms, all rows parked "
        f"{res['decode_attend_q8_mla']['all_parked_ms']:.5f} ms")
    del lib
    # paged
    others: dict[str, dict] = {}
    for bt in (32, 128, BLOCK_TOKENS):  # the timed case last
        ac, ar, pc, pr, tbl = paged_planes(cc, cr, bt, True)
        pg = dict(block_tables=tbl, pool_c=pc, pool_r=pr)
        pgroup = K.mla_decode_group(S, R, dr, H, S // bt)
        pargs = (qt, qr, nc, nr, ac, ar, 1, lens)
        out = K.decode_attend_q8_mla(*pargs, slot_ids=ids, scale=scale, **pg)
        ref = K.decode_attend_q8_mla_plain(*pargs, ids, scale, pgroup, tbl, pc, pr)
        if bt != BLOCK_TOKENS:
            err, ratio = compare("decode_attend_q8_mla_paged", out, ref)
            log(f"decode_attend_q8_mla_paged at {bt}-token blocks (group {pgroup}): err {err:.3g} "
                f"(err/limit {ratio:.3g})")
            others.setdefault("decode_attend_q8_mla_paged", {})[bt] = {
                "max_abs_err": err, "worst_err_over_limit": ratio, "group": pgroup}
            del ac, ar, pc, pr, pg
            continue
        lib, backend = sdpa_decode(ac, ar, lens, tbl, pc, pr)
        blocks = sum(-(-(w + 1) // bt) if w < S else 0 for w in lens.tolist())
        cold, warm = cold_warm_ms(lambda li: K.decode_attend_q8_mla(
            qt, qr, nc, nr, ac, ar, li, lens, slot_ids=ids, scale=scale, **pg), L, 54)
        record(
            "decode_attend_q8_mla_paged", out, ref, cold,
            time_ms(lambda: K.decode_attend_q8_mla_plain(*pargs, ids, scale, pgroup, tbl, pc, pr),
                    5),
            dbytes + blocks * 4, dops_ms, time_ms(lib, 20),
            dict(dshape, block_tokens=bt, group=pgroup, pool=list(pc["q"].shape),
                 shared_tokens=SHARED_TOKENS,
                 library=f"SDPA ({backend}), length mask, on the rows gathered through the "
                         f"tables and dequantized to bf16"),
        )
        res["decode_attend_q8_mla_paged"]["warm_ms"] = warm
        log(f"decode_attend_q8_mla_paged: cold {cold:.5f} ms, warm {warm:.5f} ms")
        del lib, ac, ar, pc, pr, pg
    del cc, cr

    # -- decode past the whole-S budget: 16384-key rows of 4 layers ----------
    SL, LL = 16384, 4
    lgroup = K.mla_decode_group(SL, R, dr, H)
    if lgroup != 512:
        check_failed(f"decode_attend_q8_mla: the group at S={SL} is {lgroup}, JAX's 512 wanted")
    lc, lr = planes(B, SL, True, layers=LL)
    llens = i32([2047, 5119, 8191, SL, 12287, 14335, 15359, 16383])
    lkeys = sum(w + 1 if w < SL else 1 for w in llens.tolist())
    lbytes = dbytes + (lkeys - keys) * (R + dr + 2 * 2)
    lops_ms = dops_ms * lkeys / keys
    for bt in (None, BLOCK_TOKENS):
        if bt is None:
            lg, largs, pg = lgroup, (qt, qr, nc, nr, lc, lr, 1, llens), {}
        else:
            ac, ar, pc, pr, tbl = paged_planes(lc, lr, bt, True)
            lg, largs = K.mla_decode_group(SL, R, dr, H, SL // bt), (qt, qr, nc, nr, ac, ar, 1, llens)
            pg = dict(block_tables=tbl, pool_c=pc, pool_r=pr)
        name = "decode_attend_q8_mla" if bt is None else "decode_attend_q8_mla_paged"
        out = K.decode_attend_q8_mla(*largs, slot_ids=ids, scale=scale, **pg)
        cold, warm = cold_warm_ms(lambda li: K.decode_attend_q8_mla(
            *largs[:6], li, llens, slot_ids=ids, scale=scale, **pg), LL, 20)
        ref = K.decode_attend_q8_mla_plain(*largs, ids, scale, lg, pg.get("block_tables"),
                                           pg.get("pool_c"), pg.get("pool_r"))
        err, ratio = compare(name, out, ref)
        lblocks = sum(-(-(w + 1) // bt) if w < SL else 0 for w in llens.tolist()) if bt else 0
        t_bytes = (lbytes + lblocks * 4) / HBM_BYTES_PER_S * 1e3
        row = {
            "S": SL, "lengths": llens.tolist(), "block_tokens": bt, "group": lg,
            "splits": K.mla_decode_plan(SL, lg, Ba, H)[0], "max_abs_err": err,
            "worst_err_over_limit": ratio, "ms": cold, "warm_ms": warm,
            "timing": f"ms cold: the layer turned over {LL} layers "
                      f"({LL * lbytes / 1e6:.0f} MB attended, 50 MB L2); warm_ms: layer 1",
            "plain_ms": time_ms(lambda: K.decode_attend_q8_mla_plain(
                *largs, ids, scale, lg, pg.get("block_tables"), pg.get("pool_c"),
                pg.get("pool_r")), 2),
            "bound_ms": max(t_bytes, lops_ms),
            "bound_by": "bytes" if t_bytes >= lops_ms else "operations"}
        lib, backend = sdpa_decode(largs[4], largs[5], llens, *(pg.get(k) for k in (
            "block_tables", "pool_c", "pool_r")))
        row.update(library_ms=time_ms(lib, 10), library=f"SDPA ({backend})")
        log(f"{name} at S={SL} (group {lg}): {json.dumps(row)}")
        del lib
        res[name]["long_rows"] = row
        del out, ref, largs, pg
    del lc, lr, ac, ar, pc, pr, tbl
    torch.cuda.empty_cache()

    # -- ragged: T = 2048, bf16 and int8 latents ------------------------------
    T, Rn = 2048, 4
    starts, ns = [0, 512, 1024, 1536], [500, 480, 460, 460]
    n_pad = T - sum(ns)
    rowids = i32(sum(([r] * n for r, n in enumerate(ns)), []) + [Rn] * n_pad)
    offsets = i32([sum(ns[:r]) for r in range(Rn + 1)])
    slots, st = i32([2, 5, 12, 7]), i32(starts)
    qt, qr, cs, krs = rn(T, H, R), rn(T, H, dr), rn(T, R), rn(T, dr)
    pairs = sum(s_ * n + n * (n + 1) // 2 for s_, n in zip(starts, ns)) + n_pad * (n_pad + 1) // 2
    rops_ms = 2176.0 * H * pairs / BF16_FLOPS * 1e3
    rid = rowids.long()
    col_row = torch.cat([torch.full((s_,), r, device=dev) for r, s_ in enumerate(starts)])
    u = torch.arange(T, device=dev)
    rmask = torch.cat([rid[:, None] == col_row[None, :],
                       (rid[:, None] == rid[None, :]) & (u[None, :] <= u[:, None])], 1)
    qh = torch.cat([qt, qr], -1).transpose(0, 1)[None]  # [1, H, T, 576]

    def sdpa_ragged(cc_, cr_, tbl=None, pc=None, pr=None):
        lat = deq(cc_, 3, slots.long(), tbl, pc)
        rop = deq(cr_, 3, slots.long(), tbl, pr)
        k = torch.cat([torch.cat([lat[r, :s_], rop[r, :s_]], -1) for r, s_ in enumerate(starts)]
                      + [torch.cat([cs, krs], -1)])[None, None]
        v = torch.cat([lat[r, :s_] for r, s_ in enumerate(starts)] + [cs])[None, None]
        fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qh, k, v, attn_mask=rmask, scale=scale, enable_gqa=True)
        return fn, _sdpa_backend(fn)

    for quantized in (False, True):
        tag = "_q8" if quantized else ""
        cc, cr = planes(B, S, quantized)
        per_key = (R + dr + 4) if quantized else 2 * (R + dr)
        rbytes = (qt.numel() + qr.numel() + cs.numel() + krs.numel() + qt.numel()) * 2 \
            + sum(starts) * per_key
        rargs = (qt, qr, cs, krs, cc, cr, 3, rowids, offsets, slots, st)
        out = K.ragged_prefill_attend_mla(*rargs, scale=scale)
        ref = K.ragged_prefill_mla_plain(*rargs, scale)
        lib, backend = sdpa_ragged(cc, cr)
        rshape = {"qt": [T, H, R], "rows": Rn, "tokens": ns, "pads": n_pad, "starts": starts,
                  "latents": "int8" if quantized else "bf16",
                  "library": f"SDPA ({backend}), one call, block-causal mask over the prefixes "
                             f"(keys [lat*ls | rop*rs], values lat*ls) and the chunk"}
        record(
            f"ragged_prefill_attend_mla{tag}", out, ref,
            time_ms(lambda: K.ragged_prefill_attend_mla(*rargs, scale=scale), 5),
            time_ms(lambda: K.ragged_prefill_mla_plain(*rargs, scale), 2),
            rbytes, rops_ms, time_ms(lib, 5), rshape,
        )
        del lib
        name = f"ragged_prefill_attend_mla{tag}_paged"
        for bt in (32, 128, BLOCK_TOKENS):
            ac, ar, pc, pr, tbl = paged_planes(cc, cr, bt, quantized)
            pg = dict(block_tables=tbl, pool_c=pc, pool_r=pr)
            pargs = (qt, qr, cs, krs, ac, ar, 3, rowids, offsets, slots, st)
            out = K.ragged_prefill_attend_mla(*pargs, scale=scale, **pg)
            ref = K.ragged_prefill_mla_plain(*pargs, scale, tbl, pc, pr)
            if bt != BLOCK_TOKENS:
                err, ratio = compare(name, out, ref)
                log(f"{name} at {bt}-token blocks: err {err:.3g} (err/limit {ratio:.3g})")
                others.setdefault(name, {})[bt] = {"max_abs_err": err,
                                                   "worst_err_over_limit": ratio}
                del ac, ar, pc, pr, pg
                continue
            lib, backend = sdpa_ragged(ac, ar, tbl, pc, pr)
            record(
                name, out, ref,
                time_ms(lambda: K.ragged_prefill_attend_mla(*pargs, scale=scale, **pg), 5),
                time_ms(lambda: K.ragged_prefill_mla_plain(*pargs, scale, tbl, pc, pr), 2),
                rbytes + sum(-(-s_ // bt) for s_ in starts) * 4, rops_ms, time_ms(lib, 5),
                dict(rshape, block_tokens=bt, shared_tokens=SHARED_TOKENS,
                     library=f"SDPA ({backend}), one call, block-causal mask over the prefixes "
                             f"gathered through the tables and dequantized, and the chunk"),
            )
            del lib, ac, ar, pc, pr, pg
        del cc, cr
    for name, by_bt in others.items():
        res[name]["other_block_sizes"] = by_bt
    torch.cuda.empty_cache()
    return res


def _flex_library(q, k, v, lens, ref, window, cap, scale, iters) -> dict:
    """The yardstick of the head_dim-256 flash rows: one call of
    `torch.nn.attention.flex_attention.flex_attention` under
    `torch.compile`, with the softcap as `score_mod` and causal, window and
    length as `block_mask`, timed on the row's inputs (the port never calls
    it). {"library_ms", "library", "library_max_abs_err"}; where it does not
    run on this torch, library_ms is None and "library" the error."""
    import torch

    # inductor's and Triton's caches stay inside the checkout
    cache = Path(__file__).resolve().parent / "build" / "compile_cache"
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(cache / "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")
    what = (f"flex_attention under torch.compile: score_mod tanh(s / {cap}) * {cap}, "
            f"block_mask causal & k < length" + (f" & q - k < {window}" if window else ""))
    try:
        from torch.nn.attention.flex_attention import create_block_mask, flex_attention

        B, _, S, _ = q.shape

        def score_mod(score, b, h, qi, ki):
            return torch.tanh(score / cap) * cap

        def mask_mod(b, h, qi, ki):
            m = (ki <= qi) & (ki < lens[b])
            return m & (qi - ki < window) if window else m

        block_mask = create_block_mask(mask_mod, B, None, S, S, device=q.device)
        flex = torch.compile(flex_attention)

        def call():
            return flex(q, k, v, score_mod=score_mod, block_mask=block_mask, scale=scale,
                        enable_gqa=True)

        out = call()
        torch.cuda.synchronize()
        keep = lens > 0  # a prompt that sees no key is not compared: the port emits 0
        err = (out[keep].float() - ref[keep].float()).abs().max()
        return {"library_ms": time_ms(call, iters), "library": what,
                "library_max_abs_err": err.item()}
    except Exception as e:  # noqa: BLE001 - the yardstick's failure is the reason recorded
        log(f"flex_attention yardstick failed: {type(e).__name__}: {e}")
        return {"library_ms": None,
                "library": f"none: {what} failed here: {type(e).__name__}: {str(e)[:400]}"}


# ptxas's report of the head_dim-256 kernel (registers, spills) and its
# dynamic shared memory, filled in by the build; its rows carry it
HD256_PTXAS: dict = {}
# Gemma-2-9B's attention (configs.py): 16 query heads over 8 KV heads,
# head_dim 256, score softcap 50, scale 224**-0.5, a 4096-token window on
# alternate layers
GEMMA_HEADS = (16, 8, 256)
GEMMA_SOFTCAP, GEMMA_SCALE, GEMMA_WINDOW = 50.0, 224.0**-0.5, 4096


def kernel_phase_hd256(library: bool = True) -> dict[str, dict]:
    """Flash prefill at head_dim 256 (`flash_prefill_hd256.cu`) against its
    plain version at Gemma-2-9B's attention:

      - `flash_prefill_attention_hd256`: one 8192-token prompt (a
        whole-prompt admission), a sliding layer (window 4096); the global
        layer checked and timed beside (`global_layer`);
      - `flash_prefill_attention_hd256_admit`: Gemma-2's admission shape on
        the served path (`prefill_chunk` 512): 4 prompts in a 512 bucket,
        lengths 512/400/300/200 as the `flash_prefill_attention` row; a
        global layer (a 4096-token window masks the same keys there).

    Both are held to bit-equal repeats; `library` adds flex_attention's
    time (`_flex_library`). Each row's `counter` is the LAUNCHES name its
    launches count under."""
    import torch

    from llm_mcp_tpu_torch.kernels import attention as K

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1515)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    res: dict[str, dict] = {}
    H, Hkv, hd = GEMMA_HEADS
    name = "flash_prefill_attention_hd256"
    for row, B, S, lens, windows in (
            (name, 1, 8192, [8192], (0, GEMMA_WINDOW)),  # the timed row last: sliding
            (name + "_admit", 4, 512, [512, 400, 300, 200], (0,))):
        qp, kp, vp = rn(B, H, S, hd), rn(B, Hkv, S, hd), rn(B, Hkv, S, hd)
        lp = i32(lens)
        fbytes = (2 * qp.numel() + 2 * kp.numel()) * 2
        glob = {}
        for win in windows:
            kw = dict(window=win, softcap=GEMMA_SOFTCAP, scale=GEMMA_SCALE)
            call = functools.partial(K.flash_prefill_attention, qp, kp, vp, lp, **kw)
            plain = functools.partial(K.flash_prefill_plain, qp, kp, vp, lp, **kw)
            out, ref = call(), plain()
            pairs = sum(min(t + 1, n, win) if win else min(t + 1, n)
                        for n in lens for t in range(S))
            ops_ms = 4.0 * hd * H * pairs / BF16_FLOPS * 1e3
            ms = time_ms(call, 10 if S > 1024 else 20)
            repeats = repeat_check(row, call)
            lib = (_flex_library(qp, kp, vp, lp, ref, win, GEMMA_SOFTCAP, GEMMA_SCALE,
                                 10 if S > 1024 else 20)
                   if library else {"library_ms": None, "library": "not timed in this run"})
            if row == name and not win:
                err, ratio = compare(row, out, ref)
                glob = {"max_abs_err": err, "worst_err_over_limit": ratio, "ms": ms,
                        "bound_ms": max(fbytes / HBM_BYTES_PER_S * 1e3, ops_ms),
                        "repeats_bitwise": repeats, **lib}
                log(f"{row} global layer: {json.dumps(glob)}")
                continue
            _record(res, row, out, ref, ms, time_ms(plain, 2 if S > 1024 else 10), fbytes,
                    ops_ms, lib["library_ms"],
                    {"q": [B, H, S, hd], "kv_heads": Hkv, "lengths": lens, "window": win,
                     "softcap": GEMMA_SOFTCAP, "scale": GEMMA_SCALE, "library": lib["library"],
                     **({"global_layer": glob} if glob else {})})
            res[row].update(counter=name, repeats_bitwise=repeats, ptxas=HD256_PTXAS,
                            **{k: v for k, v in lib.items() if k != "library_ms"})
        del qp, kp, vp
    return res


def kernel_phase_families() -> dict[str, dict]:
    """The kernel arms the decoder families add, against their plain
    versions at the served families' shapes:

      - flash prefill at head_dim 256, Gemma-2-9B's attention:
        `kernel_phase_hd256`;
      - ragged prefill, bf16 and int8, identity and 64-token block tables,
        at Qwen2.5-7B's heads (28 over 4: G = 7) and R1-Distill-Qwen-1.5B's
        (12 over 2: G = 6), which do not divide the tile's 64 rows: the
        Llama row's packing (T = 2048, prefixes 0-1536);
      - decode, bf16 and int8, contiguous and paged, at G = 7 (Qwen2.5-7B):
        the Llama rows' fills over 4096 keys.

    Each row's `counter` is the LAUNCHES name its launches count under."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1515)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    res = kernel_phase_hd256()
    _gqa_arm_rows(res, rn, i32, dev, 128, ((7, 4, "qwen2.5-7b"),
                                           (6, 2, "deepseek-r1-distill-qwen-1.5b")),
                  ((7, 4, "qwen2.5-7b"),), "")
    return res


def _gqa_arm_rows(res, rn, i32, dev, hd, ragged_cases, decode_cases, suffix) -> None:
    """Rows of the ragged prefill (bf16 and int8, identity and 64-token block
    tables, the Llama row's packing: T = 2048, prefixes 0-1536) and decode
    (bf16 and int8, contiguous and paged, the Llama rows' fills over 4096
    keys) kernels at head_dim `hd`, for each (G, Hkv, model) of
    `ragged_cases` / `decode_cases`: row `<counter>` with `_g<G>` after the
    arm and `suffix` after it all, counting under `<counter>`. Each row's
    library call is SDPA; each ragged row is also held to bit-equal
    repeats."""
    import torch
    import torch.nn.functional as F

    from llm_mcp_tpu_torch.kernels import attention as K
    from llm_mcp_tpu_torch.models.llama import fuse_prompt_kv

    record = functools.partial(_record, res)

    L, B, S, bt = 2, 8, 4096, BLOCK_TOKENS
    qscale = hd**-0.5
    T, R = 2048, 4
    starts, ns = [0, 512, 1024, 1536], [500, 480, 460, 460]
    n_pad = T - sum(ns)
    rowids = i32(sum(([r] * n for r, n in enumerate(ns)), []) + [R] * n_pad)
    offsets = i32([sum(ns[:r]) for r in range(R + 1)])
    slots, st = i32([2, 5, 0, 7]), i32(starts)
    past = sum(s_ * n for s_, n in zip(starts, ns))
    selfp = sum(n * (n + 1) // 2 for n in ns) + n_pad * (n_pad + 1) // 2
    nbs, nsh = S // bt, SHARED_TOKENS // bt
    tbl = torch.arange(B * nbs, dtype=torch.int32, device=dev).reshape(B, nbs)
    tbl[:, :nsh] = B * nbs + torch.arange(nsh, dtype=torch.int32, device=dev)
    for b in range(B):  # block nsh of row b lives in row (b + 3) % B's home
        tbl[b, nsh] = ((b + 3) % B) * nbs + nsh

    def caches(Hkv):
        """bf16 caches [L, B, Hkv, S, hd], the same in the fused int8 form,
        and the prefix pool of each (row 0's first SHARED_TOKENS)."""
        ck, cv = rn(L, B, Hkv, S, hd), rn(L, B, Hkv, S, hd)
        fused = {"q": torch.empty((L, B, 2 * Hkv + 1, S, hd), dtype=torch.int8, device=dev),
                 "s": torch.empty((L, B, 2 * Hkv, S), dtype=torch.bfloat16, device=dev)}
        for li in range(L):
            e = fuse_prompt_kv(ck[li], cv[li])
            fused["q"][li], fused["s"][li] = e["q"], e["s"]

        def pool(x):
            return (x[:, 0, :, : nsh * bt].reshape(L, x.shape[2], nsh, bt, *x.shape[4:])
                    .transpose(1, 2).contiguous())

        return ck, cv, fused, pool(ck), pool(cv), {k: pool(v) for k, v in fused.items()}

    def rows_of(x, pool, rows, paged):
        """Layer 1's rows `rows` of cache `x`, through the tables if paged."""
        return K.paged_gather(x[1], pool[1], tbl[rows.long()]) if paged else x[1][rows.long()]

    def kv_of(fused, pool8, rows, paged, Hkv):
        """K and V of those rows of the fused int8 cache, dequantized to bf16
        (the library call's inputs)."""
        pay, ss = rows_of(fused["q"], pool8["q"], rows, paged), rows_of(
            fused["s"], pool8["s"], rows, paged)
        return ((pay[:, :Hkv].float() * ss[:, :Hkv, :, None].float()).to(torch.bfloat16),
                (pay[:, Hkv:2 * Hkv].float() * ss[:, Hkv:, :, None].float()).to(torch.bfloat16))

    for G, Hkv, model in ragged_cases:
        H = Hkv * G
        qr, kr, vr = rn(T, Hkv, G, hd), rn(T, Hkv, hd), rn(T, Hkv, hd)
        ck, cv, fused, pool_k, pool_v, pool8 = caches(Hkv)
        for arm in ("bf16", "q8"):
            for paged in (False, True):
                base = f"ragged_prefill_attend_{arm}" + ("_paged" if paged else "")
                counter, name = base + suffix, base.replace(arm, f"{arm}_g{G}") + suffix
                if arm == "bf16":
                    args = (qr, kr, vr, ck, cv, 1, rowids, offsets, slots, st)
                    pkw = dict(block_tables=tbl, pool_k=pool_k, pool_v=pool_v) if paged else {}
                    call = functools.partial(K.ragged_prefill_attend_bf16, *args, scale=qscale,
                                             **pkw)
                    plain = (functools.partial(K.ragged_prefill_paged_plain, *args, tbl, pool_k,
                                               pool_v, qscale) if paged else
                             functools.partial(K.ragged_prefill_plain, *args, scale=qscale))
                    kg, vg = rows_of(ck, pool_k, slots, paged), rows_of(cv, pool_v, slots, paged)
                    nbytes = (2 * qr.numel() + 2 * kr.numel() + 2 * sum(starts) * Hkv * hd) * 2
                    ops_ms = 4.0 * hd * H * (past + selfp) / BF16_FLOPS * 1e3
                else:
                    args = (qr, kr, vr, fused, 1, rowids, offsets, slots, st)
                    call = functools.partial(K.ragged_prefill_attend_q8, *args, scale=qscale,
                                             **(dict(block_tables=tbl, pool=pool8) if paged
                                                else {}))
                    plain = functools.partial(K.ragged_prefill_q8_plain, *args, qscale,
                                              *((tbl, pool8) if paged else ()))
                    kg, vg = kv_of(fused, pool8, slots, paged, Hkv)
                    nbytes = ((2 * qr.numel() + 2 * kr.numel()) * 2
                              + sum(starts) * Hkv * (2 * hd + 2 * 2))
                    ops_ms = (4.0 * hd * H * past / INT8_OPS
                              + 4.0 * hd * H * selfp / BF16_FLOPS) * 1e3
                if paged:
                    nbytes += sum(-(-s_ // bt) for s_ in starts) * 4
                lib = _ragged_sdpa(qr, kr, vr, rowids, starts, kg, vg)
                record(name, call(), plain(), time_ms(call, 10), time_ms(plain, 3), nbytes,
                       ops_ms, time_ms(lib, 10),
                       {"model": model, "q": [T, Hkv, G, hd], "tile_tokens": 64 // G,
                        "tile_rows": 64 // G * G, "tokens": ns, "pads": n_pad,
                        "starts": starts, "block_tokens": bt if paged else 0,
                        "library": "SDPA, one call, block-causal mask over the prefixes "
                                   "(dequantized to bf16 for int8) and the chunk"})
                res[name].update(counter=counter, repeats_bitwise=repeat_check(name, call))
                del lib, kg, vg
        del ck, cv, fused, pool_k, pool_v, pool8

    for G, Hkv, model in decode_cases:
        H = Hkv * G
        q, nk1, nv1 = rn(B, Hkv, G, hd), rn(B, Hkv, hd), rn(B, Hkv, hd)
        lens = i32([511, 1023, 1535, 2047, S, 3071, 3583, 4095])
        ids = i32([3, 0, 7, 1, 6, 2, 5, 4])
        keys = sum(w + 1 if w < S else 1 for w in lens.tolist())
        live = lens < S
        rows_ = torch.arange(B, device=dev)[live]
        qs = q.reshape(B, H, 1, hd)
        pos = torch.arange(S, device=dev)[None, :]
        amask = torch.where(live[:, None], pos <= lens[:, None], pos < 1)[:, None, None, :]
        ck, cv, fused, pool_k, pool_v, pool8 = caches(Hkv)

        def sdpa_rows(kk, vv):
            kk, vv = kk.clone(), vv.clone()
            kk[rows_, :, lens.long()[live]] = nk1[live]
            vv[rows_, :, lens.long()[live]] = nv1[live]
            return lambda: F.scaled_dot_product_attention(qs, kk, vv, attn_mask=amask,
                                                          enable_gqa=True)

        for arm in ("bf16", "q8"):
            for paged in (False, True):
                base = f"decode_attend_{arm}" + ("_paged" if paged else "")
                counter, name = base + suffix, base.replace(arm, f"{arm}_g{G}") + suffix
                if arm == "bf16":
                    pkw = dict(block_tables=tbl, pool_k=pool_k, pool_v=pool_v) if paged else {}
                    call = functools.partial(K.decode_attend_bf16, q, nk1, nv1, ck, cv, 1,
                                             lens, slot_ids=ids, scale=qscale, **pkw)
                    plain = (functools.partial(K.decode_attend_paged_plain, q, nk1, nv1, ck, cv,
                                               1, lens, tbl, pool_k, pool_v, ids, qscale)
                             if paged else
                             functools.partial(K.decode_attend_plain, q, nk1, nv1, ck, cv, 1,
                                               lens, ids, qscale))
                    kk, vv = rows_of(ck, pool_k, ids, paged), rows_of(cv, pool_v, ids, paged)
                    nbytes = keys * Hkv * hd * 2 * 2 + (2 * q.numel() + 2 * nk1.numel()) * 2
                    ops_ms = 4.0 * hd * H * keys / BF16_FLOPS * 1e3
                else:
                    pkw = dict(block_tables=tbl, pool_k=pool8) if paged else {}
                    call = functools.partial(K.decode_attend_q8, q, nk1, nv1, fused, {}, 1,
                                             lens, slot_ids=ids, scale=qscale, **pkw)
                    plain = functools.partial(
                        K.decode_attend_q8_plain, q, nk1, nv1, fused, 1, lens, ids, qscale,
                        *((bt, tbl, pool8) if paged else (K.q8_group(S),)))
                    kk, vv = kv_of(fused, pool8, ids, paged, Hkv)
                    nbytes = (keys * Hkv * (2 * hd + 2 * 2)
                              + (2 * q.numel() + 2 * nk1.numel()) * 2)
                    ops_ms = 4.0 * hd * H * keys / INT8_OPS * 1e3
                if paged:
                    nbytes += sum(-(-(w + 1) // bt) if w < S else 0 for w in lens.tolist()) * 4
                lib = sdpa_rows(kk, vv)
                record(name, call(), plain(), time_ms(call, 50), time_ms(plain, 5), nbytes,
                       ops_ms, time_ms(lib, 50),
                       {"model": model, "q": [B, Hkv, G, hd], "cache": [L, B, Hkv, S, hd],
                        "lengths": lens.tolist(), "slot_ids": ids.tolist(),
                        "block_tokens": bt if paged else 0,
                        "library": "SDPA, length mask, the rows (dequantized to bf16 for int8, "
                                   "gathered through the tables when paged)"})
                res[name]["counter"] = counter
                del lib, kk, vv


def kernel_phase_hd64() -> dict[str, dict]:
    """The head_dim-64 arms (Llama-3.2-1B: 32 query heads over 8 KV heads,
    G = 4; Qwen2.5-0.5B: 14 over 2, G = 7) against their plain versions:

      - flash prefill at Llama-3.2-1B's heads and the shape of the
        `flash_prefill_attention` row (4 prompts in a 512 bucket);
      - ragged prefill and decode, bf16 and int8, contiguous and paged, at
        G = 4 (8 KV heads) and G = 7 (2 KV heads): `_gqa_arm_rows`;
      - the fused appends (bf16 at G = 4, int8 at G = 7), bit for bit, the
        64-byte packed-scale row included; the standalone int8 append is
        built for 128, so its plain version stands in for it;
      - the int8 whole-row arm at S = ROW_S and Llama-3.2-1B's heads, timed
        cold over ROW_LAYERS layers;
      - the post-append decode at Llama-3.2-1B's heads.

    Each row's `counter` is the LAUNCHES name its launches count under; the
    prefill rows are held to bit-equal repeats."""
    import torch
    import torch.nn.functional as F

    from llm_mcp_tpu_torch.kernels import attention as K
    from llm_mcp_tpu_torch.models.llama import fuse_prompt_kv

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1616)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    res: dict[str, dict] = {}
    record = functools.partial(_record, res)
    hd, Hkv, G = 64, 8, 4  # Llama-3.2-1B
    H, scale = Hkv * G, hd**-0.5

    # -- flash prefill: an admission batch of 4 prompts in a 512 bucket --
    Bp, Sp = 4, 512
    qp, kp, vp = rn(Bp, H, Sp, hd), rn(Bp, Hkv, Sp, hd), rn(Bp, Hkv, Sp, hd)
    lp = i32([512, 400, 300, 200])
    call = functools.partial(K.flash_prefill_attention, qp, kp, vp, lp, scale=scale)
    plain = functools.partial(K.flash_prefill_plain, qp, kp, vp, lp, scale=scale)
    pairs = sum(min(t + 1, n) for n in lp.tolist() for t in range(Sp))
    kx, vx = kp.repeat_interleave(G, 1), vp.repeat_interleave(G, 1)
    record("flash_prefill_attention_hd64", call(), plain(), time_ms(call, 20),
           time_ms(plain, 10), (2 * qp.numel() + 2 * kp.numel()) * 2,
           4.0 * hd * H * pairs / BF16_FLOPS * 1e3,
           time_ms(lambda: F.scaled_dot_product_attention(qp, kx, vx, is_causal=True), 20),
           {"model": "llama-3.2-1b", "q": [Bp, H, Sp, hd], "kv_heads": Hkv,
            "lengths": lp.tolist()})
    res["flash_prefill_attention_hd64"].update(
        counter="flash_prefill_attention_hd64",
        repeats_bitwise=repeat_check("flash_prefill_attention_hd64", call))
    del qp, kp, vp, kx, vx

    # -- ragged prefill and decode at G = 4 and 7 --
    cases = ((4, 8, "llama-3.2-1b"), (7, 2, "qwen2.5-0.5b"))
    _gqa_arm_rows(res, rn, i32, dev, hd, cases, cases, "_hd64")

    # -- the fused appends, on two layers (layer 1 written) --
    L, B, S = 2, 8, 4096
    lens = i32([511, 1023, 1535, 2047, S, 3071, 3583, 4095])
    ids = i32([3, 0, 7, 1, 6, 2, 5, 4])
    live = lens < S
    for arm, (G_, Hkv_) in (("bf16", (4, 8)), ("q8", (7, 2))):
        q, nk1, nv1 = rn(B, Hkv_, G_, hd), rn(B, Hkv_, hd), rn(B, Hkv_, hd)
        ck, cv = rn(L, B, Hkv_, S, hd), rn(L, B, Hkv_, S, hd)
        name = f"append_kv_{arm}_fused_hd64"
        if arm == "bf16":
            check = fused_append_check(
                name,
                lambda c, append: K.decode_attend_bf16(q, nk1, nv1, c["k"], c["v"], 1, lens,
                                                       slot_ids=ids, scale=scale, append=append),
                lambda c: K.append_kv_bf16(c["k"][1:2], c["v"][1:2], nk1[None], nv1[None],
                                           lens, slot_ids=ids),
                lambda c: K.append_kv_plain(c["k"][1:2], c["v"][1:2], nk1[None], nv1[None],
                                            lens, ids),
                {"k": ck, "v": cv}, timed=True)
            nbytes = 4 * int(live.sum()) * Hkv_ * hd * 2
        else:
            fused = {"q": torch.empty((L, B, 2 * Hkv_ + 1, S, hd), dtype=torch.int8, device=dev),
                     "s": torch.empty((L, B, 2 * Hkv_, S), dtype=torch.bfloat16, device=dev)}
            for li in range(L):
                e = fuse_prompt_kv(ck[li], cv[li])
                fused["q"][li], fused["s"][li] = e["q"], e["s"]
            # the packed rows the append rewrites hold stale bytes first, so
            # that a byte it leaves unwritten shows
            rl, wl = ids.long()[live], lens.long()[live]
            fused["q"][1, rl, 2 * Hkv_, wl] = torch.randint(
                -127, 128, (len(rl), hd), generator=g, device=dev, dtype=torch.int8)

            def plain_q8(c):
                K.append_kv_q8_plain({k: v[1:2] for k, v in c.items()}, nk1[None], nv1[None],
                                     lens, ids)

            check = fused_append_check(
                name,
                lambda c, append: K.decode_attend_q8(q, nk1, nv1, c, {}, 1, lens, slot_ids=ids,
                                                     scale=scale, append=append),
                plain_q8, plain_q8, fused, timed=True)
            nbytes = int(live.sum()) * (2 * Hkv_ * hd * 2 + (2 * Hkv_ + 1) * hd + 2 * Hkv_ * 2)
        _fused_row(res, name, check, nbytes,
                   {"decode": f"decode_attend_{arm} at G = {G_}, {Hkv_} KV heads",
                    "layers_written": 1, "lengths": lens.tolist(), "slot_ids": ids.tolist(),
                    "ms": "decode call with the write minus without",
                    "standalone": "append_kv_bf16" if arm == "bf16" else
                                  "the plain append (the int8 append kernel is built for 128)",
                    "library": "none: the rows' write fused into the decode call"})
        res[name]["counter"] = name
        del ck, cv

    # -- the int8 whole row: S = ROW_S, which no int8 group divides --
    Sr = ROW_S
    q, nk1, nv1 = rn(B, Hkv, G, hd), rn(B, Hkv, hd), rn(B, Hkv, hd)
    rc = {"q": torch.empty((ROW_LAYERS, B, 2 * Hkv + 1, Sr, hd), dtype=torch.int8, device=dev),
          "s": torch.empty((ROW_LAYERS, B, 2 * Hkv, Sr), dtype=torch.bfloat16, device=dev)}
    for li in range(ROW_LAYERS):
        e = fuse_prompt_kv(rn(B, Hkv, Sr, hd), rn(B, Hkv, Sr, hd))
        rc["q"][li], rc["s"][li] = e["q"], e["s"]
    rlens = i32([124, 249, 374, 499, Sr, 749, 874, Sr - 1])
    if K.q8_decode_plan(Sr, hd, Hkv, H)[0] != Sr:
        check_failed(f"decode_attend_q8_row_hd64: the plan at S={Sr} is not the whole row")
    before = K.LAUNCHES["decode_attend_q8_row_hd64"]
    out = K.decode_attend_q8(q, nk1, nv1, rc, {}, 1, rlens, slot_ids=ids, scale=scale)
    if K.LAUNCHES["decode_attend_q8_row_hd64"] != before + 1:
        check_failed("decode_attend_q8_row_hd64: the call did not take the whole-row arm")
    ref = K.decode_attend_q8_plain(q, nk1, nv1, rc, 1, rlens, ids, scale, Sr)
    rkeys = sum(w + 1 if w < Sr else 1 for w in rlens.tolist())
    rlive = rlens < Sr
    rpos = torch.arange(Sr, device=dev)[None, :]
    rmask = torch.where(rlive[:, None], rpos <= rlens[:, None], rpos < 1)[:, None, None, :]
    pay, ss = rc["q"][1][ids.long()], rc["s"][1][ids.long()].float()
    kd = (pay[:, :Hkv].float() * ss[:, :Hkv, :, None]).to(torch.bfloat16)
    vd = (pay[:, Hkv:2 * Hkv].float() * ss[:, Hkv:, :, None]).to(torch.bfloat16)
    rrows = torch.arange(B, device=dev)[rlive]
    kd[rrows, :, rlens.long()[rlive]] = nk1[rlive]
    vd[rrows, :, rlens.long()[rlive]] = nv1[rlive]
    qs = q.reshape(B, H, 1, hd)
    cold, warm = cold_warm_ms(lambda li: K.decode_attend_q8(
        q, nk1, nv1, rc, {}, li, rlens, slot_ids=ids, scale=scale), ROW_LAYERS, 64)
    record(
        "decode_attend_q8_row_hd64", out, ref, cold,
        time_ms(lambda: K.decode_attend_q8_plain(q, nk1, nv1, rc, 1, rlens, ids, scale, Sr), 10),
        rkeys * Hkv * (2 * hd + 2 * 2) + (2 * q.numel() + 2 * nk1.numel()) * 2,
        4.0 * hd * G * Hkv * rkeys / INT8_OPS * 1e3,
        time_ms(lambda: F.scaled_dot_product_attention(qs, kd, vd, attn_mask=rmask,
                                                       enable_gqa=True), 50),
        {"model": "llama-3.2-1b", "q": [B, Hkv, G, hd], "cache": [ROW_LAYERS, B, 2 * Hkv + 1,
                                                                  Sr, hd],
         "lengths": rlens.tolist(), "slot_ids": ids.tolist(), "group": Sr,
         "timing": f"ms cold: the layer turned over {ROW_LAYERS} layers; warm_ms: layer 1",
         "library": "SDPA, length mask, on the rows dequantized to bf16"})
    res["decode_attend_q8_row_hd64"].update(warm_ms=warm, counter="decode_attend_q8_row_hd64")
    del rc, kd, vd, pay, ss

    # -- the post-append decode: the decode rows' lengths, inclusive --
    ck, cv = rn(B, Hkv, S, hd), rn(B, Hkv, S, hd)
    q = rn(B, Hkv, G, hd)
    keys = sum(min(w, S - 1) + 1 for w in lens.tolist())
    pmask = (torch.arange(S, device=dev)[None, :] <= lens[:, None])[:, None, None, :]
    qs = q.reshape(B, H, 1, hd)
    record("decode_attention_hd64", K.decode_attention(q, ck, cv, lens),
           K.decode_attention_plain(q, ck, cv, lens),
           time_ms(lambda: K.decode_attention(q, ck, cv, lens), 50),
           time_ms(lambda: K.decode_attention_plain(q, ck, cv, lens), 10),
           keys * Hkv * hd * 2 * 2 + 2 * q.numel() * 2,
           4.0 * hd * G * Hkv * keys / BF16_FLOPS * 1e3,
           time_ms(lambda: F.scaled_dot_product_attention(
               qs, ck, cv, attn_mask=pmask, enable_gqa=True), 50),
           {"model": "llama-3.2-1b", "q": [B, Hkv, G, hd], "cache": [B, Hkv, S, hd],
            "lengths": lens.tolist(), "library": "SDPA, inclusive length mask, same rows",
            "served": "none: no model, engine or API of either package calls it"})
    res["decode_attention_hd64"]["counter"] = "decode_attention_hd64"
    del ck, cv
    torch.cuda.empty_cache()
    return res


def int8_gemm_phase() -> dict:
    """The int8 GEMM behind `qdot` (`torch._int_mm`) at the decode step's
    shapes (32 padded rows; Llama-3.1-8B's wqkv, wo, w13 and w2), with the
    payload row-major [K, N] and K-contiguous (`quant.gemm_layout`, what
    the engine stores), beside the bf16 product of the same shape: the
    measurement behind the layout choice. Both layouts must give the same
    int32 result."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(99)
    M, out = 32, {}
    sums = {"row_major_ms": 0.0, "k_contiguous_ms": 0.0, "bf16_ms": 0.0}
    for name, (Kd, N) in {"wqkv": (4096, 6144), "wo": (4096, 4096), "w13": (4096, 28672),
                          "w2": (14336, 4096)}.items():
        a = torch.randint(-127, 128, (M, Kd), generator=g, device=dev, dtype=torch.int8)
        b = torch.randint(-127, 128, (Kd, N), generator=g, device=dev, dtype=torch.int8)
        bk = b.t().contiguous().t()
        xa = torch.randn((M, Kd), generator=g, device=dev).to(torch.bfloat16)
        wb = torch.randn((Kd, N), generator=g, device=dev).to(torch.bfloat16)
        if not torch.equal(torch._int_mm(a, b), torch._int_mm(a, bk)):
            check_failed(f"int8 GEMM {name}: the two layouts give different products")
        row = {"row_major_ms": time_ms(lambda: torch._int_mm(a, b), 20),
               "k_contiguous_ms": time_ms(lambda: torch._int_mm(a, bk), 20),
               "bf16_ms": time_ms(lambda: xa @ wb, 20),
               "int8_bound_ms": Kd * N / HBM_BYTES_PER_S * 1e3}
        out[name] = row
        for k in sums:
            sums[k] += row[k]
        del a, b, bk, xa, wb
    out["per_layer_sum"] = sums
    log(f"int8 GEMM at M = {M}: {json.dumps(out)}")
    return out


def _tree(fn, *trees):
    """fn over the leaves of KV trees of one structure (a tensor, or the
    fused int8 cache's dict)."""
    if isinstance(trees[0], dict):
        return {k: fn(*(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def post_scan_step(cfg, params, ck, cv, tokens, lengths, slot_ids=None, paged=None,
                   plain=False):
    """`llama_decode_step` with JAX's structure: the decode calls append
    nothing, their K/V rows are kept, and the standalone append (with
    `plain`, its plain version) writes all layers' rows after the last
    layer. Returns (logits, ck, cv)."""
    import torch

    from llm_mcp_tpu_torch.kernels import attention as K
    from llm_mcp_tpu_torch.models import llama as TL

    name = "decode_attend_q8" if isinstance(ck, dict) else "decode_attend_bf16"
    orig = getattr(TL, name)
    rows: dict[int, tuple] = {}

    def no_append(q, nk, nv, c_k, c_v, layer, lens, **kw):
        kw.pop("append")
        rows[int(layer)] = (nk, nv)
        return orig(q, nk, nv, c_k, c_v, layer, lens, **kw)

    setattr(TL, name, no_append)
    try:
        logits, ck, cv = TL.llama_decode_step(cfg, params, ck, cv, tokens, lengths,
                                              slot_ids=slot_ids, paged=paged)
    finally:
        setattr(TL, name, orig)
    nk = torch.stack([rows[li][0] for li in sorted(rows)])
    nv = torch.stack([rows[li][1] for li in sorted(rows)])
    if not plain:
        (K.append_kv_q8 if isinstance(ck, dict) else K.append_kv_bf16)(
            ck, cv, nk, nv, lengths, slot_ids=slot_ids)
    elif isinstance(ck, dict):
        K.append_kv_q8_plain(ck, nk, nv, lengths, slot_ids)
    else:
        K.append_kv_plain(ck, cv, nk, nv, lengths, slot_ids)
    return logits, ck, cv


def model_check(cfg, params, dev, quantized: bool = False) -> dict:
    """The model's first CHECK_LAYERS layers (published widths, the served
    weights) on a small input: prefill, one decode step with a parked row
    and one ragged chunk with pads, unpaged and paged, through the kernels
    on the card and through the plain versions on the host CPU, which the
    wrappers take for CPU tensors. The paged calls read row 0's first block
    from a pool row while its arena block holds other values; on the card
    each must also agree with the same call on the contiguous rows that
    hold the same bytes. `quantized`: int8 weights (the served ones) and
    the fused int8 KV cache; the caches are compared as their int8 K|V
    payload heads and their scales."""
    import dataclasses

    import torch

    from llm_mcp_tpu_torch.executor.physical import pool_like
    from llm_mcp_tpu_torch.kernels import attention as K
    from llm_mcp_tpu_torch.models import llama as TL

    cut = dataclasses.replace(cfg, n_layers=CHECK_LAYERS)
    host = torch.device("cpu")
    Hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim

    def first_layers(d):
        sub = {k: _tree(lambda v: v.to(d), v) for k, v in params.items() if k != "layers"}
        sub["layers"] = {k: _tree(lambda v: v[:CHECK_LAYERS].to(d), v)
                         for k, v in params["layers"].items()}
        return sub

    g = torch.Generator().manual_seed(7)
    P0, S, bt = 40, 256, BLOCK_TOKENS
    nbs = S // bt
    toks = torch.randint(3, 259, (1, 64), generator=g, dtype=torch.int32)
    chunk = torch.randint(3, 259, (32,), generator=g, dtype=torch.int32)
    junk = torch.randn((CHECK_LAYERS, 1, Hkv, bt, hd), generator=g)
    if quantized:  # other values for the overwritten arena block, as the cache holds them
        junk = TL.fuse_prompt_kv(junk.to(torch.bfloat16), -junk.to(torch.bfloat16))

    def run(d):
        p = first_layers(d)

        def i32(x):
            return torch.as_tensor(x, dtype=torch.int32, device=d)

        logits_p, ks, vs = TL.llama_prefill(cut, p, toks.to(d), i32([P0]), quant_kv=quantized)
        cache = TL.init_kv_cache(cut, 2, S, dtype=torch.bfloat16, device=d, quantized=quantized)
        for n, new in (("k", ks), ("v", vs)):
            _tree(lambda c, x: c[:, 0, :, :64].copy_(x[:, 0]), cache[n], new)
        # paged copy: row 0's block 0 moves to pool row 1 and its arena
        # block is overwritten
        pool, paged_cache = {}, {}
        for n in ("k", "v"):
            pool[n] = pool_like(cache[n], 2, bt)
            _tree(lambda pl, c: pl[:, 1].copy_(c[:, 0, :, :bt]), pool[n], cache[n])
            paged_cache[n] = _tree(lambda c: c.clone(), cache[n])
            _tree(lambda c, j: c[:, 0, :, :bt].copy_(j[:, 0]), paged_cache[n],
                  _tree(lambda j: j.to(d), junk) if n == "k" or not quantized else {})
        tbl = torch.arange(2 * nbs, dtype=torch.int32).reshape(2, nbs)
        tbl[0, 0] = 2 * nbs + 1
        paged = {"tbl": tbl.to(d), "k": pool["k"], "v": pool["v"]}
        out = {"prefill": logits_p}
        # a fixed token, not the argmax: near-ties among 128k random logits
        # may round to another winner on the two sides
        for tag, src, pg in (("", cache, None), ("_paged", paged_cache, paged)):
            ck, cv = (_tree(lambda c: c.clone(), src[n]) for n in ("k", "v"))
            logits_d, ck, cv = TL.llama_decode_step(
                cut, p, ck, cv, i32([65, 65]), i32([P0, S]), paged=pg)  # row 1 parked
            # the fused appends against the post-scan append, standalone and
            # plain, bit for bit
            for against in ("standalone", "plain") if d.type == "cuda" else ():
                sk, sv = (_tree(lambda c: c.clone(), src[n]) for n in ("k", "v"))
                logits_s, sk, sv = post_scan_step(cut, p, sk, sv, i32([65, 65]), i32([P0, S]),
                                                  paged=pg, plain=against == "plain")
                same = {"logits": torch.equal(logits_s, logits_d)}
                for n, a, b in (("k", ck, sk), ("v", cv, sv)):
                    la = a if isinstance(a, dict) else {"": a}
                    lb = b if isinstance(b, dict) else {"": b}
                    same.update({n + k: torch.equal(la[k], lb[k]) for k in la})
                fused_same[f"decode{tag}_{against}"] = same
            rk, rv = (_tree(lambda c: c.clone(), src[n]) for n in ("k", "v"))
            logits_r, rk, _ = TL.llama_prefill_chunk_ragged(
                cut, p, rk, rv, tokens=chunk.to(d),
                rowids=i32([0] * 20 + [1] * 12),
                positions=i32(list(range(P0, P0 + 20)) + [S] * 12),
                slots=i32([0]), starts=i32([P0]), last_idx=i32([19]), paged=pg)
            out["decode" + tag] = logits_d[:1]
            out["ragged" + tag] = logits_r
            if quantized:  # int8 K|V payload heads (as numbers) and scales
                out["decode_cache" + tag] = ck["q"][:, 0, : 2 * Hkv, P0]
                out["decode_scales" + tag] = ck["s"][:, 0, :, P0]
                out["ragged_cache" + tag] = rk["q"][:, 0, : 2 * Hkv, P0: P0 + 20]
                out["ragged_scales" + tag] = rk["s"][:, 0, :, P0: P0 + 20]
            else:
                out["decode_cache" + tag] = ck[:, 0, :, P0]  # the appended row
                out["ragged_cache" + tag] = rk[:, 0, :, P0: P0 + 20]  # the chunk's rows
        return out

    def cosine(a, b):
        a, b = a.float().cpu().flatten(), b.float().cpu().flatten()
        return (torch.nn.functional.cosine_similarity(a, b, dim=0).item(),
                (a - b).abs().max().item(), bool(torch.isfinite(a).all()))

    fused_same: dict[str, dict] = {}
    K.reset_launches()
    got = run(dev)
    torch.cuda.synchronize()
    per_call = {n: K.LAUNCHES[n] for n in (Q8_KERNELS if quantized
                                           else CHAT_KERNELS + PREFIX_KERNELS)}
    t0 = time.perf_counter()
    want = run(host)
    report = {"layers": CHECK_LAYERS, "quantized": quantized, "launches_in_check": per_call,
              "host_reference_s": time.perf_counter() - t0,
              "fused_append_equals_post_scan": fused_same}
    bad = []
    for name in got:
        cos, err, finite = cosine(got[name], want[name])
        report[name] = {"cosine": cos, "max_abs_err": err}
        if not finite or not cos >= MODEL_COSINE:
            bad.append(name)
    for name in [n for n in got if n.endswith("_paged")]:
        cos, err, _ = cosine(got[name], got[name[: -len("_paged")]])
        report[name]["vs_contiguous_on_card"] = {"cosine": cos, "max_abs_err": err}
        if not cos >= MODEL_COSINE:
            bad.append(f"{name} vs contiguous")
    log(f"model check{' int8' if quantized else ''}: {json.dumps(report)}")
    for name, n in per_call.items():
        if n <= 0:
            check_failed(f"model check: kernel {name} was not launched")
    unequal = {k: v for k, v in fused_same.items() if not all(v.values())}
    if unequal or len(fused_same) != 4:
        check_failed(f"model check: the decode step with the fused appends is not bit for bit "
                     f"the step with the post-scan append: {fused_same}")
    if bad:
        check_failed(f"model check: {bad} through the kernels disagree with the plain "
                     f"versions on the host or with the contiguous rows (finite values "
                     f"with cosine >= {MODEL_COSINE} wanted)")
    return report


def model_check_mla(cfg, params, dev, quantized: bool) -> dict:
    """DeepSeek-V2-Lite's first CHECK_LAYERS layers (the dense layer 0 and
    one MoE layer, published widths, the served weights) on a small input:
    prefill, one decode step with a parked row and one ragged chunk with
    pads, unpaged and paged, through the kernels on the card and through
    the plain versions on the host CPU; paged calls read row 0's first
    block from a pool row while its arena block holds other values, and on
    the card must equal the same calls through identity tables over the
    contiguous rows bit for bit: they read the same bytes in the same
    order (the int8 decode requantizes per table block, as JAX's paged
    arm, and per whole row without tables, as its whole-S arm, so it is
    not held against the call without tables). `quantized`: int8
    latents (decode through `decode_attend_q8_mla`, chunks through the int8
    ragged kernel), else bf16 latents (plain decode, the bf16 ragged
    kernel). Logits and written latents (int8 payloads as numbers, and
    their scales) by cosine."""
    import dataclasses

    import torch

    from llm_mcp_tpu_torch.executor.physical import pool_like
    from llm_mcp_tpu_torch.kernels import attention as K
    from llm_mcp_tpu_torch.models import llama as TL

    cut = dataclasses.replace(cfg, n_layers=CHECK_LAYERS)
    k_dense = cfg.first_dense_layers
    host = torch.device("cpu")

    def first_layers(d):
        sub = {k: _tree(lambda v: v.to(d), v) for k, v in params.items()
               if k not in ("layers", "dense_layers")}
        sub["dense_layers"] = {k: _tree(lambda v: v.to(d), v)
                               for k, v in params["dense_layers"].items()}
        sub["layers"] = {k: _tree(lambda v: v[: CHECK_LAYERS - k_dense].to(d), v)
                         for k, v in params["layers"].items()}
        return sub

    # the decode and chunk write past block 0, which is read from the pool:
    # the bf16 arm appends before it attends, and the engine never writes
    # into a block that a table maps to the pool (shared blocks are whole
    # prefix blocks; an unaligned boundary block is copied on write)
    g = torch.Generator().manual_seed(7)
    P0, S, bt = 72, 256, BLOCK_TOKENS
    nbs = S // bt
    toks = torch.randint(3, 259, (1, 128), generator=g, dtype=torch.int32)
    chunk = torch.randint(3, 259, (32,), generator=g, dtype=torch.int32)

    def junk_like(plane):
        """Other values for row 0's overwritten arena block, as the cache
        holds them."""
        if plane.dtype == torch.int8:
            return torch.randint(-127, 128, plane[:, :1, :, :bt].shape, generator=g,
                                 dtype=torch.int8)
        if plane.dim() == 4:  # int8 scales
            return (torch.rand(plane[:, :1, :, :bt].shape, generator=g) * 0.02).to(plane.dtype)
        return torch.randn(plane[:, :1, :, :bt].shape, generator=g).to(plane.dtype)

    shapes = TL.init_kv_cache(cut, 2, S, dtype=torch.bfloat16, quantized=quantized)
    junk = {n: _tree(junk_like, shapes[n]) for n in ("k", "v")}

    def run(d):
        p = first_layers(d)

        def i32(x):
            return torch.as_tensor(x, dtype=torch.int32, device=d)

        logits_p, c_new, r_new = TL.llama_prefill(cut, p, toks.to(d), i32([P0]),
                                                  quant_kv=quantized)
        cache = TL.init_kv_cache(cut, 2, S, dtype=torch.bfloat16, device=d, quantized=quantized)
        for n, new in (("k", c_new), ("v", r_new)):
            _tree(lambda c, x: c[:, 0, :, :128].copy_(x[:, 0]), cache[n], new)
        pool, paged_cache = {}, {}
        for n in ("k", "v"):
            pool[n] = pool_like(cache[n], 2, bt)
            _tree(lambda pl, c: pl[:, 1].copy_(c[:, 0, :, :bt]), pool[n], cache[n])
            paged_cache[n] = _tree(lambda c: c.clone(), cache[n])
            _tree(lambda c, j: c[:, 0, :, :bt].copy_(j[:, 0]), paged_cache[n],
                  _tree(lambda j: j.to(d), junk[n]))
        ident = torch.arange(2 * nbs, dtype=torch.int32).reshape(2, nbs)
        tbl = ident.clone()
        tbl[0, 0] = 2 * nbs + 1
        paged = {"tbl": tbl.to(d), "k": pool["k"], "v": pool["v"]}
        out = {"prefill": logits_p}
        for tag, src, pg in (("", cache, None), ("_paged", paged_cache, paged),
                             ("_ident", cache, dict(paged, tbl=ident.to(d)))):
            ck, cv = (_tree(lambda c: c.clone(), src[n]) for n in ("k", "v"))
            logits_d, ck, cv = TL.llama_decode_step(
                cut, p, ck, cv, i32([65, 65]), i32([P0, S]), paged=pg)  # row 1 parked
            rk, rv = (_tree(lambda c: c.clone(), src[n]) for n in ("k", "v"))
            logits_r, rk, rv = TL.llama_prefill_chunk_ragged(
                cut, p, rk, rv, tokens=chunk.to(d),
                rowids=i32([0] * 20 + [1] * 12),
                positions=i32(list(range(P0, P0 + 20)) + [S] * 12),
                slots=i32([0]), starts=i32([P0]), last_idx=i32([19]), paged=pg)
            out["decode" + tag] = logits_d[:1]
            out["ragged" + tag] = logits_r
            for name, plane, sl in (("decode_latent", ck, P0), ("decode_rope", cv, P0),
                                    ("ragged_latent", rk, slice(P0, P0 + 20)),
                                    ("ragged_rope", rv, slice(P0, P0 + 20))):
                if quantized:
                    out[name + tag] = plane["q"][:, 0, 0, sl]
                    out[name + "_scales" + tag] = plane["s"][:, 0, 0, sl]
                else:
                    out[name + tag] = plane[:, 0, 0, sl]
        return out

    def cosine(a, b):
        a, b = a.float().cpu().flatten(), b.float().cpu().flatten()
        return (torch.nn.functional.cosine_similarity(a, b, dim=0).item(),
                (a - b).abs().max().item(), bool(torch.isfinite(a).all()))

    K.reset_launches()
    got = run(dev)
    torch.cuda.synchronize()
    want_kernels = MLA_Q8_KERNELS if quantized else MLA_BF16_KERNELS
    per_call = {n: K.LAUNCHES[n] for n in want_kernels}
    t0 = time.perf_counter()
    want = run(host)
    report = {"layers": CHECK_LAYERS, "latents": "int8" if quantized else "bf16",
              "launches_in_check": per_call, "host_reference_s": time.perf_counter() - t0}
    bad = []
    for name in got:
        cos, err, finite = cosine(got[name], want[name])
        report[name] = {"cosine": cos, "max_abs_err": err}
        if not finite or not cos >= MODEL_COSINE:
            bad.append(name)
    for name in [n for n in got if n.endswith("_paged")]:
        same = torch.equal(got[name], got[name[: -len("_paged")] + "_ident"])
        report[name]["bitwise_vs_identity_tables"] = same
        if not same:
            bad.append(f"{name} vs identity tables")
    log(f"model check {cfg.name} ({report['latents']} latents): {json.dumps(report)}")
    for name, n in per_call.items():
        if n <= 0:
            check_failed(f"model check {cfg.name}: kernel {name} was not launched")
    if bad:
        check_failed(f"model check {cfg.name}: {bad} through the kernels disagree with the "
                     f"plain versions on the host (finite values with cosine >= "
                     f"{MODEL_COSINE} wanted) or, paged, with the same calls through identity "
                     f"tables (bit for bit wanted)")
    return report


def mla_served_phase() -> dict:
    """DeepSeek-V2-Lite at full depth and width (random weights from a
    seed), int8 weights, 16 slots, max_seq_len 4096, the engine's defaults
    otherwise (prompt cache 256 MiB, 64-token blocks), twice: with the int8
    latent cache (slot compaction on) and with bf16 latents. Each engine
    gets the 2-layer model check, then the four chats and the prefix
    traffic over HTTP with every counter set to 0 just before and read just
    after: its MLA kernels must have launched and no GQA-cache kernel, the
    ledger must audit clean, with hits and a copy on write (and at int8 the
    decode compacted); then, at int8, the breakdown of one decode step and
    one ragged chunk. Each engine is freed before the next is built."""
    import torch

    from llm_mcp_tpu_torch.api.inference import serve
    from llm_mcp_tpu_torch.executor import GenerationEngine
    from llm_mcp_tpu_torch.kernels import attention as K

    out: dict = {}
    for tag, kv_quant in (("int8", "int8"), ("bf16_latents", "")):
        t0 = time.time()
        torch.cuda.reset_peak_memory_stats()
        gc.collect()
        torch.cuda.empty_cache()
        mem0 = torch.cuda.memory_allocated()
        engine = GenerationEngine(
            MLA_MODEL, max_slots=Q8_SLOTS, max_seq_len=4096, prefill_chunk=512, seed=0,
            quant="int8", kv_quant=kv_quant, device="cuda",
        )
        leaf = weakref.ref(_first_leaf(engine.params["layers"]))
        torch.cuda.synchronize()
        built = {"s": time.time() - t0, "allocated_gib": torch.cuda.memory_allocated() / 2**30,
                 "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                 "compaction": engine.decode_compact, "kv_quant": kv_quant or "bf16"}
        log(f"{MLA_MODEL} int8 weights + {built['kv_quant']} latents: {json.dumps(built)}")
        check = model_check_mla(engine.cfg, engine.params, engine.device, bool(kv_quant))
        engine.start()
        api = serve({engine.cfg.name: engine}, "127.0.0.1", 0)
        base = f"http://127.0.0.1:{api.port}"
        try:
            K.reset_launches()
            rounds0 = engine.compact_rounds
            e2e = e2e_phase(engine, base, kernels=(), reset=False)
            prefix = prefix_phase(engine, base, kernels=(), reset=False)
            launches = dict(K.LAUNCHES)
            compacted = engine.compact_rounds - rounds0
        finally:
            api.shutdown()
            engine.shutdown()
        want = MLA_Q8_KERNELS if kv_quant else MLA_BF16_KERNELS
        checks = {f"{n} launched": launches[n] > 0 for n in want}
        for n in (GQA_CACHE_KERNELS + ("decode_attention",)
                  + (MLA_BF16_KERNELS if kv_quant else MLA_Q8_KERNELS)):
            checks[f"{n} not launched"] = launches[n] == 0
        if kv_quant:
            checks["decode ran compacted"] = compacted > 0
        report = {"engine": built, "model_check": check, "launches": launches,
                  "compacted_rounds": compacted, "e2e": e2e, "prefix": prefix, "checks": checks}
        log(f"{MLA_MODEL} {tag} served: "
            f"{json.dumps({'launches': launches, 'compacted_rounds': compacted, 'checks': checks})}")
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            check_failed(f"{MLA_MODEL} {tag} served phase: {bad}")
        if kv_quant:
            report["breakdown"] = breakdown_phase(engine.cfg, engine.params, engine.device,
                                                  quantized=True, model_tag="v2lite_")
        cfg, params = engine.cfg, engine.params
        del engine, api
        gc.collect()
        torch.cuda.empty_cache()
        if kv_quant:
            report["graph_ab"] = graph_ab_phase(cfg, params, f"{MLA_MODEL} int8",
                                                max_slots=Q8_SLOTS, max_seq_len=4096,
                                                prefill_chunk=512, quant="int8",
                                                kv_quant="int8")
            report["spec"] = spec_phase(cfg, params, f"{MLA_MODEL} int8", quant="int8",
                                        kv_quant="int8")
        del params
        report["released"] = _released(f"{MLA_MODEL} {tag}", mem0, leaf)
        out[tag] = report
    return out


def _post(url: str, body: dict, timeout: float = 600):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), headers={"Content-Type": "application/json"}
    )
    return urllib.request.urlopen(req, timeout=timeout)


def chat(base: str, model: str, prompt: str, stream: bool, out: dict, **kw) -> None:
    body = {"model": model, "stream": stream, "max_tokens": 64,
            "messages": [{"role": "user", "content": prompt}], **kw}
    t0 = time.perf_counter()
    try:
        with _post(base + "/v1/chat/completions", body) as r:
            if not stream:
                doc = json.loads(r.read())
                out.update(t_end=time.perf_counter() - t0,
                           finish=doc["choices"][0]["finish_reason"], usage=doc["usage"])
                return
            first = last = None
            lines = []
            for raw in r:
                line = raw.decode().strip()
                if not line.startswith("data: "):
                    continue
                lines.append(line)
                if line == "data: [DONE]":
                    break
                doc = json.loads(line[6:])
                ch = doc.get("choices") or [{}]
                if ch[0].get("delta", {}).get("content"):
                    now = time.perf_counter() - t0
                    first = now if first is None else first
                    last = now
                if ch[0].get("finish_reason"):
                    out.update(finish=ch[0]["finish_reason"], usage=doc.get("usage", {}))
                if "error" in doc:
                    out["error"] = doc["error"]
            out.update(t_first=first, t_last=last, t_end=time.perf_counter() - t0,
                       done=bool(lines) and lines[-1] == "data: [DONE]")
    except Exception as e:  # reported as a failed request below
        out["error"] = f"{type(e).__name__}: {e}"


def append_audit(launches: dict) -> dict[str, bool]:
    """The decode steps appended from inside their decode calls: no
    standalone append launched, and every bf16 and int8 decode call wrote
    its layer's rows (append=True)."""
    return {
        "no standalone append launched": all(launches[n] == 0 for n in STANDALONE_APPENDS),
        "every bf16 decode call appended": launches["append_kv_bf16_fused"]
        == launches["decode_attend_bf16"] + launches["decode_attend_bf16_paged"],
        "every int8 decode call appended": launches["append_kv_q8_fused"]
        == launches["decode_attend_q8"] + launches["decode_attend_q8_paged"],
    }


# The four chats: (name, prompt, streamed, sampling); the long one (about
# 1500 tokens) goes through ragged chunks, short-2 is sampled.
CHATS = (
    ("short-1", "What is the capital of France?", True, {"temperature": 0}),
    ("short-2", "Write a haiku about GPUs.", True, {"temperature": 0.7, "top_p": 0.9}),
    ("short-3", "List three prime numbers.", False, {"temperature": 0}),
    ("long", "Summarize this list: "
     + " ".join(f"item {i} is the {i % 7}th of its kind." for i in range(46)), True,
     {"temperature": 0}),
)


def e2e_phase(engine, base: str, kernels=CHAT_KERNELS, reset: bool = True) -> dict:
    """Four concurrent chats; every kernel of `kernels` must launch (the
    counters are set to 0 first unless the caller owns them)."""
    from llm_mcp_tpu_torch.kernels import attention as K

    model = engine.cfg.name
    warm: dict = {}
    chat(base, model, "warm up", True, warm, max_tokens=4, temperature=0)
    if "error" in warm:
        fail(f"warm-up request failed: {warm['error']}")
    reqs = CHATS
    results = {name: {} for name, *_ in reqs}
    if reset:
        K.reset_launches()
    t0 = time.perf_counter()
    threads = [
        threading.Thread(target=chat, args=(base, model, p, s, results[n]), kwargs=kw)
        for n, p, s, kw in reqs
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    for name, r in results.items():
        if "error" in r or not r.get("finish"):
            fail(f"request {name} did not finish: {r}")
        if r.get("done") is False:
            fail(f"request {name}: SSE stream did not end in data: [DONE]")
        if r["usage"].get("completion_tokens", 0) < 1:
            fail(f"request {name}: no tokens")
    for name in kernels:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the main path")
    if launches["decode_attention"] != 0:
        fail("decode_attention launched on a served path, which has no call to it")
    appended = append_audit(launches)
    if not all(appended.values()):
        fail(f"the chats' decode steps did not append from their decode calls: {appended}")
    prompt_tokens = {n: r["usage"]["prompt_tokens"] for n, r in results.items()}
    if prompt_tokens["long"] <= engine.prefill_chunk:
        fail("the long prompt did not exceed prefill_chunk")
    streams = [r for r in results.values() if r.get("t_first") is not None]
    decode_rates = [
        (r["usage"]["completion_tokens"] - 1) / (r["t_last"] - r["t_first"])
        for r in streams if r["t_last"] > r["t_first"]
    ]
    total_out = sum(r["usage"]["completion_tokens"] for r in results.values())
    e2e = {
        "requests": len(results),
        "prompt_tokens": prompt_tokens,
        "completion_tokens": {n: r["usage"]["completion_tokens"] for n, r in results.items()},
        "finish_reasons": {n: r["finish"] for n, r in results.items()},
        "ttft_s": {n: r["t_first"] for n, r in results.items() if r.get("t_first") is not None},
        "decode_tok_per_s_per_stream": decode_rates,
        "output_tok_per_s": total_out / wall,
        "wall_s": wall,
        "launches": launches,
        # each round shape's first call so far: eager, then its capture
        "round_graphs_first_call_s": {str(k): v for k, v in engine._graphs.first_call_s.items()}
        if engine._graphs else {},
    }
    log(f"e2e: {json.dumps(e2e)}")
    return e2e


# Prefix traffic (byte tokenizer: one token per byte, plus BOS). The long
# system message makes A and B share about 1160 tokens, so B's activation
# stores 1024 of them (16 blocks of 64, pool rows 16 of 32); then one hit
# alone and four concurrent hits. The short one makes the trio share 37
# tokens, so the second stores a 32-token entry, which the third hits
# unaligned (its boundary block is copied on write): 6 hits in all.
SYSTEM_LONG = " ".join(f"Rule {i}: answer plainly and cite rule {i % 9}." for i in range(28))
SYSTEM_SHORT = "Reply in French only."


def _messages(system: str, user: str) -> list[dict]:
    return [{"role": "system", "content": system}, {"role": "user", "content": user}]


def prefix_phase(engine, base: str, kernels=PREFIX_KERNELS, reset: bool = True) -> dict:
    """Prefix-cache traffic over HTTP; every kernel of `kernels` must launch
    and the ledger must be sound once every request is done."""
    from llm_mcp_tpu_torch.kernels import attention as K

    model = engine.cfg.name
    if engine.paging_stats()["physical"] != 1.0:
        fail("the engine's defaults did not turn physical paging on")
    results: dict[str, dict] = {}

    def run(batch: list[tuple[str, list, int]]) -> None:
        threads = []
        for name, msgs, n in batch:
            results[name] = {}
            threads.append(threading.Thread(
                target=chat, args=(base, model, "", True, results[name]),
                kwargs={"messages": msgs, "max_tokens": n, "temperature": 0}))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)

    a_msgs = _messages(SYSTEM_LONG, "Question one: which rule comes first?")
    if reset:
        K.reset_launches()
    t0 = time.perf_counter()
    hits0 = engine.prefix_cache_stats()["hits"]
    run([("A_cold", a_msgs, 32)])
    run([("B_store", _messages(SYSTEM_LONG, "Question two: which rule comes last?"), 32)])
    stored = engine.prefix_cache_stats()
    # one hit alone: its TTFT against A's is what the hit skips; the four
    # concurrent ones below also wait on the scheduler's budget while the
    # first of them decode
    run([("hit_solo", _messages(SYSTEM_LONG, "Question six: is rule 3 strict?"), 32)])
    run([("hit_q3", _messages(SYSTEM_LONG, "Question three: name a rule."), 64),
         ("hit_q4", _messages(SYSTEM_LONG, "Question four: count the rules."), 64),
         ("hit_q5", _messages(SYSTEM_LONG, "Question five: quote rule 7."), 64),
         ("hit_A_again", a_msgs, 64)])
    for name, user in (("cow_1", "Hello, how are you?"), ("cow_2_store", "What time is it?"),
                       ("cow_3_hit", "Bonjour, comment ca va?")):
        run([(name, _messages(SYSTEM_SHORT, user), 16)])
    wall = time.perf_counter() - t0
    for _ in range(200):  # a slot is freed just after its last event goes out
        pg = engine.paging_stats()
        if pg["slot_tables"] == 0:
            break
        time.sleep(0.05)
    launches = dict(K.LAUNCHES)
    px = engine.prefix_cache_stats()
    for name, r in results.items():
        if "error" in r or not r.get("finish"):
            fail(f"prefix request {name} did not finish: {r}")
        if r.get("done") is not True:
            fail(f"prefix request {name}: SSE stream did not end in data: [DONE]")
    hits = px["hits"] - hits0
    checks = {
        "hits >= 5": hits >= 5,
        "leaks == 0": pg["leaks"] == 0,
        "slot_tables == 0": pg["slot_tables"] == 0,
        "physical_cow_copies_total >= 1": pg["physical_cow_copies_total"] >= 1,
        "physical_missing_pins == 0": pg["physical_missing_pins"] == 0,
    }
    for name in kernels:
        checks[f"{name} launched"] = launches[name] > 0
    checks["decode_attention not launched"] = launches["decode_attention"] == 0
    checks.update(append_audit(launches))
    ttft = {n: r.get("t_first") for n, r in results.items()}
    report = {
        "prompt_tokens": {n: r["usage"].get("prompt_tokens") for n, r in results.items()},
        "completion_tokens": {n: r["usage"].get("completion_tokens") for n, r in results.items()},
        "ttft_s": ttft,
        "ttft_cold_A_s": ttft["A_cold"],
        "ttft_hits_s": {n: t for n, t in ttft.items() if n.startswith("hit_")},
        "prefix_cache": px, "entries_after_B": stored["entries"], "hits": hits,
        "paging": {k: pg[k] for k in (
            "block_tokens", "leaks", "slot_tables", "prefix_entries", "prefix_blocks",
            "prefix_partition", "peak_sharing_ratio", "pinned_blocks_total",
            "cow_copies_total", "physical_pool_rows", "physical_pool_rows_used",
            "physical_pool_rows_peak", "physical_cow_copies_total", "physical_missing_pins",
            "physical_table_uploads_total")},
        "wall_s": wall, "launches": launches, "checks": checks,
    }
    log(f"prefix: {json.dumps(report)}")
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        check_failed(f"prefix phase: {bad}")
    return report


AB_BUDGET = 512  # prefill tokens a round in the capture A/B, fixed: both runs chunk alike
ROUND_STEPS = 4  # decode_chunk: the steps of a decode round
# the profiled rounds of the capture A/B: from the 6th fetch (the long
# prompt's three chunks and each shape's first call are behind), four
AB_WINDOW = (6, 4)


def _window_profiler(eng, first: int, n: int):
    """torch.profiler (device activity only) over `n` of the engine's
    rounds, from its `first`-th fetch. The profiler is stepped at each
    fetch from the engine's own thread, so it starts and stops between that
    thread's launches. The window runs from the fetch after which tracing
    is on to the fetch that stops it (the trace's flush left out). Returns
    (profiler, report): the report fills in when the window closes with the
    device busy inside the window (each kernel clipped to it), the idle
    share, and the kernels that started in it per decode step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerAction, ProfilerActivity, profile, schedule

    report: dict = {"window_rounds": n, "device_busy_ms": "not measured",
                    "idle_share": "not measured", "device_kernels_per_step": "not measured"}
    marks: list[float] = []
    traced: list = []

    def ready(prof):
        traced.extend(e for e in prof.events() if e.device_type == DeviceType.CUDA)

    prof = profile(activities=[ProfilerActivity.CUDA], on_trace_ready=ready,
                   schedule=schedule(wait=first - 1, warmup=1, active=n, repeat=1))
    complete = eng._complete_round

    def stepped(disp):
        out = complete(disp)
        was, t = prof.current_action, time.perf_counter()
        prof.step()
        if prof.current_action == ProfilerAction.RECORD and not marks:
            marks.append(time.perf_counter())  # tracing is on
        elif was == ProfilerAction.RECORD_AND_SAVE and marks and traced:
            window_us = (t - marks[0]) * 1e6
            busy = sum(max(0.0, min(e.time_range.end, window_us) - max(e.time_range.start, 0.0))
                       for e in traced)
            inside = sum(1 for e in traced if 0.0 <= e.time_range.start < window_us)
            report.update({"window_ms": window_us / 1e3, "device_busy_ms": busy / 1e3,
                           "idle_share": 1.0 - busy / window_us,
                           "device_kernels_per_step": inside / (n * eng.decode_chunk)})
        return out

    eng._complete_round = stepped
    return prof, report


def graph_ab_phase(cfg, params, tag: str, **engine_kw) -> dict:
    """The decode round eager (`cuda_graphs=False`) and captured (the
    engine's default), each on a fresh engine over the served weights
    (`engine_kw`: the served configuration): the four chats, queued before
    the engine loop starts and with the prefill budget held at AB_BUDGET
    tokens a round, so that both runs admit, chunk and dispatch alike, at
    the engine's pipeline depth. Each mode runs twice: plain (wall per
    round between fetches, TTFT and decode tok/s per stream, read from the
    request queues, and the first call of each round shape: its eager round
    and capture) and with torch.profiler over AB_WINDOW's rounds of decode
    (device busy, idle share and device kernels per decode step). Every
    run's greedy tokens must be identical, and with identical tokens the
    port kernels' launch counts too (a replay adds its graph's tally)."""
    import torch

    from llm_mcp_tpu_torch.executor import GenRequest
    from llm_mcp_tpu_torch.kernels import attention as K

    runs: dict[str, dict] = {}
    tokens: dict[str, list] = {}
    for graphs in (False, True):
        for profiled in (False, True):
            name = ("on" if graphs else "off") + ("_profiled" if profiled else "")
            eng = _held_engine(cfg, params, graphs, **engine_kw)
            fetched: list[float] = []
            seen = _record_tokens(eng)
            complete = eng._complete_round

            def timed_fetch(disp, complete=complete, fetched=fetched):
                out = complete(disp)
                fetched.append(time.perf_counter())
                return out

            eng._complete_round = timed_fetch
            reqs = [GenRequest(prompt_ids=eng.tokenizer.encode(p), max_tokens=64,
                               temperature=kw["temperature"], top_p=kw.get("top_p", 1.0))
                    for _, p, _, kw in CHATS]
            times: list[dict] = [{} for _ in reqs]

            def consume(r, t):
                while True:
                    evt = r.out.get(timeout=600)
                    now = time.perf_counter()
                    if not isinstance(evt, dict) or evt["type"] in ("done", "error"):
                        t.update(end=now, evt=evt)
                        return
                    if evt["type"] == "token":
                        t.setdefault("first", now)
                        t["last"] = now

            for r in reqs:
                eng.submit(r)
            threads = [threading.Thread(target=consume, args=(r, t)) for r, t in zip(reqs, times)]
            prof, window = _window_profiler(eng, *AB_WINDOW) if profiled else (None, {})
            K.reset_launches()
            torch.cuda.synchronize()
            if prof is not None:
                prof.start()
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            eng.start()
            for t in threads:
                t.join(timeout=600)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            eng.shutdown()
            if prof is not None:
                prof.stop()
            for (n, *_), t in zip(CHATS, times):
                evt = t.get("evt")
                if not isinstance(evt, dict) or evt["type"] != "done":
                    fail(f"capture A/B {tag} {name}: request {n} did not finish: {evt}")
            steps = eng._rid_dispatched * eng.decode_chunk
            gaps = sorted(b - a for a, b in zip(fetched, fetched[1:]))
            launches = {k: v for k, v in K.LAUNCHES.items() if v}
            runs[name] = {
                "wall_s": wall, "rounds": eng._rid_dispatched, "decode_steps": steps,
                "wall_ms_per_round_median": gaps[len(gaps) // 2] * 1e3 if gaps else None,
                "ttft_s": {n: t["first"] - t0 for (n, *_), t in zip(CHATS, times)
                           if "first" in t},
                "decode_tok_per_s_per_stream": {
                    n: (t["evt"]["usage"]["completion_tokens"] - 1) / (t["last"] - t["first"])
                    for (n, *_), t in zip(CHATS, times) if t.get("last", 0) > t.get("first", 0)},
                "port_launches": launches,
                "port_launches_per_step": sum(launches.values()) / max(1, steps),
                "graph_replays": eng._graphs.replays if eng._graphs else 0,
                # the first round of each shape: eager, then its capture
                "first_call_s": {str(k): v for k, v in eng._graphs.first_call_s.items()}
                if eng._graphs else {},
                **window,
            }
            tokens[name] = [seen.get(r.request_id, []) for r in reqs]
            del eng
            gc.collect()
            torch.cuda.empty_cache()
    greedy = [i for i, (*_, kw) in enumerate(CHATS) if kw["temperature"] == 0]
    base = tokens["off"]
    checks = {f"greedy tokens identical ({n})":
              [tokens[n][i] for i in greedy] == [base[i] for i in greedy] for n in runs}
    same_all = all(tokens[n] == base for n in runs)
    checks["captured rounds replayed"] = runs["on"]["graph_replays"] > 0
    if same_all:
        checks["port launch counts identical"] = all(
            runs[n]["port_launches"] == runs["off"]["port_launches"] for n in runs)
    report = {"runs": runs, "sampled_tokens_identical": same_all, "checks": checks}
    log(f"capture A/B {tag}: {json.dumps(report)}")
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        check_failed(f"capture A/B {tag}: {bad}")
    return report


def breakdown_phase(cfg, params, dev, quantized: bool = False, model_tag: str = "") -> dict:
    """Where a decode step and a ragged chunk spend their time, at served
    shapes (8 rows at fill 1024, unpaged and with the first 16 blocks of
    every row read from the prefix pool; one 512-token chunk over a
    1024-token prefix): wall per call from CUDA events, device time by
    kernel from torch.profiler (and the port's own kernels by name, their
    instantiations summed), and the device's idle share (1 - busy /
    wall; a kernel launched to overlap its predecessor counts from its
    start, so busy is an upper bound). Beside the step, the engine's
    decode round over the same rows (ROUND_STEPS steps with sampling and
    the token ring's write-back, `decode_round`), eager and captured as
    the engine captures it (`RoundGraphs`: a replay a call), with its
    launches a step. `quantized`: the int8 engine's weights over a fused
    int8 cache of Q8_SLOTS rows, the 8 decode rows compacted through
    slot_ids as the engine runs them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from llm_mcp_tpu_torch.executor.engine import decode_round
    from llm_mcp_tpu_torch.executor.graphs import RoundGraphs
    from llm_mcp_tpu_torch.executor.physical import pool_like
    from llm_mcp_tpu_torch.models import llama as TL

    Ba, S, P, T = 8, 4096, 1024, 512
    B = Q8_SLOTS if quantized else Ba
    cache = TL.init_kv_cache(cfg, B, S, dtype=torch.bfloat16, device=dev, quantized=quantized)
    ck, cv = cache["k"], cache["v"]

    def i32(x):
        return torch.as_tensor(x, dtype=torch.int32, device=dev)

    toks, lens = i32([65] * Ba), i32([P] * Ba)
    ids = i32(range(0, 2 * Ba, 2)) if quantized else None
    bt, nsh = BLOCK_TOKENS, SHARED_TOKENS // BLOCK_TOKENS
    nbs = S // bt
    tbl = torch.arange(B * nbs, dtype=torch.int32, device=dev).reshape(B, nbs)
    tbl[:, :nsh] = B * nbs + torch.arange(nsh, dtype=torch.int32, device=dev)
    paged = {"tbl": tbl, "k": pool_like(ck, nsh, bt), "v": pool_like(cv, nsh, bt)}
    ragged = dict(tokens=i32([66] * T), rowids=i32([0] * T), positions=i32(range(P, P + T)),
                  slots=i32([0]), starts=i32([P]), last_idx=i32([T - 1]))
    # the engine's decode round (ROUND_STEPS steps, sampling, the token
    # ring's write-back) over the same rows, eager and as its CUDA graph
    state = (i32([65] * B), torch.zeros(B, device=dev), i32([0] * B), torch.ones(B, device=dev))
    packed = i32([P] * Ba + (list(range(0, 2 * Ba, 2)) if quantized else []) + [1])
    gen = torch.Generator(device=dev).manual_seed(0)
    rnd = functools.partial(decode_round, cfg, params, ck, cv, state, steps=ROUND_STEPS,
                            compact=quantized, generator=gen)
    graphs = RoundGraphs(dev, gen)
    tag = "_q8" if quantized else ""
    calls = {
        f"{model_tag}decode_step{tag}_b8": lambda: TL.llama_decode_step(
            cfg, params, ck, cv, toks, lens, slot_ids=ids),
        f"{model_tag}decode_step{tag}_b8_paged": lambda: TL.llama_decode_step(
            cfg, params, ck, cv, toks, lens, slot_ids=ids, paged=paged),
        f"{model_tag}decode_round{tag}_b8": lambda: rnd(packed),
        f"{model_tag}decode_round{tag}_b8_graph": lambda: graphs.run(
            (Ba, quantized), lambda p, _: rnd(p), (packed, None)),
        f"{model_tag}ragged_chunk{tag}_512": lambda: TL.llama_prefill_chunk_ragged(
            cfg, params, ck, cv, **ragged),
    }
    out = {}
    for name, fn in calls.items():
        ms = time_ms(fn, 5, queue_ahead=False)
        n = 1 if "round" in name else 3  # a round is four steps; its trace is costly to read
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        kern = sorted(
            ((e.self_device_time_total / 1e3 / n, e.key) for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
            reverse=True,
        )
        busy = sum(t for t, _ in kern)
        launched = sum(e.count for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0) / n
        port: dict[str, float] = {}  # the port's own kernels, instantiations summed
        for t, k in kern:
            m = re.search(r"\(anonymous namespace\)::(\w+)", k)
            if m:
                port[m.group(1)] = port.get(m.group(1), 0.0) + t
        out[name] = {
            "ms": ms,
            "device_busy_ms": busy if kern else "not measured",
            "idle_share": 1.0 - busy / ms if kern else "not measured",
            "launches_per_call": launched if kern else "not measured",
            "launches_per_step": (launched / (ROUND_STEPS if "round" in name else 1)
                                  if kern else "not measured"),
            "top_kernels_ms": [[k[:80], t] for t, k in kern[:10]],
            "port_kernels_ms": port,
        }
    log(f"breakdown {cfg.name}{' int8' if quantized else ''}: {json.dumps(out)}")
    del ck, cv, cache, paged, graphs, rnd, calls
    gc.collect()
    torch.cuda.empty_cache()
    return out


# Planted faults in the bf16 and int8 decode kernels and the MLA kernels,
# each run in its own copy of the checkout by `python3 chip_smoke.py
# --planted`: (source, text, replacement).
PLANTED = {
    "no_alpha_rescale": ("decode_attend.cuh", "const float alpha = __expf(m[g] - mx);",
                         "const float alpha = 1.f;"),
    "w_override_skipped": ("decode_attend.cuh", "if (!POST && pos == we) {", "if (false) {"),
    "wrong_ring_stage": ("decode_attend.cuh", "mine + (st % NST) * STAGE_BYTES;  // the ring slot read",
                         "mine + ((st + 1) % NST) * STAGE_BYTES;  // the ring slot read"),
    "mla_rope_scale_swapped": ("ragged_prefill_mla.cu",
                               "const float v = Q8 ? (sl[e] * ls + sr[e] * rs) * scale",
                               "const float v = Q8 ? (sl[e] * ls + sr[e] * ls) * scale"),
    "mla_wrong_ring_stage": ("ragged_prefill_mla.cu",
                             "const unsigned char* kt = s.k(kv);  // the ring stage read",
                             "const unsigned char* kt = s.k((kv + 1) % NST);  // the ring stage read"),
    "mla_causal_strict": ("ragged_prefill_mla.cu",
                          "return tok[i] >= u_lo + ti * BK + kk && tg == rid[i];",
                          "return tok[i] > u_lo + ti * BK + kk && tg == rid[i];"),
    # the MLA decode kernel: a spanning group's scale from its own split
    # only, the rope scale read as the latent one, position w's exact score
    # skipped
    "mla_decode_group_max_per_split": ("decode_attend_mla.cu",
                                       "if (span && zz >= zlo && zz < zhi) {",
                                       "if (span && zz == z) {"),
    "mla_decode_rope_scale_swapped": ("decode_attend_mla.cu", "const float rs = sm.rs[p];",
                                      "const float rs = sm.ls[p];"),
    "mla_decode_w_override_skipped": ("decode_attend_mla.cu", "if (p == wl) v = sm.snew[hl];",
                                      "if (false) v = sm.snew[hl];"),
    # the int8 decode kernel: a group's scale from one stage's keys, position
    # w's exact score skipped, the other V stage read
    "q8_decode_group_scale_per_stage": ("decode_attend.cuh",
                                        "const int gh = group / QSK;  // stages a group covers",
                                        "const int gh = 1;  // stages a group covers"),
    "q8_decode_w_override_skipped": ("decode_attend.cuh", "if (pos == we) v = sm.snew[hd2];",
                                     "if (false) v = sm.snew[hd2];"),
    "q8_decode_wrong_ring_stage": (
        "decode_attend.cuh", "const unsigned char* vst = ring[ks ? 0 : 2];  // the V stage read",
        "const unsigned char* vst = ring[ks ? 2 : 0];  // the V stage read"),
    # the whole-row arm's scale from the split's own keys alone; the fused
    # int8 append skipping its V scale
    "q8_decode_row_scale_one_split": (
        "decode_attend.cuh",
        "const float2 r = q8_row_max(rs, bh * nsplit * G + 2 * t + i, nlive, G);",
        "const float2 r = q8_row_max(rs, (bh * nsplit + sp) * G + 2 * t + i, 1, G);"),
    "q8_append_skips_v_scale": ("decode_attend.cuh", "ap.s[(lr * Hs + head) * c.S + w] = sb;",
                                "if (wid == 0) ap.s[(lr * Hs + head) * c.S + w] = sb;"),
    # the head_dim-256 flash kernel: the second consumer warpgroup reading
    # the first one's query rows, a V stage's empty barrier arrived before
    # P.V has read it (the producer may then overwrite it), a window one key
    # too wide; the tile's window one key too wide (the 128 and 64 flash
    # arms); the ragged tile's padding rows (G not dividing 64) taking the
    # next tile's first token
    "hd256_second_wg_first_rows": (
        "flash_prefill_hd256.cu", "const uint32_t qt = base + Q_OFF + wg * TILE_BYTES;",
        "const uint32_t qt = base + Q_OFF + 0 * TILE_BYTES;"),
    "hd256_v_released_before_pv": (
        "flash_prefill_hd256.cu",
        "    wg_wait();  // P.V has read V of stage s\n    hold(o);\n"
        "    if ((threadIdx.x & 31) == 0) mbar_arrive(v_empty(bars, s));",
        "    if ((threadIdx.x & 31) == 0) mbar_arrive(v_empty(bars, s));\n"
        "    wg_wait();  // P.V has read V of stage s\n    hold(o);"),
    "hd256_window_off_by_one": ("flash_prefill_hd256.cu", "(window <= 0 || qp - kp < window)",
                                "(window <= 0 || qp - kp <= window)"),
    "flash_window_off_by_one": ("flash_prefill.cuh", "(window <= 0 || qp - kp < window)",
                                "(window <= 0 || qp - kp <= window)"),
    "ragged_pad_rows_take_a_token": (
        "ragged_prefill.cuh", "auto token = [&](int r) { return r < TQ * G ? t0 + r / G : T; };",
        "auto token = [&](int r) { return t0 + r / G; };"),
    # the head_dim-64 arms: the tile's P.V reading V 8 columns off, the bf16
    # decode merging lane groups 4 lanes apart (the same row's other dims)
    # in its second round, the fused int8 append writing a scale two slots
    # off in the packed row (the replacements leave the 128 arms as they are)
    "hd64_pv_columns": (
        "tile_attention.cuh",
        "if constexpr (HD == 64) return desc(t + kk * 16 * 128, HALF_BYTES, 1024);",
        "if constexpr (HD == 64) return desc(t + kk * 16 * 128 + 16, HALF_BYTES, 1024);"),
    "hd64_decode_lane_groups": (
        "decode_attend.cuh", "if constexpr (SUB == 4) merge(8);",
        "if constexpr (SUB == 4) merge(4);"),
    "hd64_packed_scale_row": (
        "decode_attend.cuh", "if (c.Hf > Hs) reinterpret_cast<bf16*>(prow)[head] = sb;",
        "if (c.Hf > Hs) reinterpret_cast<bf16*>(prow)[head + (128 - HD) / 32] = sb;"),
}
# the rows each family-arm fault must fail (at least one of them)
HD256_ROWS = ("flash_prefill_attention_hd256", "flash_prefill_attention_hd256_admit")
PLANTED_ROWS = {
    "hd256_second_wg_first_rows": HD256_ROWS,
    "hd256_v_released_before_pv": HD256_ROWS,
    "hd256_window_off_by_one": HD256_ROWS,
    "flash_window_off_by_one": ("flash_prefill_attention",),
    "ragged_pad_rows_take_a_token": tuple(n for n in FAMILY_ROWS if n.startswith("ragged")),
    "hd64_pv_columns": tuple(n for n in HD64_ROWS if "prefill" in n),
    "hd64_decode_lane_groups": tuple(n for n in HD64_ROWS if n.startswith("decode_attend_bf16")
                                     or n == "decode_attention_hd64"),
    "hd64_packed_scale_row": ("append_kv_q8_fused_hd64",),
}
Q8_DECODE_ROWS = ("decode_attend_q8", "decode_attend_q8_paged", "decode_attend_q8_row")


def planted_phase() -> dict:
    """Each fault of PLANTED in a copy of the port and this script under
    build/planted/<fault>/, run there as `chip_smoke.py --kernels` (build,
    the bf16, int8 and MLA kernel checks); returns, per fault, the rows whose
    check failed and every row's worst err/limit. A fault that no row
    catches fails the run, and so does a fault in an MLA kernel, the int8
    decode kernel or its fused append that no row of that kernel catches."""
    import shutil

    root = Path(__file__).resolve().parent
    out: dict[str, dict] = {}
    # `--planted=a,b` runs the named faults alone
    only = [a.split("=", 1)[1].split(",") for a in sys.argv[1:] if a.startswith("--planted=")]
    for fault, (src, old, new) in PLANTED.items():
        if only and fault not in only[0]:
            continue
        dst = root / "build" / "planted" / fault
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(root / "llm_mcp_tpu_torch", dst / "llm_mcp_tpu_torch",
                        ignore=shutil.ignore_patterns("build", "__pycache__"))
        shutil.copy2(root / "chip_smoke.py", dst / "chip_smoke.py")
        path = dst / "llm_mcp_tpu_torch" / "kernels" / "csrc" / src
        text = path.read_text()
        if text.count(old) != 1:
            fail(f"planted fault {fault}: {old!r} is not in {src} exactly once")
        path.write_text(text.replace(old, new))
        t0 = time.time()
        proc = subprocess.run([sys.executable, "chip_smoke.py", "--kernels"], cwd=dst,
                              capture_output=True, text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith('{"kernels"')]
        if not lines:
            fail(f"planted fault {fault}: no result (exit {proc.returncode}):\n"
                 f"{proc.stderr[-4000:]}")
        res = json.loads(lines[-1])
        failed = sorted({m.split(":")[0] for m in res["failures"]})
        out[fault] = {
            "exit": proc.returncode, "seconds": time.time() - t0, "failed_rows": failed,
            "worst_err_over_limit": {n: r["worst_err_over_limit"]
                                     for n, r in res["kernels"].items()},
            "failures": res["failures"],
        }
        log(f"planted {fault}: failed rows {failed}")
        if not failed:
            check_failed(f"planted fault {fault} was caught by no row")
        elif src == "ragged_prefill_mla.cu" and not any(
                n.startswith("ragged_prefill_attend_mla") for n in failed):
            check_failed(f"planted fault {fault} failed no MLA ragged row: {failed}")
        elif src == "decode_attend_mla.cu" and not any(
                n.startswith("decode_attend_q8_mla") for n in failed):
            check_failed(f"planted fault {fault} failed no MLA decode row: {failed}")
        elif fault.startswith("q8_decode") and not set(failed) & set(Q8_DECODE_ROWS):
            check_failed(f"planted fault {fault} failed no int8 decode row: {failed}")
        elif fault.startswith("q8_append") and "append_kv_q8_fused" not in failed:
            check_failed(f"planted fault {fault} failed not the fused int8 append: {failed}")
        elif fault in PLANTED_ROWS and not set(failed) & set(PLANTED_ROWS[fault]):
            check_failed(f"planted fault {fault} failed none of {PLANTED_ROWS[fault]}: {failed}")
        elif fault.startswith(("hd64", "hd256")) and not set(failed) <= set(PLANTED_ROWS[fault]):
            # a head_dim-64 or -256 fault fails its own rows alone
            check_failed(f"planted fault {fault} failed rows outside its own: "
                         f"{sorted(set(failed) - set(PLANTED_ROWS[fault]))}")
        shutil.rmtree(dst, ignore_errors=True)
    return out


def hd256_smem_bytes() -> int | str:
    """The dynamic shared memory the head_dim-256 flash kernel launches with:
    `SMEM_BYTES` of its source, which a static_assert there ties to its
    layout (ptxas reports static shared memory only)."""
    src = Path(__file__).resolve().parent / FAMILY_ROWS["flash_prefill_attention_hd256"][0]
    m = re.search(r"constexpr int SMEM_BYTES = (\d+);", src.read_text())
    return int(m.group(1)) if m else "not stated in the source"


def ptxas_report(text: str, kernel: str) -> dict[str, dict]:
    """Registers, spills and static shared memory of each instantiation of
    `kernel` in ptxas's -v output: {mangled name: {registers,
    spill_stores, spill_loads, static_smem}} (dynamic shared memory is
    set at launch and not in this report)."""
    out: dict[str, dict] = {}
    name = None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            name = m.group(1) if kernel in m.group(1) else None
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out.setdefault(name, {}).update(spill_stores=int(m.group(1)),
                                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            out.setdefault(name, {})["static_smem"] = int(m.group(1))
    return out


# The preempt phase's traffic (raw prompts, byte tokenizer). The low
# streams' prompts are about 1000 tokens (Llama) or 400 (V2-Lite), so they
# prefill through ragged chunks; the victim is admitted off a prefix hit,
# 1024 tokens stored from SYSTEM_LONG (block-aligned: its snapshot holds
# only its private rows) or 32 from UNALIGNED_PREFIX (a boundary block
# copied on write: its snapshot is whole), and as many tokens of its own.
UNALIGNED_PREFIX = "Reply in French only, and keep it short. "
PREEMPT_OUT, HI_OUT = 128, 32  # tokens out of a low stream and of the urgent request
PCIE_BYTES_PER_S = 64e9  # H100 SXM host link: PCIe Gen5 x16, nominal, one direction
# device memory a released engine may leave: cuBLAS keeps a workspace for
# each stream it ran on (32 MiB on the H100), one a capture stream
RELEASE_SLACK = 256 << 20


def _long_prompt(i: int, chars: int) -> str:
    words = " ".join(f"Line {j} of file {i} lists item {j * 7 % 13} twice." for j in range(60))
    return words[:chars]


def _released(tag: str, mem0: int, leaf) -> dict:
    """After an engine is shut down and dropped: the device memory it held
    must be back, give or take the workspaces cuBLAS keeps per stream (an
    engine's capture stream has one). On failure, what still refers to one
    of its weight tensors (`leaf`, a weak reference)."""
    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated()
    out = {"allocated_gib_before_build": mem0 / 2**30, "allocated_gib_after_release": after / 2**30,
           "weights_alive": leaf() is not None}
    log(f"{tag}: released: {json.dumps(out)}")
    if after - mem0 > RELEASE_SLACK or leaf() is not None:
        check_failed(f"{tag}: the engine's device memory was not released: {out}; "
                     f"what refers to its weights: {_holders(leaf())}")
    return out


def _holders(obj, depth: int = 6, width: int = 4) -> list[str]:
    """The chains of objects that keep `obj` alive, level by level (type
    names; a dict's first keys, a function's name), for the log."""
    import types

    if obj is None:
        return []
    level, seen, out = [obj], {id(obj)}, []
    for d in range(depth):
        nxt = []
        for o in level:
            for r in gc.get_referrers(o):
                if id(r) in seen or r is level or r is nxt or isinstance(r, types.FrameType):
                    continue
                seen.add(id(r))
                name = type(r).__qualname__
                if isinstance(r, dict):
                    name += f" keys={list(r)[:6]}"
                elif isinstance(r, (types.FunctionType, types.MethodType)):
                    name += f" {r.__qualname__}"
                out.append("  " * d + name)
                nxt.append(r)
                if len(nxt) >= width:
                    break
        level = nxt
    return out


def _first_leaf(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        return tree
    for v in (tree.values() if isinstance(tree, dict) else tree):
        t = _first_leaf(v)
        if t is not None:
            return t
    return None


def _step_until(eng, done, limit: int = 20000) -> None:
    """Run the engine loop by hand (`_step`, as its thread does) until
    `done()`; the engine is not started yet."""
    import torch

    with torch.inference_mode():
        for _ in range(limit):
            if done():
                return
            eng._step()
    fail("the engine loop, stepped by hand, did not get there")


def _preempt_cycle(eng, tag: str, prefix: str, longs: list[str], victim_chars: int) -> dict:
    """One preempt -> offload -> restore cycle on an engine with the pool on,
    not started yet. Two prompts under `prefix` store it in the prefix
    cache, and the victim (priority 0, `victim_chars` of its own after the
    prefix) is admitted off that hit and decodes (the loop stepped by hand
    so far). Then the long prompts
    (priority 1) and the urgent request (priority 5) are queued and the
    loop starts: the longs take every other slot, the urgent request finds
    none free and preempts the victim, which is restored once a slot frees.
    Then, on the same engine, the victim alone and the urgent request alone
    (its TTFT on the idle engine). Checks the victim's text against its
    uncontended text, the snapshot, the counters, the ledger and that the
    decode kernels launched after the restore."""
    from llm_mcp_tpu_torch.executor import GenRequest
    from llm_mcp_tpu_torch.kernels import attention as K

    B = eng.max_slots
    snaps, restores = [], []
    offload, restore = eng._pool.offload, eng._restore_snapshot

    def rec_offload(snap, seconds=0.0):
        snaps.append(snap)
        offload(snap, seconds)

    def rec_restore(b, snap):
        restore(b, snap)
        restores.append({"slot": b, "nbytes": snap.nbytes, "launches": dict(K.LAUNCHES)})

    eng._pool.offload, eng._restore_snapshot = rec_offload, rec_restore
    pool0 = eng.memory_stats()

    def req(text, n, pri):
        return GenRequest(prompt_ids=eng.tokenizer.encode(text), max_tokens=n, temperature=0.0,
                          priority=pri)

    def run(reqs):
        """Consumers of `reqs`: first-token time and text of each."""
        times = [{} for _ in reqs]

        def consume(r, t):
            parts = []
            while True:
                evt = r.out.get(timeout=600)
                now = time.perf_counter()
                if not isinstance(evt, dict) or evt["type"] in ("done", "error"):
                    t.update(end=now, evt=evt, text="".join(parts))
                    return
                if evt["type"] == "token":
                    t.setdefault("first", now)
                    parts.append(evt["text"])

        threads = [threading.Thread(target=consume, args=(r, t)) for r, t in zip(reqs, times)]
        for t in threads:
            t.start()
        return threads, times

    def finish(threads, times):
        for t in threads:
            t.join(timeout=900)
        ends = [t.get("evt") for t in times]
        if not all(isinstance(e, dict) and e["type"] == "done" for e in ends):
            fail(f"preempt {tag}: a request did not finish: {ends}")

    for q in ("prime one?", "prime two?"):  # the second stores the prefix
        r = req(prefix + q, 4, 0)
        threads, times = run([r])
        eng.submit(r)
        _step_until(eng, lambda times=times: "evt" in times[0])
        finish(threads, times)
    victim_text = prefix + "Victim: " + _long_prompt(B, victim_chars)
    victim = req(victim_text, PREEMPT_OUT, 0)
    lows = [req(p, PREEMPT_OUT, 1) for p in longs]
    hi = req("Urgent: reply with one short sentence about the weather.", HI_OUT, 5)
    assert len(lows) + 1 == B
    threads, times = run([victim] + lows + [hi])
    eng.submit(victim)
    _step_until(eng, lambda: any(s is not None and s.req is victim for s in eng._slots))
    for r in lows + [hi]:
        eng.submit(r)
    t_start = time.perf_counter()
    eng.start()
    finish(threads, times)
    # the victim alone, then the urgent request alone, on the same engine
    alone_req = req(victim_text, PREEMPT_OUT, 0)
    threads2, alone = run([alone_req])
    eng.submit(alone_req)
    finish(threads2, alone)
    hi_idle = req("Urgent: reply with one short sentence about the weather.", HI_OUT, 5)
    threads3, idle = run([hi_idle])
    t_idle = time.perf_counter()
    eng.submit(hi_idle)
    finish(threads3, idle)
    for _ in range(200):  # a slot is freed just after its last event goes out
        pg = eng.paging_stats()
        if pg["slot_tables"] == 0:
            break
        time.sleep(0.05)
    st = eng.memory_stats()
    eng._pool.offload, eng._restore_snapshot = offload, restore
    decode = [n for n in K.LAUNCHES if n.startswith("decode_attend_q8")]
    after_restore = {n: K.LAUNCHES[n] - restores[0]["launches"][n] for n in decode} \
        if restores else {}
    off_b = st["offload_bytes_total"] - pool0["offload_bytes_total"]
    off_s = st["offload_seconds_total"] - pool0["offload_seconds_total"]
    res_b = sum(r["nbytes"] for r in restores)
    res_s = st["restore_seconds_total"] - pool0["restore_seconds_total"]
    report = {
        "snapshots": [{"shared_len": sn.shared_len, "length": sn.length, "nbytes": sn.nbytes,
                       "rows": _first_leaf(sn.k_rows).shape[3],
                       "link_bound_ms": sn.nbytes / PCIE_BYTES_PER_S * 1e3} for sn in snaps],
        "preempted": st["preempted_total"] - pool0["preempted_total"],
        "restored": st["restored_total"] - pool0["restored_total"],
        "offload_bytes": off_b, "offload_s": off_s,
        "offload_gb_per_s": off_b / off_s / 1e9 if off_s > 0 else None,
        "restore_bytes": res_b, "restore_s": res_s,
        "restore_gb_per_s": res_b / res_s / 1e9 if res_s > 0 else None,
        # from the loop's start: the urgent request waited for the victim's
        # drain and snapshot, then prefilled
        "hi_ttft_contended_s": times[-1].get("first", t_start) - t_start,
        "hi_ttft_idle_s": idle[0].get("first", t_idle) - t_idle,
        "victim_preempted_s": snaps[0].slot_obj.preempted_s if snaps else None,
        "victim_tokens": len(times[0].get("text", "")),
        "decode_launches_after_restore": after_restore,
        "memory_stats": st,
    }
    checks = {
        "one snapshot, of the victim": len(snaps) == 1 and snaps[0].req_id == victim.request_id,
        "preempted == 1": report["preempted"] == 1,
        "restored == 1": report["restored"] == 1,
        "preempted_held == 0": st["preempted_held"] == 0.0,
        "victim text == uncontended": times[0].get("text") == alone[0].get("text"),
        "ledger clean": pg["leaks"] == 0 and pg["slot_tables"] == 0 and pg["snap_parked"] == 0,
        "no missing pin": pg.get("physical_missing_pins", 0.0) == 0,
        "packed scales == s": eng.kv_scale_audit() == 0,
        "decode kernels launched after the restore": sum(after_restore.values()) > 0,
    }
    report["checks"] = checks
    log(f"preempt {tag}: {json.dumps(report)}")
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        check_failed(f"preempt {tag}: {bad}")
    return report


def preempt_phase() -> dict:
    """KV memory on the card (`TPU_KV_HOST_OFFLOAD=1`, set here only, and
    `TPU_SPEC=0`: a victim's text is held to its uncontended text, and
    with speculation on the greedy tokens depend on where the verify
    rounds fall, which contention moves; see `spec_phase`): fresh engines
    at full width and depth, rounds captured, pipeline depth 2, one
    parameter tree a model. Llama-3.1-8B int8 (int8 weights and KV,
    8 slots): `_preempt_cycle` with the victim admitted off a block-aligned
    prefix hit (its snapshot private-only) and, on a second engine, off an
    unaligned one (whole); then shedding over HTTP on a third
    (`_shed_check`). DeepSeek-V2-Lite int8 (int8 latents, 4 slots,
    shorter prompts): the aligned cycle. The device memory of each model's
    engines is released afterwards."""
    import os

    import torch

    from llm_mcp_tpu_torch.executor import GenerationEngine

    env0 = {k: os.environ.get(k) for k in ("TPU_KV_HOST_OFFLOAD", "TPU_SPEC")}
    os.environ.update(TPU_KV_HOST_OFFLOAD="1", TPU_SPEC="0")
    out: dict = {}
    try:
        for model, slots, chars, cases in (
                ("llama-3.1-8b", 8, 1000, (("aligned", SYSTEM_LONG + "\n"),
                                           ("unaligned", UNALIGNED_PREFIX))),
                (MLA_MODEL, 4, 400, (("aligned", SYSTEM_LONG + "\n"),))):
            tag = f"{model} int8"
            gc.collect()
            torch.cuda.empty_cache()
            mem0 = torch.cuda.memory_allocated()
            params, leaf, report = None, None, {}
            longs = [_long_prompt(i, chars) for i in range(slots - 1)]
            for name, prefix in cases:
                t0 = time.time()
                eng = GenerationEngine(model, params=params, max_slots=slots, max_seq_len=4096,
                                       prefill_chunk=512, seed=0, quant="int8", kv_quant="int8",
                                       device="cuda")
                params = eng.params
                leaf = leaf or weakref.ref(_first_leaf(params["layers"]))
                built = {"s": time.time() - t0, "pipeline_depth": eng.pipeline_depth,
                         "cuda_graphs": eng.cuda_graphs,
                         "bytes_per_slot": eng.memory_stats()["bytes_per_slot"]}
                try:
                    report[name] = _preempt_cycle(eng, f"{tag} {name}", prefix, longs, chars)
                finally:
                    eng.shutdown()
                report[name]["engine"] = built
                sn = report[name]["snapshots"]
                whole = name == "unaligned"
                if not sn or any((s["shared_len"] == 0) != whole
                                 or s["rows"] != s["length"] - s["shared_len"] for s in sn):
                    check_failed(f"preempt {tag} {name}: snapshot rows {sn}")
                del eng
            if model != MLA_MODEL:
                report["shed"] = _shed_check(params)
                report["host_copies"] = host_copy_timing()
            del params
            report["released"] = _released(f"preempt {tag}", mem0, leaf)
            out[tag] = report
    finally:
        for k, v in env0.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out


def host_copy_timing(rows: int = 1127, reps: int = 3) -> dict:
    """Where an offload's time goes, at the Llama int8 snapshot's shape (a
    slot's `rows` rows of a fused [32, B, 17, S, 128] int8 cache, strided
    over layers): the pinned allocation, the strided copy into it, the
    device gather, a contiguous copy into pinned and into pageable memory,
    and the copy back from pinned memory; host clock around synchronised
    work, `reps` times (the first meets a pinned size for the first time)."""
    import torch

    cache = torch.zeros((32, 2, 17, 2048, 128), dtype=torch.int8, device="cuda")
    src = cache[:, 1:2, :, :rows]
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        pinned = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        t.append(time.perf_counter())
        pinned.copy_(src, non_blocking=True)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        dense = src.contiguous()
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        pinned.copy_(dense, non_blocking=True)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        torch.empty(src.shape, dtype=src.dtype).copy_(dense)
        t.append(time.perf_counter())
        dense.copy_(pinned, non_blocking=True)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        ms = [(b - a) * 1e3 for a, b in zip(t, t[1:])]
        out.append(dict(zip(("pin_alloc_ms", "d2h_strided_pinned_ms", "gather_ms",
                             "d2h_pinned_ms", "d2h_pageable_ms", "h2d_pinned_ms"), ms)))
        del pinned, dense
    report = {"bytes": src.numel(), "runs": out}
    log(f"host copies: {json.dumps(report)}")
    return report


def _shed_check(params) -> dict:
    """429 over HTTP at `TPU_ADMIT_WATERMARK=1.0`: a Llama int8 engine of 2
    slots (sharing `params`) admits two requests that may grow to the whole
    context (the loop stepped by hand, then left stopped, so that neither
    can end), so its offered load is at the watermark; a chat is shed."""
    import os

    from llm_mcp_tpu_torch.api.inference import serve
    from llm_mcp_tpu_torch.executor import GenerationEngine, GenRequest

    prev = os.environ.get("TPU_ADMIT_WATERMARK")
    os.environ["TPU_ADMIT_WATERMARK"] = "1.0"  # read at construction
    try:
        eng = GenerationEngine("llama-3.1-8b", params=params, max_slots=2, max_seq_len=4096,
                               prefill_chunk=512, seed=0, quant="int8", kv_quant="int8",
                               device="cuda")
    finally:
        if prev is None:
            del os.environ["TPU_ADMIT_WATERMARK"]
        else:
            os.environ["TPU_ADMIT_WATERMARK"] = prev
    # each may grow to the whole context: one slot-equivalent apiece
    for i in range(2):
        eng.submit(GenRequest(prompt_ids=eng.tokenizer.encode(f"Hold slot {i}."),
                              max_tokens=4096, temperature=0.0))
    _step_until(eng, lambda: all(s is not None for s in eng._slots))
    api = serve({eng.cfg.name: eng}, "127.0.0.1", 0)
    try:
        shed0 = eng.memory_stats()["shed_total"]
        gate = eng.admission_state()
        body = {"model": eng.cfg.name, "max_tokens": 8,
                "messages": [{"role": "user", "content": "Am I shed?"}]}
        status, retry = None, None
        try:
            with _post(f"http://127.0.0.1:{api.port}/v1/chat/completions", body, timeout=60) as r:
                status = r.status
        except urllib.error.HTTPError as e:
            status, retry = e.code, e.headers.get("Retry-After")
        st = eng.memory_stats()
    finally:
        api.shutdown()
        eng.shutdown()  # errors the two held requests
    report = {"admission_state": gate, "status": status, "retry_after": retry,
              "shed_total_delta": st["shed_total"] - shed0, "offered": st["offered"],
              "watermark": st["watermark"]}
    checks = {"429": status == 429,
              "Retry-After in [1, 600]": retry is not None and 1 <= int(retry) <= 600,
              "shed_total moved by 1": report["shed_total_delta"] == 1}
    report["checks"] = checks
    log(f"preempt shed: {json.dumps(report)}")
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        check_failed(f"shedding over HTTP: {bad}")
    del eng, api
    return report


# The decoder families served on the card: (tag, catalog name,
# layers kept (0: all), engine options, the kernels their chats must launch,
# the GQA kernels they must not: windowed and softcapped families take plain
# torch for decode and bucketed chunks, as JAX takes XLA)
_PLAIN_ATTN = ("decode_attend_bf16", "decode_attend_bf16_paged", "append_kv_bf16_fused",
               "decode_attend_q8", "decode_attend_q8_paged", "append_kv_q8_fused",
               "ragged_prefill_attend_bf16", "ragged_prefill_attend_bf16_paged",
               "ragged_prefill_attend_q8", "ragged_prefill_attend_q8_paged")
_BF16_PATH = ("flash_prefill_attention", "ragged_prefill_attend_bf16", "decode_attend_bf16",
              "append_kv_bf16_fused")
_Q8_PATH = ("flash_prefill_attention", "ragged_prefill_attend_q8", "decode_attend_q8",
            "append_kv_q8_fused")
_HD128_GQA = ("flash_prefill_attention", "decode_attend_bf16", "decode_attend_bf16_paged",
              "append_kv_bf16_fused", "ragged_prefill_attend_bf16",
              "ragged_prefill_attend_bf16_paged") + Q8_KERNELS
FAMILIES = (
    ("qwen2.5-7b int8", "qwen2.5-7b", 0,
     dict(quant="int8", kv_quant="int8", max_slots=Q8_SLOTS), _Q8_PATH, ()),
    ("gemma2-9b bf16", "gemma2-9b", 0, dict(max_slots=4, max_seq_len=8192),
     ("flash_prefill_attention_hd256",), _PLAIN_ATTN + ("flash_prefill_attention",)),
    ("mistral-7b bf16 (4 layers)", "mistral-7b", 4, dict(max_slots=8),
     ("flash_prefill_attention",), _PLAIN_ATTN),
    ("qwen3-8b bf16 (4 layers)", "qwen3-8b", 4, dict(max_slots=8), _BF16_PATH, ()),
    ("deepseek-r1-distill-llama-8b bf16 (4 layers)", "deepseek-r1-distill-llama-8b", 4,
     dict(max_slots=8), _BF16_PATH, ()),
    ("deepseek-r1-distill-qwen-1.5b bf16", "deepseek-r1-distill-qwen-1.5b", 0,
     dict(max_slots=8), _BF16_PATH, ()),
    ("mixtral-8x7b int8 (4 layers)", "mixtral-8x7b", 4,
     dict(quant="int8", kv_quant="int8", max_slots=Q8_SLOTS), _Q8_PATH, ()),
    # head_dim 64: the _hd64 arms, and no 128 arm
    ("llama-3.2-1b bf16", "llama-3.2-1b", 0, dict(max_slots=8),
     tuple(n + "_hd64" for n in _BF16_PATH), _HD128_GQA),
    ("qwen2.5-0.5b int8", "qwen2.5-0.5b", 0,
     dict(quant="int8", kv_quant="int8", max_slots=Q8_SLOTS),
     tuple(n + "_hd64" for n in _Q8_PATH), _HD128_GQA),
)
# the families that also serve the prefix traffic, and the paged kernels it
# must launch
FAMILY_PREFIX = {
    "qwen2.5-7b int8": ("decode_attend_q8_paged", "ragged_prefill_attend_q8_paged"),
    "llama-3.2-1b bf16": ("decode_attend_bf16_paged_hd64", "ragged_prefill_attend_bf16_paged_hd64"),
    "qwen2.5-0.5b int8": ("decode_attend_q8_paged_hd64", "ragged_prefill_attend_q8_paged_hd64"),
}
GEMMA_LONG = " ".join(f"Note {i}: the window keeps the last 4096 tokens." for i in range(110))


def _held_engine(cfg, params, graphs: bool, **engine_kw):
    """A fresh engine over `params`, the round captured or eager, with the
    prefill budget held at AB_BUDGET tokens a round, so that runs with the
    round eager and captured admit, chunk and dispatch alike."""
    from llm_mcp_tpu_torch.executor import GenerationEngine

    eng = GenerationEngine(cfg, params=params, cuda_graphs=graphs, seed=0, **engine_kw)
    eng._sched.decide = lambda backlog, n_active, wait, reserved_tokens=0: min(backlog, AB_BUDGET)
    return eng


def _record_tokens(eng) -> dict:
    """Wrap the engine's token hook: returns {request_id: [token, ...]},
    filled as the engine emits."""
    seen: dict = {}
    process = eng._process_token

    def rec(s, tok, pos):
        seen.setdefault(s.req.request_id, []).append(int(tok))
        return process(s, tok, pos)

    eng._process_token = rec
    return seen


def _greedy_tokens(eng, prompts: list[str], max_tokens: int,
                   one_at_a_time: bool = False) -> tuple[list, int]:
    """Greedy tokens of `prompts` on `eng` (not yet started), queued before
    the loop starts, or each after the last finished; shuts the engine
    down. Returns the tokens per prompt and the rounds replayed from a
    captured graph."""
    from llm_mcp_tpu_torch.executor import GenRequest

    seen = _record_tokens(eng)
    reqs = [GenRequest(prompt_ids=eng.tokenizer.encode(p), max_tokens=max_tokens,
                       temperature=0.0) for p in prompts]

    def wait(r):
        while True:
            evt = r.out.get(timeout=600)
            if not isinstance(evt, dict) or evt["type"] in ("done", "error"):
                if not isinstance(evt, dict) or evt["type"] != "done":
                    fail(f"greedy tokens {eng.cfg.name}: a request did not finish: {evt}")
                return

    if one_at_a_time:
        eng.start()
        for r in reqs:
            eng.submit(r)
            wait(r)
    else:
        for r in reqs:
            eng.submit(r)
        eng.start()
        for r in reqs:
            wait(r)
    eng.shutdown()
    return [seen.get(r.request_id, []) for r in reqs], eng._graphs.replays if eng._graphs else 0


def families_phase() -> dict:
    """Each configuration of FAMILIES at published widths (depth as listed),
    random weights from seed 0, the engine's defaults otherwise
    (max_seq_len 4096 unless listed, prompt cache 256 MiB): the four chats
    over HTTP (counters reset just before, read just after: its kernels
    launched, the excluded ones not), every stream finished, SSE ending in
    [DONE]; Gemma-2 also a prompt past its 4096-token window; then the
    greedy chats with the round captured and eager on fresh engines over
    the same weights: identical tokens, and the captured run replayed at
    least one round from its graph."""
    import dataclasses

    import torch

    from llm_mcp_tpu_torch.api.inference import serve
    from llm_mcp_tpu_torch.executor import GenerationEngine
    from llm_mcp_tpu_torch.kernels import attention as K
    from llm_mcp_tpu_torch.models.configs import get_config

    out: dict[str, dict] = {}
    for tag, name, layers, kw, must, must_not in FAMILIES:
        t0 = time.time()
        cfg = get_config(name)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        kw = dict(dict(max_seq_len=4096, prefill_chunk=512), **kw)
        mem0 = torch.cuda.memory_allocated()
        engine = GenerationEngine(cfg, seed=0, device="cuda", **kw)
        leaf = weakref.ref(_first_leaf(engine.params["layers"]))
        torch.cuda.synchronize()
        built_s = time.time() - t0
        engine.start()
        api = serve({cfg.name: engine}, "127.0.0.1", 0)
        base = f"http://127.0.0.1:{api.port}"
        try:
            res = e2e_phase(engine, base, kernels=must)
            if tag in FAMILY_PREFIX:  # through the tables: prefix hits
                res["prefix"] = prefix_phase(engine, base, kernels=FAMILY_PREFIX[tag])
            long_res: dict = {}
            if cfg.sliding_window and kw["max_seq_len"] > cfg.sliding_window:
                chat(base, cfg.name, GEMMA_LONG, True, long_res, max_tokens=16, temperature=0)
                if "error" in long_res or not long_res.get("done"):
                    fail(f"{tag}: the prompt past the window did not finish: {long_res}")
                if long_res["usage"]["prompt_tokens"] <= cfg.sliding_window:
                    fail(f"{tag}: the long prompt did not pass the window")
                res["past_window"] = {k: long_res[k] for k in ("usage", "finish", "t_end")}
            launches = dict(K.LAUNCHES)
        finally:
            api.shutdown()
            engine.shutdown()
        for n in must_not:
            if launches[n]:
                check_failed(f"{tag}: {n} launched {launches[n]} times; this family takes "
                             "the plain path there")
        params = engine.params
        del engine, api
        gc.collect()
        torch.cuda.empty_cache()
        prompts = [p for _, p, _, c in CHATS if c["temperature"] == 0]
        runs = []
        for graphs in (True, False):  # one engine at a time
            runs.append(_greedy_tokens(_held_engine(cfg, params, graphs, **kw), prompts, 24))
            gc.collect()
            torch.cuda.empty_cache()
        (on, replays), (off, _) = runs
        if on != off:
            check_failed(f"{tag}: greedy tokens with the round captured differ from eager: "
                         f"first parting at {[_first_diff(a, b) for a, b in zip(on, off)]}")
        if not replays:
            check_failed(f"{tag}: the captured run replayed no round")
        del params
        res.update(built_s=built_s, layers=cfg.n_layers, engine=kw, launches_after_long=launches,
                   greedy_captured_equals_eager=on == off, captured_replays=replays,
                   seconds=time.time() - t0, released=_released(tag, mem0, leaf))
        out[tag] = res
        log(f"family {tag}: {time.time() - t0:.1f} s, launches "
            f"{json.dumps({k: v for k, v in launches.items() if v})}")
    return out


def checkpoint_phase() -> dict:
    """A Qwen2.5-7B checkpoint at full width and 2 layers (random bf16
    weights from seed 0), written by the port as two safetensors shards,
    `model.safetensors.index.json`, config.json and the real-vocabulary
    fixture's tokenizer.json into a temporary directory, then served by
    `weights_dir`: its first-step logits and greedy tokens must equal, bit
    for bit, those of an engine built from the same tree by
    `params_from_numpy`. Reports the load's seconds and GB/s. The same
    phase builds the native BPE with g++ and holds its piece encodings
    against the Python merge core, and reports which of regex, tokenizers,
    safetensors and ml_dtypes import and the backend load_tokenizer chose."""
    import dataclasses
    import importlib
    import shutil
    import tempfile

    import numpy as np
    import torch

    from llm_mcp_tpu_torch import native
    from llm_mcp_tpu_torch.executor import GenerationEngine
    from llm_mcp_tpu_torch.executor.bpe import _NativeBpeCore, _PyBpeCore, BPETokenizer
    from llm_mcp_tpu_torch.executor.tokenizer import load_tokenizer
    from llm_mcp_tpu_torch.kernels import attention as K
    from llm_mcp_tpu_torch.models.configs import get_config
    from llm_mcp_tpu_torch.models.llama import init_llama_params, llama_prefill
    from llm_mcp_tpu_torch.models.weights import (
        llama_to_hf_tensors, params_from_numpy, write_checkpoint_dir)

    t0 = time.time()
    res: dict = {}
    modules = {}
    for m in ("regex", "tokenizers", "safetensors", "ml_dtypes"):
        try:
            importlib.import_module(m)
            modules[m] = True
        except ImportError:
            modules[m] = False
    res["imports"] = modules
    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                           "tiny_real_vocab")
    tok = load_tokenizer(fixture)
    res["tokenizer_backend"] = type(tok).__name__ + (
        (" (native core)" if tok.is_native else " (python core)") if isinstance(tok, BPETokenizer)
        else "")
    if not modules["regex"]:
        log("checkpoint: `regex` is missing here, so the in-repo BPE cannot split a real "
            "vocabulary's pre-tokens on this machine (ROADMAP queue 1 item 6)")
    # the native core, built here with g++, against the Python merge core
    tb = time.time()
    built = native.build()
    res["native_build_s"] = time.time() - tb
    if not built or native.load_bpe() is None:
        check_failed("checkpoint: the native BPE library did not build or load")
    elif modules["regex"]:
        nat, py = BPETokenizer(os.path.join(fixture, "tokenizer.json")), BPETokenizer(
            os.path.join(fixture, "tokenizer.json"), force_python=True)
        if not (isinstance(nat.core, _NativeBpeCore) and isinstance(py.core, _PyBpeCore)):
            check_failed("checkpoint: the BPE cores are not the native and Python ones")
        texts = [p for _, p, _, _ in CHATS] + [SYSTEM_LONG, "naïve café 中文字符 🚀"]
        pieces = [p.encode("utf-8") for t in texts for p in nat._pretok.findall(t)]
        same = sum(nat.core.encode_piece(p) == py.core.encode_piece(p) for p in pieces)
        res["bpe_pieces"] = {"pieces": len(pieces), "identical": same}
        if same != len(pieces):
            check_failed(f"checkpoint: native BPE pieces differ from the Python core's: "
                         f"{res['bpe_pieces']}")

    cfg = dataclasses.replace(get_config("qwen2.5-7b"), n_layers=2, name="qwen2.5-7b-2l")
    g = torch.Generator(device="cuda").manual_seed(0)
    tree = init_llama_params(cfg, g, torch.bfloat16, device="cuda")
    host = {k: ({n: t.cpu() for n, t in v.items()} if isinstance(v, dict) else v.cpu())
            for k, v in tree.items()}
    del tree
    ckpt = tempfile.mkdtemp(prefix="qwen2l-")
    try:
        tw = time.time()
        hf = llama_to_hf_tensors(cfg, host)
        nbytes = sum(t.numel() * t.element_size() for t in hf.values())
        write_checkpoint_dir(ckpt, hf, shards=2, config={
            "model_type": "qwen2", "vocab_size": cfg.vocab_size, "hidden_size": cfg.dim,
            "num_hidden_layers": cfg.n_layers, "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads, "intermediate_size": cfg.ffn_hidden,
            "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.norm_eps,
            "max_position_embeddings": cfg.max_seq_len, "tie_word_embeddings": False})
        shutil.copy(os.path.join(fixture, "tokenizer.json"), ckpt)
        res["write_s"] = time.time() - tw
        del hf
        kw = dict(max_slots=4, max_seq_len=4096, prefill_chunk=512, seed=0, device="cuda",
                  weights_dir=ckpt)
        eng = GenerationEngine("qwen2.5-7b-2l", **kw)
        res.update(load_s=eng.load_seconds, bytes=nbytes,
                   load_gb_per_s=nbytes / max(eng.load_seconds, 1e-9) / 1e9,
                   shards=sorted(f for f in os.listdir(ckpt) if f.endswith(".safetensors")),
                   config_layers=eng.cfg.n_layers, tokenizer=type(eng.tokenizer).__name__)
        tree_np = {k: ({n: t.float().numpy() for n, t in v.items()} if isinstance(v, dict)
                       else v.float().numpy()) for k, v in host.items()}
        ref_params = params_from_numpy(tree_np, eng.cfg, "cuda", torch.bfloat16)
        del tree_np, host
        ref = GenerationEngine("qwen2.5-7b-2l", params=ref_params, **kw)
        same_tree = all(torch.equal(a, b) for a, b in zip(_leaves(eng.params), _leaves(ref_params)))
        prompt = ("Summarize the following in one line: " + SYSTEM_LONG)
        ids = eng.tokenizer.encode(prompt)
        tokens = torch.tensor([ids], dtype=torch.int32, device="cuda")
        lengths = torch.tensor([len(ids)], dtype=torch.int32, device="cuda")
        la = llama_prefill(eng.cfg, eng.params, tokens, lengths)[0]
        lb = llama_prefill(ref.cfg, ref_params, tokens, lengths)[0]
        res["first_step_logits_equal"] = bool(torch.equal(la, lb))
        K.reset_launches()
        # one at a time: both engines schedule alike
        greedy = [_greedy_tokens(e, [prompt, "Hello there, how are you today?"], 16,
                                 one_at_a_time=True)[0] for e in (eng, ref)]
        res.update(prompt_tokens=len(ids), trees_equal=same_tree, launches=dict(K.LAUNCHES),
                   greedy_tokens_equal=greedy[0] == greedy[1],
                   greedy_tokens=[len(t) for t in greedy[0]])
        if not (same_tree and res["first_step_logits_equal"] and greedy[0] == greedy[1]):
            check_failed(f"checkpoint: the loaded engine differs from params_from_numpy's: "
                         f"trees {same_tree}, logits {res['first_step_logits_equal']}, greedy "
                         f"{greedy}")
        if not all(greedy[0]):
            check_failed(f"checkpoint: a request produced no token: {greedy[0]}")
        del eng, ref, ref_params
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    res["seconds"] = time.time() - t0
    log(f"checkpoint: {json.dumps(res)}")
    return res


# the embedders (phase 13): row 1d and embed_phase
EMBED_ROW = "flash_prefill_attention_embed"  # in FAMILY_ROWS
EMBED_BATCH = 64  # BASELINE config 4: batch-64 /v1/embeddings, Matryoshka dimensions=1024
EMBED_DIMS = 1024
EMBED_LENGTHS = [16 + (496 * i) // (EMBED_BATCH - 1) for i in range(EMBED_BATCH)]  # 16..512
EMBED_COSINE = 0.999  # one input alone against the same input inside the batch


def kernel_phase_embed() -> dict[str, dict]:
    """Row 1d: the head_dim-128 flash prefill kernel at the embedding batch
    shape of Qwen3-Embedding-8B (`llama_encode`): 64 rows at 32/8 heads in
    the 512 bucket, lengths EMBED_LENGTHS (16 to 512), against its plain
    version, held to bit-equal repeats; the library yardstick is SDPA with
    the same boolean causal-and-length mask (K/V heads repeated outside the
    timed call). Its `counter` is row 1's LAUNCHES name. JAX's embedding
    path runs no Pallas kernel (its `llama_encode` takes the XLA branch):
    the row's `replaces` names row 1's kernel, whose function it computes."""
    import torch
    import torch.nn.functional as F

    from llm_mcp_tpu_torch.kernels import attention as K

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1818)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    B, S, H, Hkv, hd = EMBED_BATCH, 512, 32, 8, 128
    q, k, v = rn(B, H, S, hd), rn(B, Hkv, S, hd), rn(B, Hkv, S, hd)
    lens = torch.tensor(EMBED_LENGTHS, dtype=torch.int32, device=dev)
    call = functools.partial(K.flash_prefill_attention, q, k, v, lens)
    plain = functools.partial(K.flash_prefill_plain, q, k, v, lens)
    out, ref = call(), plain()
    pos = torch.arange(S, device=dev)
    mask = ((pos[None, :] <= pos[:, None])[None] & (pos[None, None, :] < lens[:, None, None]))
    kx, vx = k.repeat_interleave(H // Hkv, 1), v.repeat_interleave(H // Hkv, 1)
    lib = functools.partial(F.scaled_dot_product_attention, q, kx, vx, attn_mask=mask[:, None])
    pairs = sum(min(t + 1, n) for n in EMBED_LENGTHS for t in range(S))
    # bytes: Q read and O written over every row, K and V read only below
    # each row's length (the keys the function needs)
    kv_read = 2 * sum(EMBED_LENGTHS) * Hkv * hd
    res: dict[str, dict] = {}
    _record(res, EMBED_ROW, out, ref, time_ms(call, 20), time_ms(plain, 5),
            (2 * q.numel() + kv_read) * 2, 4.0 * hd * H * pairs / BF16_FLOPS * 1e3,
            time_ms(lib, 20),
            {"q": [B, H, S, hd], "kv_heads": Hkv, "lengths": "16 to 512, EMBED_LENGTHS",
             "library": "SDPA, boolean causal and length mask, K/V heads repeated"})
    res[EMBED_ROW].update(counter="flash_prefill_attention",
                          repeats_bitwise=repeat_check(EMBED_ROW, call))
    del q, k, v, kx, vx, mask
    torch.cuda.empty_cache()
    return res


def _embed_texts(n: int, lengths: list[int], seed: int) -> list[str]:
    """Inputs of the given token counts under the byte tokenizer (one token
    a byte, plus BOS): seeded lowercase words."""
    import random

    rs = random.Random(seed)
    words = [rs.choice(["alpha", "beta", "gamma", "delta", "kernel", "vector", "token", "query"])
             for _ in range(2 * max(lengths))]
    text = " ".join(words)
    return [text[i % 97:][: lengths[i] - 1] for i in range(n)]


def embed_model_check(eng) -> dict:
    """The engine's first CHECK_LAYERS layers (published widths, the served
    weights) on the card against the same function on the host (the plain
    versions): 4 rows in the 64 bucket, one of length 1, cosine >=
    MODEL_COSINE per vector. The host runs in float32; at int8 weights it
    runs in the served dtype, as `model_check` does at int8 (w8a8 rounds
    each activation row to int8 steps, so float32 activations round apart
    from bf16 ones); the float32 host's cosine is reported beside, and so
    is the float32 host's against the served-dtype host on the same tree,
    the gap the dtype makes with no card in it. Returns the report; a miss
    is a failed check."""
    import dataclasses

    import torch

    cut = dataclasses.replace(eng.cfg, n_layers=CHECK_LAYERS)

    def cut_layers(v):
        return {k: cut_layers(x) for k, x in v.items()} if isinstance(v, dict) \
            else v[:CHECK_LAYERS]

    def on_host(v, f32):
        if isinstance(v, dict):
            return {k: on_host(x, f32) for k, x in v.items()}
        v = v.cpu()
        return v.float() if f32 and v.is_floating_point() else v

    tree = {**eng.params, "layers": cut_layers(eng.params["layers"])}
    toks = torch.randint(3, 259, (4, 64), generator=torch.Generator().manual_seed(8),
                         dtype=torch.int32)
    lens = torch.tensor([64, 40, 1, 17], dtype=torch.int32)
    got = eng._fwd(cut, tree, toks.to(eng.device), lens.to(eng.device)).cpu()
    report: dict = {"layers": CHECK_LAYERS, "finite": bool(got.isfinite().all()),
                    "host": "served dtype" if eng.quant else "float32"}
    wants = {}
    for f32 in (True, False) if eng.quant else (True,):
        want = wants[f32] = eng._fwd(cut, on_host(tree, f32), toks, lens)
        cos = torch.nn.functional.cosine_similarity(got, want, dim=-1).min().item()
        err = (got - want).abs().max().item()
        if f32 and eng.quant:
            report["host_float32"] = {"cosine_min": cos, "max_abs_err": err}
        else:
            report.update(cosine_min=cos, max_abs_err=err)
    if eng.quant:
        # the host alone, float32 against the served dtype on the same int8
        # tree: the gap the dtype makes without the card
        report["host_float32_vs_served_dtype"] = {
            "cosine_min": torch.nn.functional.cosine_similarity(
                wants[True], wants[False], dim=-1).min().item(),
            "max_abs_err": (wants[True] - wants[False]).abs().max().item()}
    log(f"embed {eng.cfg.name} model check: {json.dumps(report)}")
    if not (report["finite"] and report["cosine_min"] >= MODEL_COSINE):
        check_failed(f"embed {eng.cfg.name}: the 2-layer cut on the card disagrees with the "
                     f"host's plain path: {report}")
    return report


def _embed_request(base: str, model: str, texts: list[str], dims: int | None = None) -> dict:
    body = {"model": model, "input": texts}
    if dims:
        body["dimensions"] = dims
    with _post(base + "/v1/embeddings", body) as r:
        return json.loads(r.read())


def _embed_config(base: str, model: str, eng, tag: str, texts: list[str], dims: int | None,
                  reps: int, per_call: int) -> dict:
    """One configuration over HTTP: a warm request, then `reps` timed ones
    of all `texts` with the launch counters set to 0 just before each and
    read just after (the generator is idle): the flash kernel must have
    launched `per_call` times a forward call and nothing else any time.
    Every vector must be of unit norm and the requested length. Returns
    embeds/s, p50 latency, peak memory and the launches."""
    import torch

    from llm_mcp_tpu_torch.kernels import attention as K

    want_len = dims or eng.cfg.dim
    _embed_request(base, model, texts, dims)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lat, launches, bad = [], [], []
    for _ in range(reps):
        K.reset_launches()
        t0 = time.perf_counter()
        doc = _embed_request(base, model, texts, dims)
        lat.append(time.perf_counter() - t0)
        launches.append({n: c for n, c in K.LAUNCHES.items() if c})
        vecs = [d["embedding"] for d in doc["data"]]
        norms = [math.sqrt(sum(x * x for x in vec)) for vec in vecs]
        if len(vecs) != len(texts) or any(len(vec) != want_len for vec in vecs) or any(
                not abs(nm - 1.0) <= 1e-3 for nm in norms):
            bad.append({"vectors": len(vecs), "lengths": sorted({len(x) for x in vecs}),
                        "norms": [min(norms, default=0), max(norms, default=0)]})
    calls = -(-len(texts) // eng.max_batch)
    want_launches = {"flash_prefill_attention": per_call * calls} if per_call else {}
    out = {
        "inputs": len(texts), "dimensions": want_len, "reps": reps,
        "tokens": doc["usage"]["total_tokens"],
        "p50_latency_s": sorted(lat)[len(lat) // 2], "latencies_s": lat,
        "embeds_per_s": len(texts) * reps / sum(lat),
        "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": launches[-1], "forward_calls_per_request": calls,
    }
    log(f"embed {tag}: {json.dumps(out)}")
    if bad:
        check_failed(f"embed {tag}: vectors not of unit norm and length {want_len}: {bad}")
    if any(ln != want_launches for ln in launches):
        check_failed(f"embed {tag}: launches {launches}, expected {want_launches} a request")
    return out


def _alone_vs_batch(base: str, model: str, texts: list[str], dims: int | None, tag: str) -> float:
    """Cosine of one input embedded alone against the same input inside the
    batch; below EMBED_COSINE is a failed check."""
    alone = _embed_request(base, model, texts[-1:], dims)["data"][0]["embedding"]
    inside = _embed_request(base, model, texts, dims)["data"][-1]["embedding"]
    cos = sum(a * b for a, b in zip(alone, inside)) / math.sqrt(
        sum(a * a for a in alone) * sum(b * b for b in inside))
    log(f"embed {tag}: alone vs inside the batch of {len(texts)}: cosine {cos}")
    if not cos >= EMBED_COSINE:
        check_failed(f"embed {tag}: one input alone against the batch: cosine {cos} "
                     f"< {EMBED_COSINE}")
    return cos


def _chat_rate(base: str, model: str) -> dict:
    r: dict = {}
    chat(base, model, "Count slowly from one to one hundred, one number a line.", True, r,
         max_tokens=128, temperature=0)
    if "error" in r or not r.get("finish") or r.get("t_last") is None:
        fail(f"embed phase: the chat did not finish: {r}")
    n = r["usage"]["completion_tokens"]
    return {"completion_tokens": n, "tok_per_s": (n - 1) / (r["t_last"] - r["t_first"])}


def embed_phase(gen) -> dict:
    """BASELINE's embedding configurations over HTTP, on one server with the
    running generator `gen` (Llama-3.1-8B bf16) and an embedding engine, as
    `python -m llm_mcp_tpu_torch.api` serves them (max_seq_len
    min(4096, 8192), max_batch 64), each full depth on random weights from
    seed 0:

      - config 1, nomic-embed-text bf16: one input a request;
      - config 4, qwen3-embedding-8b bf16: 64 inputs of 16 to 512 tokens
        (EMBED_LENGTHS) with `dimensions` 1024; one chat's tok/s beside
        batch-64 requests against the same chat alone;
      - config 4 at `--embed-quant int8` (direct int8 weights): the same batch.

    Each: the 2-layer check against the host (`embed_model_check`), one
    input alone against the batch (the decoder's), and `_embed_config`'s
    embeds/s, p50 latency, peak memory and launches (36 flash launches a
    Qwen3 forward, none for nomic)."""
    import torch

    from llm_mcp_tpu_torch.api.inference import serve
    from llm_mcp_tpu_torch.executor import EmbeddingEngine

    gmodel = gen.cfg.name
    texts64 = _embed_texts(EMBED_BATCH, EMBED_LENGTHS, 11)
    one = _embed_texts(1, [48], 12)
    out: dict = {}
    for tag, model, quant in (("nomic-embed-text bf16", "nomic-embed-text", ""),
                              ("qwen3-embedding-8b bf16", "qwen3-embedding-8b", ""),
                              ("qwen3-embedding-8b int8", "qwen3-embedding-8b", "int8")):
        mem0 = torch.cuda.memory_allocated()
        t0 = time.time()
        eng = EmbeddingEngine(model, max_seq_len=min(4096, 8192), max_batch=EMBED_BATCH,
                              quant=quant, seed=0, device="cuda")
        torch.cuda.synchronize()
        res: dict = {"build_s": time.time() - t0,
                     "weights_gib": (torch.cuda.memory_allocated() - mem0) / 2**30}
        leaf = weakref.ref(_first_leaf(eng.params["layers"]))
        res["model_check"] = embed_model_check(eng)
        api = serve({gmodel: gen}, "127.0.0.1", 0, embed_engines={model: eng})
        base = f"http://127.0.0.1:{api.port}"
        try:
            if model == "nomic-embed-text":
                res["served"] = _embed_config(base, model, eng, tag, one, None, 20, 0)
                res["alone_vs_batch_cosine"] = _alone_vs_batch(base, model, texts64[:8] + one,
                                                               None, tag)
            else:
                res["served"] = _embed_config(base, model, eng, tag, texts64, EMBED_DIMS,
                                              5 if not quant else 3, eng.cfg.n_layers)
                res["alone_vs_batch_cosine"] = _alone_vs_batch(base, model, texts64,
                                                               EMBED_DIMS, tag)
            res["peak_above_before_build_gib"] = res["served"]["peak_allocated_gib"] - mem0 / 2**30
            if tag == "qwen3-embedding-8b bf16":
                res["chat_beside_embeddings"] = _chat_beside(base, gmodel, model, texts64)
            health = json.loads(urllib.request.urlopen(base + "/health", timeout=60).read())
            res["health"] = health["embedders"][model]
        finally:
            api.shutdown()
        del eng, api
        res["released"] = _released(f"embed {tag}", mem0, leaf)
        out[tag] = res
    return out


def _chat_beside(base: str, gmodel: str, model: str, texts: list[str]) -> dict:
    """One greedy chat's decode tok/s alone, then again while batch-64
    embedding requests run back to back beside it."""
    alone = _chat_rate(base, gmodel)
    stop, done = threading.Event(), []

    def embed_loop():
        while not stop.is_set():
            _embed_request(base, model, texts, EMBED_DIMS)
            done.append(time.perf_counter())

    th = threading.Thread(target=embed_loop)
    th.start()
    time.sleep(0.5)  # the first embedding request is on the card
    beside = _chat_rate(base, gmodel)
    stop.set()
    th.join(timeout=600)
    out = {"alone": alone, "beside": beside, "embedding_requests_beside": len(done),
           "ratio": beside["tok_per_s"] / alone["tok_per_s"]}
    log(f"embed chat beside batch-{len(texts)} requests: {json.dumps(out)}")
    return out


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def main() -> None:
    try:
        import torch
    except ImportError as e:
        fail(f"torch is missing: {e}")
    if not torch.cuda.is_available():
        fail("CUDA is not available: this script needs an NVIDIA GPU")
    try:
        from llm_mcp_tpu_torch.kernels import attention as K
        from llm_mcp_tpu_torch.kernels import build
    except ImportError as e:
        fail(f"the port package llm_mcp_tpu_torch is missing: {e}")
    t_start = time.time()
    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {card}")
    if any(a.split("=")[0] == "--planted" for a in sys.argv[1:]):
        print(json.dumps({"planted": planted_phase()}), flush=True)
        print(card, flush=True)
        sys.exit(1 if FAILURES else 0)

    t0 = time.time()
    hd256_only = "--hd256" in sys.argv[1:]
    reports = build.build(("flash_prefill_hd256",) if hd256_only else build.SOURCES,
                          verbose=True)
    log(f"built {len(reports)} kernel libraries in {time.time() - t0:.1f} s")
    for name, text in reports.items():
        for line in text.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
    for source, kernel, n, what in (
            ("flash_prefill", "flash_prefill_kernel", 1, "flash prefill, head_dim 128"),
            ("flash_prefill_hd256", "flash_prefill_hd256_kernel", 1,
             "flash prefill, head_dim 256: a TMA producer warp, two consumer warpgroups"),
            ("flash_prefill_hd64", "flash_prefill_kernel", 1,
             "flash prefill, head_dim 64: one 64-column block"),
            ("ragged_prefill_hd64", "ragged_prefill_", 4,
             "ragged prefill at head_dim 64, bf16 and int8, identity and block tables"),
            ("decode_attend_hd64", "decode_split_kernel", 3, "bf16 decode at head_dim 64"),
            ("decode_attend_hd64", "decode_q8_split_kernel", 10, "int8 decode at head_dim 64"),
            ("ragged_prefill", "ragged_prefill_", 4,
             "ragged prefill, bf16 and int8, identity and block tables"),
            ("decode_attend", "decode_split_kernel", 3, "bf16 decode, three arms"),
            ("decode_attend", "decode_q8_split_kernel", 10,
             "int8 decode: contiguous and paged, packed and plain scales, the exact arm and "
             "the whole row's score pass and split kernel"),
            ("ragged_prefill_mla", "ragged_prefill_mla_kernel", 4,
             "MLA ragged prefill, four arms"),
            ("decode_attend_mla", "mla_", 9,
             "MLA int8 decode: score and PV kernels in four arms each, and the combine")):
        if hd256_only and source != "flash_prefill_hd256":
            continue
        regs = ptxas_report(reports.get(source, ""), kernel)
        log(f"ptxas {kernel} ({what}): {json.dumps(regs)}")
        if source == "flash_prefill_hd256":
            HD256_PTXAS.update(kernels=regs, dynamic_smem_bytes=hd256_smem_bytes())
        if len(regs) < n or any(r.get("spill_stores", 1) or r.get("spill_loads", 1)
                                for r in regs.values()):
            check_failed(f"{kernel} spills or was not reported: {regs}")

    if hd256_only:
        # the head_dim-256 flash rows alone: rows, then the verdict
        print(json.dumps({"kernels": kernel_phase_hd256(), "failures": FAILURES}), flush=True)
        print(card, flush=True)
        sys.exit(1 if FAILURES else 0)
    kernels = kernel_phase()
    kernels.update(kernel_phase_q8())
    kernels.update(kernel_phase_mla())
    kernels.update(kernel_phase_families())
    kernels.update(kernel_phase_hd64())
    kernels.update(kernel_phase_embed())
    if "--kernels" in sys.argv[1:]:
        # the kernel checks alone (planted-fault runs): rows, then the verdict
        print(json.dumps({"kernels": kernels, "failures": FAILURES}), flush=True)
        sys.exit(1 if FAILURES else 0)
    gemm = int8_gemm_phase()

    from llm_mcp_tpu_torch.api.inference import serve
    from llm_mcp_tpu_torch.executor import GenerationEngine

    t0 = time.time()
    mem0 = torch.cuda.memory_allocated()
    engine = GenerationEngine(
        "llama-3.1-8b", max_slots=8, max_seq_len=4096, prefill_chunk=512, seed=0,
        device="cuda",
    )
    leaf = weakref.ref(_first_leaf(engine.params["layers"]))
    torch.cuda.synchronize()
    log(f"llama-3.1-8b random bf16 weights + cache in {time.time() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    check = model_check(engine.cfg, engine.params, engine.device)
    engine.start()
    api = serve({engine.cfg.name: engine}, "127.0.0.1", 0)
    base = f"http://127.0.0.1:{api.port}"
    try:
        e2e = e2e_phase(engine, base)
        prefix = prefix_phase(engine, base)
        constrained = constrain_phase(engine, base)
        embed = embed_phase(engine)
    finally:
        api.shutdown()
        engine.shutdown()
    constrained["step"] = masked_step_timing(engine.cfg, engine.params)
    spec = {"llama-3.1-8b bf16": spec_phase(engine.cfg, engine.params, "llama-3.1-8b bf16")}
    breakdown = breakdown_phase(engine.cfg, engine.params, engine.device)
    cfg, params = engine.cfg, engine.params
    # the bf16 engine goes before the A/B's and the int8 one are built, so
    # the peak reads one engine at a time
    del engine, api
    gc.collect()
    torch.cuda.empty_cache()
    graph_ab = {"llama-3.1-8b bf16": graph_ab_phase(cfg, params, "llama-3.1-8b bf16",
                                                    max_slots=8, max_seq_len=4096,
                                                    prefill_chunk=512)}
    del params
    released = {"llama-3.1-8b bf16": _released("llama-3.1-8b bf16", mem0, leaf)}
    q8 = q8_served_phase()
    released["llama-3.1-8b int8"] = q8.pop("released")
    spec["llama-3.1-8b int8"] = q8.pop("spec")
    breakdown.update(q8.pop("breakdown"))
    graph_ab["llama-3.1-8b int8"] = q8.pop("graph_ab")
    gc.collect()
    torch.cuda.empty_cache()
    mla = mla_served_phase()
    breakdown.update(mla["int8"].pop("breakdown"))
    graph_ab[f"{MLA_MODEL} int8"] = mla["int8"].pop("graph_ab")
    spec[f"{MLA_MODEL} int8"] = mla["int8"].pop("spec")
    for tag in ("int8", "bf16_latents"):
        released[f"{MLA_MODEL} {tag}"] = mla[tag].pop("released")
    preempt = preempt_phase()
    families = families_phase()
    checkpoint = checkpoint_phase()
    if FAILURES:
        fail(f"{len(FAILURES)} check(s) failed: {FAILURES}")

    rows = []
    for name, r in kernels.items():
        if name in FAMILY_ROWS or name in HD64_ROWS:
            src, replaces, phase = FAMILY_ROWS.get(name) or HD64_ROWS[name]
            served = ({"checkpoint": checkpoint}.get(phase) or families.get(phase)
                      or embed.get(phase, {}).get("served") or {})
            counter = r["counter"]
            if "_paged" in counter and "prefix" in served:
                served = served["prefix"]
            row = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                   "launches": served.get("launches", {}).get(counter, 0),
                   "launches_from": phase or "none: no served configuration has this shape"}
            row.update(r)
            rows.append(row)
            continue
        src, replaces = SOURCES[name]
        row = {"name": name, "route": "cuda", "source": src, "replaces": replaces}
        if name in ALSO_REPLACES:
            row["also_replaces"] = ALSO_REPLACES[name]
        # launches on the served path that drives the kernel; no served
        # path drives decode_attention, so its row reads the chats' count,
        # which every served phase checks is 0
        served = (mla["int8"] if name in MLA_Q8_KERNELS
                  else mla["bf16_latents"] if name in MLA_BF16_KERNELS
                  else q8 if name in Q8_KERNELS else prefix if name in PREFIX_KERNELS
                  else q8["row_steps"] if name == "decode_attend_q8_row" else e2e)
        row["launches"] = served["launches"][name]
        row.update(r)
        rows.append(row)
    print(json.dumps({"e2e": e2e, "prefix": prefix, "model_check": check, "int8": q8,
                      MLA_MODEL: mla, "int8_gemm": gemm, "breakdown": breakdown,
                      "graph_ab": graph_ab, "preempt": preempt, "released": released,
                      "constrain": constrained, "spec": spec, "families": families,
                      "checkpoint": checkpoint, "embed": embed,
                      "seconds": time.time() - t_start}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def _first_diff(a: list, b: list) -> int | None:
    """The first index where two token lists part (None: equal)."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def step_logits_both_paths(cfg, params, seq: list[int], quantized: bool) -> tuple:
    """The logits after `seq` computed the two ways a served token can
    come: a decode step (the decode kernels) and a one-token chunk pass
    (`llama_prefill_chunk_batch`, the verify round's arithmetic), both on
    one fresh cache holding seq[:-1] (`llama_prefill`). Returns (z_dec,
    z_chunk), each [V] f32 on the card."""
    import torch

    from llm_mcp_tpu_torch.models import llama as TL

    dev = _first_leaf(params["layers"]).device
    n = len(seq)
    S = 1 << max(6, n.bit_length())
    cache = TL.init_kv_cache(cfg, 1, S, dtype=torch.bfloat16, device=dev, quantized=quantized)
    ck, cv = cache["k"], cache["v"]
    i32 = functools.partial(torch.tensor, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        _, ks, vs = TL.llama_prefill(cfg, params, i32([seq[:-1]]), i32([n - 1]),
                                     quant_kv=quantized)
        for c, k in ((ck, ks), (cv, vs)):
            _tree(lambda a, b: a[:, :, :, : n - 1].copy_(b), c, k)
        chunk_ck, chunk_cv = _tree(torch.clone, ck), _tree(torch.clone, cv)
        z_chunk, _, _ = TL.llama_prefill_chunk_batch(
            cfg, params, chunk_ck, chunk_cv, i32([[seq[-1]]]), i32([0]), i32([n - 1]),
            i32([1]), all_logits=True)
        z_dec, _, _ = TL.llama_decode_step(cfg, params, ck, cv, i32([seq[-1]]), i32([n - 1]))
    return z_dec[0].float(), z_chunk[0, 0].float()


def near_tie(cfg, params, seq: list[int], a: int, b: int, quantized: bool,
             banned=None) -> dict:
    """Where greedy tokens with speculation on and off part after `seq`
    (`a` with it off, `b` on): on one fresh cache, the decode step and the
    chunk pass must both rank {a, b} as their two best tokens among those
    the engine may sample (`banned`: the ids it never samples), so the
    runs parted between the same two candidates, a near tie that rounding
    decides. Reported beside it: the two logits, their gap, the paths'
    largest disagreement on that step, the row's bf16 step and the paths'
    cosine. The gap is not bounded: a one-step recomputation does not
    reproduce the cache rows each run wrote before it (it can rank the
    two tokens in the other order than the run whose arithmetic it
    repeats)."""
    import torch

    z_dec, z_chunk = step_logits_both_paths(cfg, params, seq, quantized)
    cos = float(torch.nn.functional.cosine_similarity(z_dec, z_chunk, dim=0))
    if banned is not None:  # ids never sampled take no part in the choice
        z_dec, z_chunk = (z.masked_fill(banned, -1e9) for z in (z_dec, z_chunk))
    delta = float((z_dec - z_chunk).abs().max())
    top2 = [set(z.topk(2).indices.tolist()) for z in (z_dec, z_chunk)]
    scale = float(z_dec.masked_fill(banned, 0.0).abs().max()) if banned is not None else float(
        z_dec.abs().max())
    return {"at": len(seq), "tokens": [a, b], "logits": [float(z_dec[a]), float(z_dec[b])],
            "gap": float(z_dec[a] - z_dec[b]), "delta": delta, "cosine": cos,
            "bf16_step": 2.0 ** (math.floor(math.log2(max(scale, 1e-30))) - 7),
            "top2": [sorted(t) for t in top2], "near_tie": top2[0] == top2[1] == {a, b}}


def verify_busy_ms(eng, start: int = 500, n: int = 3) -> float | str:
    """Device busy time of one verify call (torch.profiler, the kernels'
    time summed, per call over `n` calls) on a spec-on engine whose
    requests have ended: two rows of K + 1 positions at `start` past keys,
    every position drafted, packed as `_spec_round` packs a round. The
    calls write rows no request reads any more."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    A, K = 2, eng.spec_k
    C = K + 1
    slots = np.arange(A, dtype=np.int32)
    starts = np.full(A, start, dtype=np.int32)
    drafts = np.full((A, K), 70, dtype=np.int32)
    tokens = np.concatenate([np.zeros((A, 1), np.int32), drafts], axis=1)
    keep = np.arange(A * C, dtype=np.int32)
    wpos = (starts[:, None] + np.arange(C, dtype=np.int32)[None, :]).reshape(-1)
    packed = eng._up(np.concatenate([
        tokens.reshape(-1), slots, starts, np.full(A, C, np.int32), drafts.reshape(-1),
        np.full(A, K, np.int32), keep, np.repeat(slots, C), wpos]).astype(np.int32))
    kw = dict(rows=A, n=A, width=C, n_writes=A * C,
              skey=min(1 << (start - 1).bit_length(), eng.max_seq_len))

    def call():
        return eng._verify_fn(packed, paged=None, cn=None, **kw)

    with torch.inference_mode():
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                call()
            torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / n
    return busy if busy > 0 else "not measured"


def spec_phase(cfg, params, tag: str, **engine_kw) -> dict:
    """Self-speculative decoding on the served weights (`engine_kw`: the
    served configuration; 2 slots and 1024 positions here): two greedy
    requests with a repetitive prompt, queued and driven by hand (`_step`,
    as the engine's thread does) on fresh engines with `TPU_SPEC` on and
    off. Fails unless a verify round ran (none with it off) and each
    request's tokens are identical both ways or part only at a near tie
    (`near_tie`: a verify round's chunk pass and the decode kernels round
    differently, so a greedy choice between two tokens whose logits lie
    within that difference may go either way; JAX's verify is the same
    chunk arithmetic). Reports the accept rate, tokens
    per verify call, each verify round's wall (host clock around the
    synchronous round, its upload and fetch included) and device time
    (CUDA events around the verify call: the chunk pass over every
    position, the masks, accept/reject; for eager work this span holds
    the card's idle gaps too) and its device busy time (`verify_busy_ms`),
    tok/s both ways (the requests'
    tokens over the wall from submission to the last token, prefill and
    each round shape's first call and capture included), and the port
    kernels launched during each run."""
    import torch

    from llm_mcp_tpu_torch.executor import GenerationEngine, GenRequest
    from llm_mcp_tpu_torch.kernels import attention as K

    runs: dict[str, dict] = {}
    tokens: dict[str, list] = {}
    dev = _first_leaf(params["layers"]).device  # where the served weights are
    prev = os.environ.get("TPU_SPEC")
    for name, flag in (("on", "1"), ("off", "0")):
        os.environ["TPU_SPEC"] = flag
        try:
            eng = GenerationEngine(cfg, params=params, seed=0, max_slots=2, max_seq_len=1024,
                                   prefill_chunk=512, device=dev, **engine_kw)
        finally:
            if prev is None:
                os.environ.pop("TPU_SPEC", None)
            else:
                os.environ["TPU_SPEC"] = prev
        seen: dict = {}
        process = eng._process_token

        def rec(s, tok, pos, seen=seen, process=process):
            seen.setdefault(s.req.request_id, []).append(int(tok))
            return process(s, tok, pos)

        eng._process_token = rec
        banned = eng._banned
        walls: list[float] = []
        events: list = []
        if eng._verify_fn is not None:
            verify, spec_round = eng._verify_fn, eng._spec_round

            def timed_verify(packed, verify=verify, **kw):
                e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                e0.record()
                out = verify(packed, **kw)
                e1.record()
                events.append((e0, e1))
                return out

            def timed_round(entries, spec_round=spec_round):
                t = time.perf_counter()
                spec_round(entries)
                walls.append(time.perf_counter() - t)

            eng._verify_fn, eng._spec_round = timed_verify, timed_round
        reqs = [GenRequest(prompt_ids=eng.tokenizer.encode(SPEC_PROMPT + tail),
                           max_tokens=SPEC_TOKENS, temperature=0.0)
                for tail in ("", " And once more:")]
        prompts = [r.prompt_ids for r in reqs]
        K.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        _step_until(eng, lambda: eng.finished_requests + eng.total_errors >= len(reqs))
        with torch.inference_mode():
            eng._drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_tok = sum(len(seen.get(r.request_id, [])) for r in reqs)
        run = {"wall_s": wall, "tokens": n_tok, "tok_per_s": n_tok / wall,
               "errors": eng.total_errors, "stats": eng.speculation_stats(),
               "verify_built": eng._verify_fn is not None,
               "launches": {k: v for k, v in K.LAUNCHES.items() if v}}
        if walls:
            device = [a.elapsed_time(b) for a, b in events]
            run.update(verify_rounds=len(walls),
                       verify_wall_ms_mean=sum(walls) / len(walls) * 1e3,
                       verify_wall_ms_median=sorted(walls)[len(walls) // 2] * 1e3,
                       verify_device_ms_mean=sum(device) / len(device),
                       verify_device_ms_median=sorted(device)[len(device) // 2])
        if walls:
            eng._verify_fn = verify
            run["verify_device_busy_ms"] = verify_busy_ms(eng)
        runs[name] = run
        tokens[name] = [seen.get(r.request_id, []) for r in reqs]
        eng.shutdown()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    on, off = runs["on"], runs["off"]
    parts = []
    for ids, t_on, t_off in zip(prompts, tokens["on"], tokens["off"]):
        i = _first_diff(t_on, t_off)
        if i is not None and 0 < i < min(len(t_on), len(t_off)):
            parts.append(near_tie(cfg, params, ids + t_off[:i], t_off[i], t_on[i],
                                  engine_kw.get("kv_quant") == "int8", banned))
        elif i is not None:
            parts.append({"at": i, "near_tie": False})  # a length or a first token differs
    checks = {
        "greedy tokens identical with spec on and off, or parting at a near tie":
        all(p["near_tie"] for p in parts),
        "a verify round ran": on["stats"]["verify_calls"] > 0,
        "drafts accepted": on["stats"]["accepted_tokens"] > 0,
        "spec off builds no verify function": not off["verify_built"]
        and off["stats"]["verify_calls"] == 0,
        "no request errored": on["errors"] == 0 and off["errors"] == 0,
    }
    report = {"card": card_line(), "runs": runs, "checks": checks, "partings": parts,
              "identical": tokens["on"] == tokens["off"],
              "accept_rate": on["stats"]["accept_rate"],
              "tok_per_verify_call": on["stats"]["tok_per_call"],
              "first_difference": [_first_diff(a, b) for a, b in zip(tokens["on"], tokens["off"])]}
    log(f"spec {tag}: {json.dumps(report)}")
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        check_failed(f"spec {tag}: {bad}")
    return report


def constrain_phase(engine, base: str) -> dict:
    """Constrained chats on the bf16 server (greedy, concurrent): a
    json_schema (a closed one: every field an enum or a boolean), a regex
    that forces a repetitive phrase (its drafts compose: masked verify
    rounds), a choice and a forced tool call. Every output must parse or
    match, no token may be illegal, every finished request must end in an
    accepting state; an out-of-range logit_bias must answer 400; the
    constrained slots' masked single steps must have launched the bf16
    decode kernel (counted around each step), and a masked verify must
    have run. Reports each masked step's wall and the host's mask time per
    constrained token."""
    import torch

    from llm_mcp_tpu_torch.kernels import attention as K

    steps: list[tuple[float, int, int]] = []  # (wall s, rows, decode launches)
    cn_step = engine._cn_step_round

    def counted(cn_active, cn_step=cn_step):
        before = K.LAUNCHES["decode_attend_bf16"] + K.LAUNCHES["decode_attend_bf16_paged"]
        t = time.perf_counter()
        cn_step(cn_active)
        steps.append((time.perf_counter() - t, len(cn_active),
                      K.LAUNCHES["decode_attend_bf16"] + K.LAUNCHES["decode_attend_bf16_paged"]
                      - before))

    engine._cn_step_round = counted
    drafted0 = engine.cn_spec_drafted
    cn0 = dict(engine.constrain_stats())
    tools = [{"type": "function", "function": {"name": "lookup", "parameters": CN_SCHEMA}}]
    bodies = {
        "json_schema": {"response_format": {"type": "json_schema",
                                            "json_schema": {"name": "t", "schema": CN_SCHEMA}}},
        "regex": {"response_format": {"type": "regex", "pattern": CN_REGEX}},
        "choice": {"response_format": {"type": "choice", "choices": CN_CHOICES}},
        "tool": {"tools": tools,
                 "tool_choice": {"type": "function", "function": {"name": "lookup"}}},
    }
    outs: dict[str, dict] = {k: {} for k in bodies}

    def ask(kind):
        body = {"model": engine.cfg.name, "max_tokens": 128, "temperature": 0,
                "messages": [{"role": "user", "content": f"Answer as {kind}, please."}],
                **bodies[kind]}
        t = time.perf_counter()
        try:
            with _post(base + "/v1/chat/completions", body) as r:
                doc = json.loads(r.read())
            outs[kind].update(text=doc["choices"][0]["message"]["content"],
                              finish=doc["choices"][0]["finish_reason"], usage=doc["usage"],
                              s=time.perf_counter() - t)
        except Exception as e:  # reported as a failed check below
            outs[kind]["error"] = f"{type(e).__name__}: {e}"

    try:
        threads = [threading.Thread(target=ask, args=(k,)) for k in bodies]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
    finally:
        engine._cn_step_round = cn_step

    def parses(kind, text):
        try:
            if kind == "json_schema":
                doc = json.loads(text)
                return (set(doc) == set(CN_SCHEMA["properties"]) and isinstance(doc["urgent"], bool)
                        and doc["tool"] in CN_SCHEMA["properties"]["tool"]["enum"])
            if kind == "tool":
                doc = json.loads(text)
                return doc["name"] == "lookup" and parses("json_schema", json.dumps(doc["arguments"]))
        except (ValueError, KeyError, TypeError):
            return False
        if kind == "regex":
            return re.fullmatch(CN_REGEX, text) is not None
        return text in CN_CHOICES

    bad_bias = {}
    try:
        with _post(base + "/v1/chat/completions", {
                "model": engine.cfg.name, "max_tokens": 4,
                "messages": [{"role": "user", "content": "hi"}],
                "logit_bias": {str(engine.cfg.vocab_size + 7): 2}}) as r:
            bad_bias = {"status": r.status}
    except urllib.error.HTTPError as e:
        bad_bias = {"status": e.code, "body": e.read().decode()}
    st = engine.constrain_stats()
    launched = sum(n for *_, n in steps)
    checks = {f"{k} output parses or matches": parses(k, o.get("text", "")) for k, o in outs.items()}
    checks.update({
        "no illegal token": st["illegal_tokens"] == 0,
        "every finished constrained request accepting": st["finished_accepting"] - cn0[
            "finished_accepting"] == st["finished"] - cn0["finished"] == len(bodies),
        "out-of-range logit_bias answers 400": bad_bias.get("status") == 400
        and "out of range" in bad_bias.get("body", ""),
        "masked steps ran": bool(steps),
        "masked steps launched the decode kernel": launched >= len(steps) * engine.cfg.n_layers
        and launched > 0,
        "a masked verify ran": engine.cn_spec_drafted > drafted0,
    })
    walls = sorted(w for w, *_ in steps)
    report = {"card": card_line(), "outputs": outs, "bad_bias": bad_bias, "checks": checks,
              "masked_steps": len(steps), "masked_step_rows_mean":
              sum(r for _, r, _ in steps) / max(1, len(steps)),
              "masked_step_wall_ms_median": walls[len(walls) // 2] * 1e3 if walls else None,
              "masked_step_decode_launches": launched,
              "mask_us_per_token": st["mask_us_per_tok"],
              "spec_drafted": engine.cn_spec_drafted - drafted0,
              "spec_accept_rate": st["spec_accept_rate"], "stats": st}
    log(f"constrain: {json.dumps(report)}")
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        check_failed(f"constrain phase: {bad}")
    return report


def masked_step_timing(cfg, params, rows: int = 8, S: int = 1024, ctx: int = 600,
                       iters: int = 20) -> dict:
    """One eager decode step of `rows` compacted rows at `ctx` keys (a
    fresh bf16 cache of random rows, the served weights), unmasked and
    masked (each row a closed schema's cursor's mask and a 2-entry
    logit_bias, as the constrained step runs): median wall (host clock,
    synchronised) and device time (CUDA events) of `iters` calls each, in
    turns, and the host's time to build the mask rows. Both calls write
    the same rows."""
    import numpy as np
    import torch

    from llm_mcp_tpu_torch import constrain
    from llm_mcp_tpu_torch.executor.engine import decode_round
    from llm_mcp_tpu_torch.executor.tokenizer import ByteTokenizer
    from llm_mcp_tpu_torch.models import llama as TL

    dev = _first_leaf(params["layers"]).device  # where the served weights are
    g = torch.Generator(device=dev).manual_seed(11)
    cache = TL.init_kv_cache(cfg, rows, S, dtype=torch.bfloat16, device=dev)
    for t in (cache["k"], cache["v"]):
        t.copy_(torch.randn(t.shape, generator=g, device=dev).to(t.dtype))
    state = (torch.full((rows,), 70, dtype=torch.int32, device=dev),
             torch.zeros(rows, device=dev), torch.zeros(rows, dtype=torch.int32, device=dev),
             torch.ones(rows, device=dev))
    packed = torch.tensor([ctx + i for i in range(rows)] + list(range(rows)) + [0],
                          dtype=torch.int32, device=dev)
    comp = constrain.ConstraintCompiler(ByteTokenizer(), cfg.vocab_size)
    t_m = time.perf_counter()
    cursors = [comp.make({"type": "json_schema", "schema": CN_SCHEMA},
                         logit_bias=[[70, 2.0], [71, -1.0]]) for _ in range(rows)]
    W = constrain.mask_words(cfg.vocab_size)
    masks = np.stack([c.mask_row() for c in cursors])
    bids = np.full((rows, 64), -1, dtype=np.int32)
    bvals = np.zeros((rows, 64), dtype=np.float32)
    for i, c in enumerate(cursors):
        bids[i, :2], bvals[i, :2] = c.bias_ids, c.bias_vals
    host_ms = (time.perf_counter() - t_m) * 1e3
    cn = (torch.from_numpy(masks.view(np.int32)).to(dev), torch.from_numpy(bids).to(dev),
          torch.from_numpy(bvals).to(dev))
    assert masks.shape == (rows, W)

    def step(mask):
        return decode_round(cfg, params, cache["k"], cache["v"], state, packed, steps=1,
                            compact=True, generator=g, cn=mask)

    walls: dict[str, list] = {"unmasked": [], "masked": []}
    device: dict[str, list] = {"unmasked": [], "masked": []}
    with torch.inference_mode():
        for _ in range(3):
            step(None), step(cn)
        torch.cuda.synchronize()
        for _ in range(iters):
            for name, mask in (("unmasked", None), ("masked", cn)):
                e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                t = time.perf_counter()
                e0.record()
                step(mask)
                e1.record()
                torch.cuda.synchronize()
                walls[name].append(time.perf_counter() - t)
                device[name].append(e0.elapsed_time(e1))
    med = {k: sorted(v)[len(v) // 2] for k, v in walls.items()}
    dmed = {k: sorted(v)[len(v) // 2] for k, v in device.items()}
    report = {"card": card_line(), "rows": rows, "ctx": ctx,
              "wall_ms": {k: v * 1e3 for k, v in med.items()}, "device_ms": dmed,
              "host_mask_build_ms_first": host_ms}
    log(f"masked step timing: {json.dumps(report)}")
    del cache
    torch.cuda.empty_cache()
    return report


def q8_served_phase() -> dict:
    """Llama-3.1-8B with int8 weights and the int8 KV cache (`quant=int8
    kv_quant=int8`, Q8_SLOTS slots, full depth, the engine's defaults
    otherwise): the 2-layer model check, then the chats and the prefix
    traffic of the bf16 phases over HTTP, with every counter set to 0 just
    before and read just after. All five int8 entry points and the
    admission prefill must have launched, no bf16-cache kernel, decode must
    have run compacted, the ledger must audit clean and the packed scales
    must equal "s" bit for bit."""
    import torch

    from llm_mcp_tpu_torch.api.inference import serve
    from llm_mcp_tpu_torch.executor import GenerationEngine
    from llm_mcp_tpu_torch.kernels import attention as K

    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    engine = GenerationEngine(
        "llama-3.1-8b", max_slots=Q8_SLOTS, max_seq_len=4096, prefill_chunk=512, seed=0,
        quant="int8", kv_quant="int8", device="cuda",
    )
    leaf = weakref.ref(_first_leaf(engine.params["layers"]))
    torch.cuda.synchronize()
    built = {"s": time.time() - t0, "allocated_gib": torch.cuda.memory_allocated() / 2**30,
             "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
             "compaction": engine.decode_compact}
    log(f"llama-3.1-8b int8 weights + int8 cache: {json.dumps(built)}")
    check = model_check(engine.cfg, engine.params, engine.device, quantized=True)
    engine.start()
    api = serve({engine.cfg.name: engine}, "127.0.0.1", 0)
    base = f"http://127.0.0.1:{api.port}"
    try:
        K.reset_launches()
        rounds0 = engine.compact_rounds
        e2e = e2e_phase(engine, base, kernels=(), reset=False)
        prefix = prefix_phase(engine, base, kernels=(), reset=False)
        launches = dict(K.LAUNCHES)
        compacted = engine.compact_rounds - rounds0
        audit = engine.kv_scale_audit()
    finally:
        api.shutdown()
        engine.shutdown()
    checks = {f"{n} launched": launches[n] > 0
              for n in Q8_KERNELS + ("flash_prefill_attention",)}
    for n in ("append_kv_bf16", "decode_attend_bf16", "decode_attend_bf16_paged",
              "ragged_prefill_attend_bf16", "ragged_prefill_attend_bf16_paged",
              "decode_attention"):
        checks[f"{n} not launched"] = launches[n] == 0
    checks["decode ran compacted"] = compacted > 0
    checks["packed scales == s"] = audit == 0
    checks.update(append_audit(launches))
    report = {"engine": built, "model_check": check, "launches": launches,
              "compacted_rounds": compacted, "kv_scale_audit_mismatches": audit,
              "e2e": e2e, "prefix": prefix, "checks": checks}
    log(f"int8 served: {json.dumps({'launches': launches, 'compacted_rounds': compacted, 'checks': checks})}")
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        check_failed(f"int8 served phase: {bad}")
    report["row_steps"] = row_steps_phase(engine.cfg, engine.params, engine.device)
    report["breakdown"] = breakdown_phase(engine.cfg, engine.params, engine.device,
                                          quantized=True)
    cfg, params = engine.cfg, engine.params
    del engine, api
    gc.collect()
    torch.cuda.empty_cache()
    report["graph_ab"] = graph_ab_phase(cfg, params, "llama-3.1-8b int8", max_slots=Q8_SLOTS,
                                        max_seq_len=4096, prefill_chunk=512, quant="int8",
                                        kv_quant="int8")
    report["spec"] = spec_phase(cfg, params, "llama-3.1-8b int8", quant="int8",
                                kv_quant="int8")
    del params
    report["released"] = _released("llama-3.1-8b int8", mem0, leaf)
    return report


def row_steps_phase(cfg, params, dev, steps: int = 3) -> dict:
    """The int8 model (full depth, the served weights) for `steps` decode
    steps of 8 compacted rows over a fused cache of ROW_S keys, which no
    int8 block divides and JAX's whole-S budget holds: with the counters
    set to 0 just before and read just after, every decode call must take
    the whole-row arm and append from inside it, no standalone append may
    launch, the logits must be finite and the packed scales must equal "s"
    bit for bit after the writes."""
    import torch

    from llm_mcp_tpu_torch.kernels import attention as K
    from llm_mcp_tpu_torch.models import llama as TL
    from llm_mcp_tpu_torch.models.quant import unpack_scales

    g = torch.Generator(device=dev).manual_seed(5)
    L, Hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    cache = TL.init_kv_cache(cfg, Q8_SLOTS, ROW_S, dtype=torch.bfloat16, device=dev,
                             quantized=True)
    ck = cache["k"]
    for li in range(L):
        kv = [torch.randn((Q8_SLOTS, Hkv, ROW_S, hd), generator=g, device=dev)
              .to(torch.bfloat16) for _ in range(2)]
        e = TL.fuse_prompt_kv(*kv)
        ck["q"][li], ck["s"][li] = e["q"], e["s"]
    ids = torch.arange(0, 16, 2, dtype=torch.int32, device=dev)
    lens = torch.tensor([124, 249, 374, 499, 624, 749, 874, ROW_S - steps], dtype=torch.int32,
                        device=dev)
    toks = torch.full((8,), 65, dtype=torch.int32, device=dev)
    before = ck["q"][:, ids.long(), :, lens.long()].clone()
    K.reset_launches()
    t0 = time.perf_counter()
    for step in range(steps):
        logits, ck, _ = TL.llama_decode_step(cfg, params, ck, cache["v"], toks, lens + step,
                                             slot_ids=ids)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps
    launches = {n: K.LAUNCHES[n] for n in ("decode_attend_q8", "decode_attend_q8_row",
                                           "append_kv_q8_fused") + STANDALONE_APPENDS}
    Hs = 2 * Hkv
    checks = {
        "every call took the whole-row arm": launches["decode_attend_q8_row"] == steps * L,
        "every call appended": launches["append_kv_q8_fused"] == steps * L,
        "no standalone append launched": all(launches[n] == 0 for n in STANDALONE_APPENDS),
        "logits finite": bool(torch.isfinite(logits).all()),
        "packed scales == s": torch.equal(unpack_scales(ck["q"][:, :, Hs], Hs, ck["s"].dtype),
                                          ck["s"]),
        "rows written": not torch.equal(before, ck["q"][:, ids.long(), :, lens.long()]),
    }
    report = {"S": ROW_S, "steps": steps, "rows": 8, "launches": launches,
              "wall_ms_per_step": wall * 1e3, "checks": checks}
    log(f"int8 whole-row model steps: {json.dumps(report)}")
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        check_failed(f"decode_attend_q8_row: int8 whole-row model steps: {bad}")
    del cache, ck
    torch.cuda.empty_cache()
    return report


if __name__ == "__main__":
    main()
