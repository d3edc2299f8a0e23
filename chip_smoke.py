#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`llm_mcp_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure exits non-zero and prints no result line (a result
outside its tolerance is reported and the later phases still run, so that
one run reads every check; the script then exits non-zero):

  1. build the CUDA kernels from `llm_mcp_tpu_torch/kernels/csrc/` (one
     nvcc per source, in parallel) and print ptxas's register report;
  2. hold each kernel against its plain PyTorch version at the main
     path's shapes in bf16, element by element (|err| <= 1e-3 + 1e-2*|ref|;
     append bit for bit), and time kernel, plain version, library call
     (where one computes the same function) and the bound with CUDA events;
  3. check the first two Llama-3.1-8B layers (full width, the served
     weights) on a small input: prefill, one decode step and one ragged
     chunk through the kernels on the card against the same model
     functions on the host CPU, where the wrappers take the plain versions;
  4. serve Llama-3.1-8B (full depth and width, random bf16 weights from a
     seed) over HTTP and answer four concurrent chat completions (three
     short prompts, one of about 1500 tokens that goes through ragged chunks;
     three streaming), with every kernel launch counter set to 0 just
     before and read just after: each kernel must have launched;
  5. time one decode step (8 rows) and one 512-token ragged chunk of the
     same model, with device time by kernel from torch.profiler.

The last lines are the card (`nvidia-smi` name, power limit), one JSON
line with the kernels and one with the run's result. Imports nothing of
JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import threading
import time
import urllib.request

HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
# Element by element, |kernel - plain| <= atol + rtol * |plain|. Both sides
# accumulate in f32 and round the output to bf16 once, so they may differ
# by one bf16 step (at most 2^-7 relative); atol covers values near zero.
# Append copies values and must match bit for bit.
ATTN_TOL = {"atol": 1e-3, "rtol": 1e-2}
TOL = {"append_kv_bf16": {"atol": 0.0, "rtol": 0.0}, "decode_attend_bf16": ATTN_TOL,
       "flash_prefill_attention": ATTN_TOL, "ragged_prefill_attend_bf16": ATTN_TOL}
SOURCES = {
    "append_kv_bf16": ("llm_mcp_tpu_torch/kernels/csrc/append_kv.cu",
                       "llm_mcp_tpu/kernels/attention.py:2508"),
    "decode_attend_bf16": ("llm_mcp_tpu_torch/kernels/csrc/decode_attend.cu",
                           "llm_mcp_tpu/kernels/attention.py:1142"),
    "flash_prefill_attention": ("llm_mcp_tpu_torch/kernels/csrc/flash_prefill.cu",
                                "llm_mcp_tpu/kernels/attention.py:178"),
    "ragged_prefill_attend_bf16": ("llm_mcp_tpu_torch/kernels/csrc/ragged_prefill.cu",
                                   "llm_mcp_tpu/kernels/attention.py:2752"),
}
ALSO_REPLACES = {"decode_attend_bf16": ["llm_mcp_tpu/kernels/attention.py:1200"]}
# The model check runs the first CHECK_LAYERS layers in bf16 on the card and
# on the host CPU. GEMMs and attention round and sum in other orders on the
# two, so it compares logits and caches by cosine similarity.
CHECK_LAYERS = 2
MODEL_COSINE = 0.9995

FAILURES: list[str] = []  # checks that failed; reported together at the end


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check_failed(msg: str) -> None:
    """A result outside its tolerance: noted, and the run goes on so that
    every check is read; the script then exits non-zero with no result."""
    print(f"chip_smoke: CHECK FAILED: {msg}", file=sys.stderr, flush=True)
    FAILURES.append(msg)


def log(msg: str) -> None:
    print(f"chip_smoke: {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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

    def compare(name, out, ref) -> tuple[float, float]:
        """Max abs error and the largest |out - ref| / limit over elements."""
        o, r = out.float(), ref.float()
        diff = (o - r).abs()
        limit = TOL[name]["atol"] + TOL[name]["rtol"] * r.abs()
        ratio = torch.where(diff > 0, diff / limit, torch.zeros_like(diff)).max().item()
        err = diff.max().item()
        if not (torch.isfinite(o).all() and math.isfinite(err)) or not (diff <= limit).all():
            n_bad = int((~(diff <= limit)).sum().item())
            check_failed(f"{name}: {n_bad} of {diff.numel()} elements beyond "
                         f"|err| <= {TOL[name]['atol']} + {TOL[name]['rtol']}*|ref| "
                         f"(max_abs_err {err}, worst err/limit {ratio})")
        return err, ratio

    def record(name, out, ref, ms, plain_ms, bytes_, flops, library_ms, shape):
        err, ratio = compare(name, out, ref)
        t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
        res[name] = {
            "max_abs_err": err, "tol": TOL[name], "worst_err_over_limit": ratio,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "shape": shape,
        }
        log(f"{name}: err {err:.3g} (err/limit {ratio:.3g}) ms {ms:.4f} plain {plain_ms:.4f} "
            f"bound {res[name]['bound_ms']:.4f} ({res[name]['bound_by']}) library {library_ms}")

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
        4.0 * hd * G * Hkv * keys, time_ms(lib, 50),
        {"q": [B, Hkv, G, hd], "cache": [L, B, Hkv, S, hd], "lengths": lens.tolist(),
         "slot_ids": ids.tolist()},
    )
    del kpost, vpost

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
        (2 * qp.numel() + 2 * kp.numel()) * 2, 4.0 * hd * H * pairs,
        time_ms(lambda: F.scaled_dot_product_attention(qp, kx, vx, is_causal=True), 20),
        {"q": [Bp, H, Sp, hd], "lengths": lp.tolist()},
    )
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
    record(
        "ragged_prefill_attend_bf16", out, ref,
        time_ms(lambda: K.ragged_prefill_attend_bf16(*args, scale=scale), 10),
        time_ms(lambda: K.ragged_prefill_plain(*args, scale=scale), 5),
        (2 * qr.numel() + 2 * kr.numel() + 2 * sum(starts) * Hkv * hd) * 2,
        4.0 * hd * H * pairs, None,
        {"q": [T, Hkv, G, hd], "rows": R, "tokens": ns, "pads": n_pad, "starts": starts},
    )
    del ck, cv
    torch.cuda.empty_cache()
    return res


def model_check(cfg, params, dev) -> dict:
    """The model's first CHECK_LAYERS layers (published widths, the served
    weights) on a small input: prefill, one decode step with a parked row
    and one ragged chunk with pads, through the kernels on the card and
    through the plain versions on the host CPU, which the wrappers take for
    CPU tensors."""
    import dataclasses

    import torch

    from llm_mcp_tpu_torch.kernels import attention as K
    from llm_mcp_tpu_torch.models import llama as TL

    cut = dataclasses.replace(cfg, n_layers=CHECK_LAYERS)
    host = torch.device("cpu")

    def first_layers(d):
        sub = {k: v.to(d) for k, v in params.items() if k != "layers"}
        sub["layers"] = {k: v[:CHECK_LAYERS].to(d) for k, v in params["layers"].items()}
        return sub

    g = torch.Generator().manual_seed(7)
    P0, S = 40, 256
    toks = torch.randint(3, 259, (1, 64), generator=g, dtype=torch.int32)
    chunk = torch.randint(3, 259, (32,), generator=g, dtype=torch.int32)

    def run(d):
        p = first_layers(d)

        def i32(x):
            return torch.as_tensor(x, dtype=torch.int32, device=d)

        logits_p, ks, vs = TL.llama_prefill(cut, p, toks.to(d), i32([P0]))
        cache = TL.init_kv_cache(cut, 2, S, dtype=p["embed"].dtype, device=d)
        cache["k"][:, 0, :, :64] = ks[:, 0]
        cache["v"][:, 0, :, :64] = vs[:, 0]
        ck, cv = cache["k"].clone(), cache["v"].clone()
        # a fixed token, not the argmax: near-ties among 128k random logits
        # may round to another winner on the two sides
        logits_d, ck, cv = TL.llama_decode_step(
            cut, p, ck, cv, i32([65, 65]), i32([P0, S]))  # row 1 parked
        logits_r, rk, _ = TL.llama_prefill_chunk_ragged(
            cut, p, cache["k"], cache["v"], tokens=chunk.to(d),
            rowids=i32([0] * 20 + [1] * 12), positions=i32(list(range(P0, P0 + 20)) + [S] * 12),
            slots=i32([0]), starts=i32([P0]), last_idx=i32([19]))
        return logits_p, logits_d[:1], logits_r, ck, rk

    K.reset_launches()
    got = run(dev)
    torch.cuda.synchronize()
    per_call = dict(K.LAUNCHES)
    t0 = time.perf_counter()
    want = run(host)
    report = {"layers": CHECK_LAYERS, "launches_in_check": per_call,
              "host_reference_s": time.perf_counter() - t0}
    bad = []
    for name, a, b in zip(("prefill", "decode", "ragged", "decode_cache", "ragged_cache"), got, want):
        a, b = a.float().cpu(), b.float()
        cos = torch.nn.functional.cosine_similarity(a.flatten(), b.flatten(), dim=0).item()
        err = (a - b).abs().max().item()
        report[name] = {"cosine": cos, "max_abs_err": err}
        if not torch.isfinite(a).all() or not cos >= MODEL_COSINE:
            bad.append(name)
    log(f"model check: {json.dumps(report)}")
    for name, n in per_call.items():
        if n <= 0:
            check_failed(f"model check: kernel {name} was not launched")
    if bad:
        check_failed(f"model check: {bad} through the kernels disagree with the plain "
                     f"versions on the host (finite values with cosine >= {MODEL_COSINE} wanted)")
    return report


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


def e2e_phase(engine) -> dict:
    from llm_mcp_tpu_torch.api.inference import serve
    from llm_mcp_tpu_torch.kernels import attention as K

    model = engine.cfg.name
    api = serve({model: engine}, "127.0.0.1", 0)
    base = f"http://127.0.0.1:{api.port}"
    try:
        warm: dict = {}
        chat(base, model, "warm up", True, warm, max_tokens=4, temperature=0)
        if "error" in warm:
            fail(f"warm-up request failed: {warm['error']}")
        long_prompt = " ".join(f"item {i} is the {i % 7}th of its kind." for i in range(46))
        reqs = [
            ("short-1", "What is the capital of France?", True, {"temperature": 0}),
            ("short-2", "Write a haiku about GPUs.", True, {"temperature": 0.7, "top_p": 0.9}),
            ("short-3", "List three prime numbers.", False, {"temperature": 0}),
            ("long", "Summarize this list: " + long_prompt, True, {"temperature": 0}),
        ]
        results = {name: {} for name, *_ in reqs}
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
    finally:
        api.shutdown()
    for name, r in results.items():
        if "error" in r or not r.get("finish"):
            fail(f"request {name} did not finish: {r}")
        if r.get("done") is False:
            fail(f"request {name}: SSE stream did not end in data: [DONE]")
        if r["usage"].get("completion_tokens", 0) < 1:
            fail(f"request {name}: no tokens")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")
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
    }
    log(f"e2e: {json.dumps(e2e)}")
    return e2e


def breakdown_phase(cfg, params, dev) -> dict:
    """Where a decode step and a ragged chunk spend their time, at served
    shapes (8 rows at fill 1024; one 512-token chunk over a 1024-token
    prefix): wall per call from CUDA events, device time by kernel from
    torch.profiler, and the device's idle share (1 - busy / wall)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from llm_mcp_tpu_torch.models import llama as TL

    B, S, P, T = 8, 4096, 1024, 512
    cache = TL.init_kv_cache(cfg, B, S, dtype=torch.bfloat16, device=dev)
    ck, cv = cache["k"], cache["v"]

    def i32(x):
        return torch.as_tensor(x, dtype=torch.int32, device=dev)

    toks, lens = i32([65] * B), i32([P] * B)
    ragged = dict(tokens=i32([66] * T), rowids=i32([0] * T), positions=i32(range(P, P + T)),
                  slots=i32([0]), starts=i32([P]), last_idx=i32([T - 1]))
    calls = {
        "decode_step_b8": lambda: TL.llama_decode_step(cfg, params, ck, cv, toks, lens),
        "ragged_chunk_512": lambda: TL.llama_prefill_chunk_ragged(cfg, params, ck, cv, **ragged),
    }
    out = {}
    for name, fn in calls.items():
        ms = time_ms(fn, 5)
        n = 3
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
        out[name] = {
            "ms": ms,
            "device_busy_ms": busy if kern else "not measured",
            "idle_share": 1.0 - busy / ms if kern else "not measured",
            "top_kernels_ms": [[k[:80], t] for t, k in kern[:10]],
        }
    log(f"breakdown: {json.dumps(out)}")
    del ck, cv, cache
    torch.cuda.empty_cache()
    return out


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

    t0 = time.time()
    reports = build.build(verbose=True)
    log(f"built {len(reports)} kernel libraries in {time.time() - t0:.1f} s")
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    kernels = kernel_phase()

    from llm_mcp_tpu_torch.executor import GenerationEngine

    t0 = time.time()
    engine = GenerationEngine(
        "llama-3.1-8b", max_slots=8, max_seq_len=4096, prefill_chunk=512, seed=0,
        device="cuda",
    )
    torch.cuda.synchronize()
    log(f"llama-3.1-8b random bf16 weights + cache in {time.time() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    check = model_check(engine.cfg, engine.params, engine.device)
    engine.start()
    try:
        e2e = e2e_phase(engine)
    finally:
        engine.shutdown()
    breakdown = breakdown_phase(engine.cfg, engine.params, engine.device)
    if FAILURES:
        fail(f"{len(FAILURES)} check(s) failed: {FAILURES}")

    rows = []
    for name, r in kernels.items():
        src, replaces = SOURCES[name]
        row = {"name": name, "route": "cuda", "source": src, "replaces": replaces}
        if name in ALSO_REPLACES:
            row["also_replaces"] = ALSO_REPLACES[name]
        row["launches"] = e2e["launches"][name]
        row.update(r)
        rows.append(row)
    print(json.dumps({"e2e": e2e, "model_check": check, "breakdown": breakdown,
                      "seconds": time.time() - t_start}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
