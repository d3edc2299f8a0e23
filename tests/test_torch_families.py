"""Parity of the port's decoder families with the JAX package's.

`tiny-qwen` (q/k/v biases), `tiny-qwen3` (per-head q/k norms, head_dim 64
apart from dim // n_heads), `tiny-mistral` (a 64-token window on every
layer), `tiny-gemma` ((1 + w) norms, post-norms, gelu, sqrt(dim) embedding
scale, score and logit softcaps, alternating windows, a score scale of
24**-0.5) and `tiny-moe` (Mixtral's top-2 routing). One JAX tree (f32, its
norms and biases moved off their initial values so that they matter) goes
through `params_from_numpy` to the port. Tolerances, in f32: logits within
1e-4 absolute, caches within 1e-5. The JAX side runs its Pallas path in
interpret mode where it has one; its windowed and softcapped families take
XLA for decode and bucketed chunks, as the port takes plain torch and
bucketed chunks. Also the JAX family file's checks: windows limit the
context, Gemma's alternation, the logit softcap bounds the logits, and the
biases and q/k norms move the logits.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_mcp_tpu.models import llama as JL
from llm_mcp_tpu.models.configs import get_config as jax_get_config
from llm_mcp_tpu_torch.executor import GenerationEngine, GenRequest
from llm_mcp_tpu_torch.models import llama as TL
from llm_mcp_tpu_torch.models.configs import get_config
from llm_mcp_tpu_torch.models.weights import params_from_numpy

FAMILIES = ["tiny-qwen", "tiny-qwen3", "tiny-mistral", "tiny-gemma", "tiny-moe"]
WINDOWED = ["tiny-mistral", "tiny-gemma"]
LOGIT_TOL = dict(atol=1e-4, rtol=0)
CACHE_TOL = dict(atol=1e-5, rtol=0)


def family_tree(name: str, seed: int = 0) -> dict:
    """A JAX f32 tree as numpy, norms and biases moved off 1 and 0."""
    jp = JL.init_llama_params(jax_get_config(name), jax.random.PRNGKey(seed), dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(seed + 1)
    for k, v in tree["layers"].items():
        if k.startswith("b") or "norm" in k:
            tree["layers"][k] = v + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
    return tree


@pytest.fixture(scope="module", params=FAMILIES)
def fam(request):
    name = request.param
    tree = family_tree(name)
    return (name, jax_get_config(name), jax.tree.map(jnp.asarray, tree), get_config(name),
            params_from_numpy(tree, get_config(name), "cpu", torch.float32))


def _caches(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, B, cfg.n_kv_heads, S, cfg.resolved_head_dim)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def test_prefill_matches_jax(fam):
    name, jcfg, jp, cfg, tp = fam
    rng = np.random.default_rng(0)
    B, S = 2, 128
    tokens = rng.integers(3, cfg.vocab_size, (B, S)).astype(np.int32)
    lengths = np.asarray([128, 77], np.int32)
    jl, jk, jv = JL.llama_prefill(jcfg, jp, jnp.asarray(tokens), jnp.asarray(lengths),
                                  attn_impl="pallas")
    tl, tk, tv = TL.llama_prefill(cfg, tp, torch.from_numpy(tokens), torch.from_numpy(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **CACHE_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **CACHE_TOL)


def test_chunk_batch_matches_jax(fam):
    """A chunk batch over past rows: rows whose windows cut into the past
    (start 100 > 64) and one at start 0, with a pad row at slot B."""
    name, jcfg, jp, cfg, tp = fam
    B, S, C = 3, 192, 32
    ck, cv = _caches(cfg, B, S, 1)
    rng = np.random.default_rng(2)
    tokens = rng.integers(3, cfg.vocab_size, (2, C)).astype(np.int32)
    slots, starts, nvalid = [2, 0], [100, 0], [32, 19]
    jl, jk, jv = JL.llama_prefill_chunk_batch(
        jcfg, jp, jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(tokens),
        jnp.asarray(slots, jnp.int32), jnp.asarray(starts, jnp.int32),
        jnp.asarray(nvalid, jnp.int32))
    # the port's pad row (slot B) reads slot B - 1 and writes nothing
    ttok = np.concatenate([tokens, tokens[:1]])
    tk_, tv_ = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    tl, tk, tv = TL.llama_prefill_chunk_batch(
        cfg, tp, tk_, tv_, torch.from_numpy(ttok), torch.tensor(slots + [B], dtype=torch.int32),
        torch.tensor(starts + [0], dtype=torch.int32), torch.tensor(nvalid + [1], dtype=torch.int32))
    np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **CACHE_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **CACHE_TOL)


def _paged(cfg, ck, cv, bt=32):
    """Tables whose block 1 of slot 0 lives in pool row 0 (a copy of it) and
    block 2 of slot 1 in slot 2's arena home (block 3), a copy too."""
    L, B, Hkv, S, hd = ck.shape
    nbs = S // bt
    tbl = (np.arange(B)[:, None] * nbs + np.arange(nbs)[None, :]).astype(np.int32)
    pk = np.zeros((L, 2, Hkv, bt, hd), np.float32)
    pv = np.zeros_like(pk)
    pk[:, 0], pv[:, 0] = ck[:, 0, :, bt: 2 * bt], cv[:, 0, :, bt: 2 * bt]
    tbl[0, 1] = B * nbs
    ck[:, 2, :, 3 * bt: 4 * bt], cv[:, 2, :, 3 * bt: 4 * bt] = (
        ck[:, 1, :, 2 * bt: 3 * bt], cv[:, 1, :, 2 * bt: 3 * bt])
    tbl[1, 2] = 2 * nbs + 3
    return tbl, pk, pv


@pytest.mark.parametrize("paged", [False, True])
def test_decode_steps_match_jax(fam, paged):
    """Three decode steps of three rows (one parked at S), the caches
    carried, against JAX's step (the windowed families' XLA branch; the
    others' Pallas decode in interpret mode), contiguous and through
    block tables."""
    name, jcfg, jp, cfg, tp = fam
    B, S = 3, 192
    ck, cv = _caches(cfg, B, S, 3)
    jop = top = None
    if paged:
        tbl, pk, pv = _paged(cfg, ck, cv)
        jop = {"tbl": jnp.asarray(tbl), "k": jnp.asarray(pk), "v": jnp.asarray(pv)}
        top = {"tbl": torch.from_numpy(tbl), "k": torch.from_numpy(pk),
               "v": torch.from_numpy(pv)}
    jk, jv = jnp.asarray(ck), jnp.asarray(cv)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    lens = np.asarray([150, 40, S], np.int32)
    toks = np.asarray([5, 9, 11], np.int32)
    for step in range(3):
        jl, jk, jv = JL.llama_decode_step(jcfg, jp, jk, jv, jnp.asarray(toks), jnp.asarray(lens),
                                          attn_impl="pallas", paged=jop)
        tl, tk, tv = TL.llama_decode_step(cfg, tp, tk, tv, torch.from_numpy(toks),
                                          torch.from_numpy(lens), paged=top)
        np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2], **LOGIT_TOL)
        toks = np.asarray(jl).argmax(-1).astype(np.int32)
        lens = np.where(lens < S, lens + 1, lens).astype(np.int32)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **CACHE_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **CACHE_TOL)


@pytest.mark.parametrize("name", WINDOWED)
def test_decode_step_int8_cache_matches_jax(name):
    """The windowed families' plain decode over the fused int8 cache,
    compacted (slot_ids), against JAX's XLA branch: logits, and the
    written rows' payload within 1 and scales within 1e-6 relative."""
    tree = family_tree(name)
    jcfg, cfg = jax_get_config(name), get_config(name)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_numpy(tree, cfg, "cpu", torch.float32)
    B, S = 4, 128
    ck, cv = _caches(cfg, B, S, 4)
    jc = JL.init_kv_cache(jcfg, B, S, dtype=jnp.float32, quantized=True)
    fused = JL.fuse_prompt_kv(jnp.asarray(ck), jnp.asarray(cv))
    jk = {"q": fused["q"], "s": fused["s"]}
    tk = {"q": torch.from_numpy(np.asarray(fused["q"]).copy()),
          "s": torch.from_numpy(np.asarray(fused["s"]).copy())}
    assert jk["q"].shape == jc["k"]["q"].shape
    slot_ids = np.asarray([3, 1], np.int32)
    lens = np.asarray([100, 70], np.int32)
    toks = np.asarray([5, 9], np.int32)
    jl, jk2, _ = JL.llama_decode_step(jcfg, jp, jk, {}, jnp.asarray(toks), jnp.asarray(lens),
                                      attn_impl="pallas", slot_ids=jnp.asarray(slot_ids))
    tl, tk2, _ = TL.llama_decode_step(cfg, tp, tk, {}, torch.from_numpy(toks),
                                      torch.from_numpy(lens), torch.from_numpy(slot_ids))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-3, rtol=0)
    # the K|V heads; the packed pseudo-head holds the scales' bits
    H2 = 2 * cfg.n_kv_heads
    jq = np.asarray(jk2["q"])[:, :, :H2].astype(np.int32)
    tq = tk2["q"][:, :, :H2].numpy().astype(np.int32)
    assert np.abs(jq - tq).max() <= 1
    np.testing.assert_allclose(tk2["s"].numpy(), np.asarray(jk2["s"]), rtol=1e-6, atol=0)
    from llm_mcp_tpu_torch.models.quant import unpack_scales

    assert torch.equal(unpack_scales(tk2["q"][:, :, H2], H2, torch.float32),
                       tk2["s"])


PROMPTS = [
    "user: hello there",
    "user: " + "the quick brown fox jumps over the lazy dog " * 3,  # past the window
    "system: be brief\nuser: 2+2?",
]
ENGINE_KW = dict(max_slots=4, max_seq_len=256, prefill_chunk=32, decode_chunk=4,
                 prompt_cache_mb=0)


def _run_all(engine, make_req, prompts=PROMPTS, max_tokens=12) -> list[list[int]]:
    seen: dict = {}
    orig = engine._process_token

    def rec(s, tok, pos):
        seen.setdefault(s.req.request_id, []).append(int(tok))
        return orig(s, tok, pos)

    engine._process_token = rec
    reqs = [make_req(engine.tokenizer.encode(p), max_tokens) for p in prompts]
    for r in reqs:
        engine.submit(r)
    for r in reqs:
        while True:
            evt = r.out.get(timeout=300)
            if not isinstance(evt, dict) or evt.get("type") in ("done", "error"):
                assert not isinstance(evt, dict) or evt["type"] == "done", evt
                break
    return [seen[r.request_id] for r in reqs]


def engine_pair(monkeypatch, name, tree, jax_kw=None, port_kw=None, prompts=PROMPTS,
                max_tokens=12):
    """Greedy tokens of the JAX engine and the port's on one tree, whether
    each staged ragged chunks, and the port's prefix-cache hits."""
    monkeypatch.setenv("LLM_MCP_TPU_ATTN", "pallas")
    monkeypatch.setenv("LLM_MCP_TPU_RAGGED_IMPL", "kernel")
    from llm_mcp_tpu.executor.engine import GenerationEngine as JaxEngine
    from llm_mcp_tpu.executor.engine import GenRequest as JaxRequest

    kw = dict(ENGINE_KW, **(jax_kw or {}))
    jeng = JaxEngine(name, params=jax.tree.map(jnp.asarray, tree), dtype=jnp.float32,
                     **kw).start()
    try:
        want = _run_all(jeng, lambda ids, n: JaxRequest(prompt_ids=ids, max_tokens=n,
                                                        temperature=0.0), prompts, max_tokens)
        jax_ragged = jeng.ragged_prefill
    finally:
        jeng.shutdown()
    teng = GenerationEngine(name, params=params_from_numpy(tree, get_config(name), "cpu",
                                                           torch.float32),
                            dtype=torch.float32, device="cpu", **dict(kw, **(port_kw or {})))
    teng.start()
    try:
        got = _run_all(teng, lambda ids, n: GenRequest(prompt_ids=ids, max_tokens=n,
                                                       temperature=0.0), prompts, max_tokens)
        ragged = teng.ragged_prefill
        hits = teng.prefix_cache_stats().get("hits", 0)
    finally:
        teng.shutdown()
    return want, got, jax_ragged, ragged, hits


@pytest.mark.parametrize("name", FAMILIES)
def test_engine_greedy_tokens_match_jax(monkeypatch, name):
    """Concurrent chats, one prompt past prefill_chunk and the window: the
    windowed and softcapped families chunk bucketed on both sides."""
    want, got, jax_ragged, ragged, _ = engine_pair(monkeypatch, name, family_tree(name))
    assert ragged == (name not in WINDOWED)
    if name in WINDOWED:
        assert not jax_ragged
    assert all(t for t in got)  # a stream may end early on the byte tokenizer's eos
    assert got == want


@pytest.mark.parametrize("name", WINDOWED)
def test_engine_int8_greedy_tokens_match_jax(monkeypatch, name):
    """The windowed families at int8 weights and the int8 KV cache: bucketed
    chunks and the plain decode step over the fused cache, compacted."""
    monkeypatch.setenv("TPU_SPEC", "0")
    q8 = dict(quant="int8", kv_quant="int8", max_slots=16)
    tree = family_tree(name)
    want, got, _, _, _ = engine_pair(monkeypatch, name, tree, q8)
    assert got == want


def test_engine_prefix_hit_windowed_matches_jax(monkeypatch):
    """Prefix traffic on tiny-mistral through physical paging: the hits'
    suffixes chunk bucketed over pool blocks, decode reads them through
    the tables."""
    monkeypatch.setenv("TPU_KV_BLOCK_TOKENS", "32")
    sys_msg = "system: You are a careful assistant. Answer in one short line, please.\nuser: "
    prompts = [sys_msg + q for q in ("what is 2+2?", "name a color", "spell cat")]
    tree = family_tree("tiny-mistral")
    jax_kw = dict(prompt_cache_mb=1, max_slots=2)
    want, got, _, _, hits = engine_pair(monkeypatch, "tiny-mistral", tree, jax_kw,
                                        prompts=prompts, max_tokens=8)
    assert hits >= 1
    assert got == want


def test_sliding_window_limits_context():
    """The JAX file's check on the port: two layers of window 64 reach 126
    positions back, so position 0 cannot move the last logits of a
    128-token prompt, and position 100 does."""
    cfg = get_config("tiny-mistral")
    tp = params_from_numpy(family_tree("tiny-mistral"), cfg, "cpu", torch.float32)
    rng = np.random.default_rng(3)
    prompt = torch.from_numpy(rng.integers(3, cfg.vocab_size, (1, 128)).astype(np.int32))
    lengths = torch.tensor([128], dtype=torch.int32)
    base = TL.llama_prefill(cfg, tp, prompt, lengths)[0]
    far, near = prompt.clone(), prompt.clone()
    far[0, 0] = (far[0, 0] + 1) % cfg.vocab_size
    near[0, 100] = (near[0, 100] + 1) % cfg.vocab_size
    torch.testing.assert_close(TL.llama_prefill(cfg, tp, far, lengths)[0], base,
                               atol=1e-5, rtol=1e-5)
    assert (TL.llama_prefill(cfg, tp, near, lengths)[0] - base).abs().max() > 1e-4


def test_layer_windows_alternate_as_jax():
    for name in ("tiny-gemma", "tiny-mistral", "tiny-llm", "gemma2-9b", "mistral-7b"):
        assert TL.layer_windows(get_config(name)) == np.asarray(
            JL.layer_windows(jax_get_config(name))).tolist()
    assert TL.layer_windows(get_config("tiny-gemma")) == [64, 0]


def test_gemma_logit_softcap_bounds_logits():
    cfg = get_config("tiny-gemma")
    tree = family_tree("tiny-gemma")
    tree["embed"] = tree["embed"] * 50.0
    tp = params_from_numpy(tree, cfg, "cpu", torch.float32)
    logits = TL.llama_prefill(cfg, tp, torch.full((1, 8), 5, dtype=torch.int32),
                              torch.tensor([8], dtype=torch.int32))[0]
    assert logits.abs().max() <= cfg.logit_softcap + 1e-3


@pytest.mark.parametrize("name,key,bump", [("tiny-qwen", "bq", 1.0),
                                           ("tiny-qwen3", "k_norm", 2.0)])
def test_bias_and_qk_norm_matter(name, key, bump):
    """qkv biases (Qwen2) and q/k norms (Qwen3) exist and move the logits."""
    cfg = get_config(name)
    tree = family_tree(name)
    assert key in tree["layers"]
    prompt = torch.tensor([[7, 9, 11]], dtype=torch.int32)
    lens = torch.tensor([3], dtype=torch.int32)
    base = TL.llama_prefill(cfg, params_from_numpy(tree, cfg, "cpu", torch.float32), prompt,
                            lens)[0]
    tree["layers"][key] = tree["layers"][key] * (1 + bump) + bump
    out = TL.llama_prefill(cfg, params_from_numpy(tree, cfg, "cpu", torch.float32), prompt,
                           lens)[0]
    assert (out - base).abs().max() > 1e-4


def test_catalog_matches_jax():
    """Every entry of JAX's catalog, the embedders among them, field for
    field on the fields the port keeps, and the same aliases resolve to the
    same entries."""
    from dataclasses import fields

    from llm_mcp_tpu.models.configs import MODEL_CONFIGS as JAX_CONFIGS
    from llm_mcp_tpu_torch.models.configs import MODEL_CONFIGS

    entries = list(JAX_CONFIGS)
    assert set(entries) <= set(MODEL_CONFIGS)
    for n in entries:
        for f in fields(MODEL_CONFIGS[n]):
            assert getattr(MODEL_CONFIGS[n], f.name) == getattr(JAX_CONFIGS[n], f.name), (n, f)
        assert MODEL_CONFIGS[n].attn_scale == JAX_CONFIGS[n].attn_scale
    for alias in ("llama3.1:8b", "meta-llama/Llama-3.1-8B-Instruct", "deepseek-r1:1.5b",
                  "deepseek-r1:7b", "deepseek-r1:8b", "Qwen/Qwen2.5-7B-Instruct",
                  "mistralai/Mistral-7B-v0.1", "google/gemma-2-9b-it", "mixtral:8x7b",
                  "qwen2.5:0.5b", "DeepSeek-V2-Lite-Chat", "nomic-embed-text:v1.5",
                  "Qwen/Qwen3-Embedding-8B", "mxbai-embed-large"):
        assert get_config(alias).name == jax_get_config(alias).name, alias


def test_cuda_refuses_shapes_without_a_kernel_arm():
    """On the card the engine refuses head_dim 32 (the tiny-* test
    configs), naming ROADMAP queue 2; the served families, head_dim 64
    among them, pass."""
    from llm_mcp_tpu_torch.executor.engine import _check_kernel_shapes

    for name in ("tiny-llm",):
        with pytest.raises(ValueError, match="ROADMAP queue 2"):
            _check_kernel_shapes(get_config(name))
    for name in ("llama-3.1-8b", "qwen2.5-7b", "qwen3-8b", "deepseek-r1-distill-qwen-1.5b",
                 "deepseek-r1-distill-llama-8b", "mistral-7b", "gemma2-9b", "mixtral-8x7b",
                 "deepseek-v2-lite", "qwen2.5-0.5b", "llama-3.2-1b", "tiny-qwen3"):
        _check_kernel_shapes(get_config(name))
