"""The port's embedding path against the JAX package's, on the CPU.

Each test feeds the same numpy-seeded inputs and one parameter tree
(converted by `params_from_numpy`) through the JAX function and the
port's counterpart:

  - `embed_forward` for the three encoder variants (`tiny-embed`: rope,
    RMSNorm, pre-norm; a nomic-style post-LN gated config; a classic BERT
    config: learned positions, biases, erf GELU, type embeddings), mean and
    cls pooling, f32 (max |diff| <= 1e-4 on the unit vectors) and bf16
    (cosine >= 0.999 per vector); the sliced attention equal, bit for bit,
    to one slice;
  - `llama_encode` against JAX's (`attn_impl="xla"`) on a Qwen3-style
    config with q/k norms, a row of length 1 among them;
  - `quantize_params` on an encoder tree bit for bit, the int8 vectors
    within cosine 0.999 of JAX's and of the float ones;
  - `EmbeddingEngine.embed` against JAX's engine (the byte tokenizer and
    the real-vocabulary fixture; `dimensions`, more inputs than
    `max_batch`, equal token counts);
  - encoder checkpoints written by JAX's `encoder_to_hf_tensors` in BERT
    and nomic naming, loaded by the port bit for bit; a Qwen3 decoder
    checkpoint served by both engines;
  - configs: the catalog's embedders, `config_from_hf` on BERT and nomic
    documents (and its refusals), the `1_Pooling` choice;
  - `/v1/embeddings` through the port's `serve`: the reference's 400s and
    503s, the default model, the body, `/v1/models`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_mcp_tpu.executor import EmbeddingEngine as JaxEmbeddingEngine
from llm_mcp_tpu.executor.tokenizer import load_tokenizer as jax_load_tokenizer
from llm_mcp_tpu.models import embedder as JE
from llm_mcp_tpu.models import llama as JL
from llm_mcp_tpu.models import quant as JQ
from llm_mcp_tpu.models import weights as JW
from llm_mcp_tpu.models.configs import config_from_hf as jax_config_from_hf
from llm_mcp_tpu.models.configs import config_from_hf_dir as jax_config_from_hf_dir
from llm_mcp_tpu.models.configs import get_config as jax_get_config
from llm_mcp_tpu_torch.api.inference import serve
from llm_mcp_tpu_torch.executor import EmbeddingEngine
from llm_mcp_tpu_torch.executor.tokenizer import load_tokenizer
from llm_mcp_tpu_torch.models import embedder as TE
from llm_mcp_tpu_torch.models import llama as TL
from llm_mcp_tpu_torch.models import quant as TQ
from llm_mcp_tpu_torch.models import weights as TW
from llm_mcp_tpu_torch.models.configs import config_from_hf, config_from_hf_dir, get_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "tiny_real_vocab")

BERT_DOC = {
    "model_type": "bert", "vocab_size": 384, "hidden_size": 64, "num_hidden_layers": 2,
    "num_attention_heads": 4, "intermediate_size": 128, "layer_norm_eps": 1e-12,
    "max_position_embeddings": 96, "hidden_act": "gelu", "type_vocab_size": 2,
}
NOMIC_DOC = {
    "model_type": "nomic_bert", "vocab_size": 384, "n_embd": 64, "n_layer": 2, "n_head": 4,
    "n_inner": 128, "rotary_emb_fraction": 1.0, "rotary_emb_base": 10000,
    "layer_norm_epsilon": 1e-12, "n_positions": 256, "activation_function": "swiglu",
    "qkv_proj_bias": False, "prenorm": False, "type_vocab_size": 2,
}
VARIANTS = ("tiny-embed", "nomic", "bert")
F32_TOL = 1e-4
BF16_COSINE = 0.999


def _cfgs(variant: str):
    """(JAX config, port config) of an encoder variant."""
    if variant == "tiny-embed":
        return jax_get_config(variant), get_config(variant)
    doc = NOMIC_DOC if variant == "nomic" else BERT_DOC
    return jax_config_from_hf(doc, name=variant), config_from_hf(doc, name=variant)


def _tree(jcfg, seed: int = 0) -> dict:
    """A JAX encoder tree as numpy, f32, with every norm and bias moved off
    its init value so that each one matters."""
    p = JE.init_embedder_params(jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    rs = np.random.RandomState(seed + 1)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rs.standard_normal(np.shape(a)).astype(np.float32), p)


def _batch(vocab: int, seed: int = 0):
    """Right-padded tokens [4, 40] and lengths with a full row, two partial
    rows and a row of length 1."""
    rs = np.random.RandomState(seed)
    toks = rs.randint(3, vocab, (4, 40)).astype(np.int32)
    return toks, np.array([40, 17, 1, 29], np.int32)


def _cosines(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("pooling", ["mean", "cls"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_embed_forward_matches_jax(variant, pooling, dtype):
    jcfg, tcfg = _cfgs(variant)
    jcfg, tcfg = (dataclasses.replace(c, pooling=pooling) for c in (jcfg, tcfg))
    tree = _tree(jcfg)
    toks, lens = _batch(jcfg.vocab_size)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    want = np.asarray(JE.embed_forward(
        jcfg, jax.tree.map(lambda a: jnp.asarray(a, jdt), tree), jnp.asarray(toks),
        jnp.asarray(lens)))
    got = TE.embed_forward(tcfg, TW.params_from_numpy(tree, tcfg, "cpu", tdt),
                           torch.from_numpy(toks), torch.from_numpy(lens))
    assert got.dtype == torch.float32 and got.shape == (4, tcfg.dim)
    got = got.numpy()
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-5)
    if dtype == "f32":
        assert np.abs(got - want).max() <= F32_TOL
    else:
        assert _cosines(got, want).min() >= BF16_COSINE


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sliced_attention_is_bitwise(monkeypatch, dtype):
    """Slices of (row, head) pairs give what one slice gives, bit for bit:
    the attention alone at every slice size, and a whole nomic forward with
    the budget at one pair."""
    g = torch.Generator().manual_seed(3)
    B, S, H, hd = 3, 24, 4, 16
    q, k, v = (torch.randn(B, S, H, hd, generator=g).to(dtype) for _ in range(3))
    valid = torch.arange(S)[None, :] < torch.tensor([24, 9, 1])[:, None]
    monkeypatch.setattr(TE, "SCORE_BUDGET_BYTES", 1 << 40)
    whole = TE.encoder_attention(q, k, v, valid)
    for pairs in (1, 2, 5, B * H - 1):
        monkeypatch.setattr(TE, "SCORE_BUDGET_BYTES", pairs * S * S * 4)
        assert torch.equal(TE.encoder_attention(q, k, v, valid), whole), pairs
    monkeypatch.setattr(TE, "SCORE_BUDGET_BYTES", 1 << 40)
    jcfg, tcfg = _cfgs("nomic")
    params = TW.params_from_numpy(_tree(jcfg), tcfg, "cpu", dtype)
    toks, lens = (torch.from_numpy(a) for a in _batch(tcfg.vocab_size))
    once = TE.embed_forward(tcfg, params, toks, lens)
    monkeypatch.setattr(TE, "SCORE_BUDGET_BYTES", 40 * 40 * 4)
    assert torch.equal(TE.embed_forward(tcfg, params, toks, lens), once)


def test_llama_encode_matches_jax():
    """A Qwen3-style decoder (q/k norms, head_dim 64 over dim 128) as an
    encoder: the last-token vectors of JAX's XLA path, with a row of
    length 1; junk past a row's length changes nothing."""
    jcfg, tcfg = jax_get_config("tiny-qwen3"), get_config("tiny-qwen3")
    p = JL.init_llama_params(jcfg, jax.random.PRNGKey(2), dtype=jnp.float32)
    rs = np.random.RandomState(5)
    tree = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rs.standard_normal(np.shape(a)).astype(np.float32), p)
    toks, lens = _batch(jcfg.vocab_size, seed=4)
    want = np.asarray(JL.llama_encode(jcfg, jax.tree.map(jnp.asarray, tree), jnp.asarray(toks),
                                      jnp.asarray(lens), attn_impl="xla"))
    params = TW.params_from_numpy(tree, tcfg, "cpu", torch.float32)
    got = TL.llama_encode(tcfg, params, torch.from_numpy(toks), torch.from_numpy(lens))
    assert got.shape == (4, tcfg.dim) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= F32_TOL
    junk = toks.copy()
    junk[1, 17:] = 7
    again = TL.llama_encode(tcfg, params, torch.from_numpy(junk), torch.from_numpy(lens))
    assert torch.equal(again[1], got[1])


@pytest.mark.parametrize("variant", VARIANTS)
def test_quantize_encoder_tree_matches_jax(variant):
    """`quantize_params` on an encoder tree: the linears and the per-row
    embedding quantized bit for bit as JAX quantizes them, norms, biases
    and the position and type tables untouched; the int8 vectors within
    cosine 0.999 of JAX's int8 vectors and of the float ones. JAX's direct
    int8 init has the keys and shapes the port's has."""
    jcfg, tcfg = _cfgs(variant)
    tree = _tree(jcfg)
    jq = jax.tree.map(np.asarray, JQ.quantize_params(jax.tree.map(jnp.asarray, tree)))
    tq = TQ.quantize_params(TW.params_from_numpy(tree, tcfg, "cpu", torch.float32))
    want_leaves = jax.tree_util.tree_flatten_with_path(jq)[0]
    assert len(want_leaves) == sum(1 for _ in _leaves(tq))
    for path, want in want_leaves:
        got = _get(tq, [getattr(k, "key", None) for k in path])
        assert got.dtype == (torch.int8 if want.dtype == np.int8 else torch.float32), path
        assert np.array_equal(got.numpy(), want), path
    for k in ("attn_norm", "ffn_norm"):
        assert not TQ.is_quantized(tq["layers"][k])
    toks, lens = _batch(jcfg.vocab_size)
    want_q8 = np.asarray(JE.embed_forward(jcfg, jax.tree.map(jnp.asarray, jq), jnp.asarray(toks),
                                          jnp.asarray(lens)))
    got_q8 = TE.embed_forward(tcfg, tq, torch.from_numpy(toks), torch.from_numpy(lens)).numpy()
    flt = TE.embed_forward(tcfg, TW.params_from_numpy(tree, tcfg, "cpu", torch.float32),
                           torch.from_numpy(toks), torch.from_numpy(lens)).numpy()
    assert _cosines(got_q8, want_q8).min() >= BF16_COSINE
    assert _cosines(got_q8, flt).min() >= BF16_COSINE
    direct = JE.init_embedder_params_quantized(jcfg, jax.random.PRNGKey(0),
                                               scale_dtype=jnp.float32)
    mine = TE.init_embedder_params_quantized(tcfg, torch.Generator().manual_seed(0),
                                             torch.float32)
    TW.params_from_numpy(jax.tree.map(np.asarray, direct), tcfg, "cpu", torch.float32)
    assert sorted(_paths(mine)) == sorted(
        "/".join(str(getattr(k, "key", k)) for k in p)
        for p, _ in jax.tree_util.tree_flatten_with_path(direct)[0])


def _leaves(tree):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else [v]


def _paths(tree, pre=""):
    for k, v in tree.items():
        yield from _paths(v, f"{pre}{k}/") if isinstance(v, dict) else [pre + k]


def _get(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("tok", ["byte", "fixture"])
@pytest.mark.parametrize("model", ["tiny-embed", "tiny-qwen3"])
def test_embedding_engine_matches_jax(model, tok):
    """The port's engine and JAX's on one tree: seven inputs over
    `max_batch=4` (two batches, the second padded from 3 rows to 4), two of
    equal token counts, at full width and at `dimensions=16`, in f32; the
    token totals and the engines' counters agree."""
    jtok = jax_load_tokenizer(FIXTURE if tok == "fixture" else "")
    ttok = load_tokenizer(FIXTURE if tok == "fixture" else "")
    kw = dict(max_batch=4, max_seq_len=64)
    jeng = JaxEmbeddingEngine(model, dtype=jnp.float32, tokenizer=jtok, **kw)
    tree = jax.tree.map(np.asarray, jeng.params)
    teng = EmbeddingEngine(model, dtype=torch.float32, device="cpu", tokenizer=ttok,
                           params=TW.params_from_numpy(tree, get_config(model), "cpu",
                                                       torch.float32), **kw)
    assert teng.decoder_arch == jeng.decoder_arch == (model == "tiny-qwen3")
    texts = ["hello world", "a", "the quick brown fox " * 5, "abcd", "wxyz", "longer input " * 9,
             "seven"]
    assert [teng.prepare_ids(t) for t in texts] == [jeng.prepare_ids(t) for t in texts]
    for dims in (None, 16):
        want, nw = jeng.embed(texts, dimensions=dims)
        got, ng = teng.embed(texts, dimensions=dims)
        assert ng == nw and np.shape(got) == np.shape(want)
        assert np.abs(np.array(got) - np.array(want)).max() <= F32_TOL
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-5)
    assert (teng.total_inputs, teng.total_tokens) == (jeng.total_inputs, jeng.total_tokens)
    assert teng.embed([]) == ([], 0)


@pytest.mark.parametrize("doc,naming", [(BERT_DOC, "bert"), (NOMIC_DOC, "nomic")])
def test_encoder_checkpoint_loads_bitwise(tmp_path, doc, naming):
    """A checkpoint written by JAX's `encoder_to_hf_tensors` (and JAX's
    safetensors writer) loads into the tree `params_from_numpy` makes of
    the same JAX tree, bit for bit; the port's writer gives JAX's tensors;
    an engine booted from the directory embeds as JAX's engine does."""
    jcfg, tcfg = jax_config_from_hf(doc, name="ckpt"), config_from_hf(doc, name="ckpt")
    tree = _tree(jcfg)
    hf = {k: np.asarray(v) for k, v in JW.encoder_to_hf_tensors(jcfg, tree, naming=naming).items()}
    JW.write_safetensors(str(tmp_path / "model.safetensors"), hf)
    (tmp_path / "config.json").write_text(json.dumps(doc))
    got = TW.load_embedder_checkpoint(tcfg, str(tmp_path), dtype=torch.float32)
    want = TW.params_from_numpy(tree, tcfg, "cpu", torch.float32)
    assert sorted(_paths(got)) == sorted(_paths(want))
    for path in _paths(want):
        assert torch.equal(_get(got, path.split("/")), _get(want, path.split("/"))), path
    mine = TW.encoder_to_hf_tensors(tcfg, tree, naming=naming)
    assert sorted(mine) == sorted(hf)
    for k in hf:
        assert np.array_equal(mine[k].numpy(), hf[k]), k
    jeng = JaxEmbeddingEngine("ckpt", weights_dir=str(tmp_path), dtype=jnp.float32, max_batch=2)
    teng = EmbeddingEngine("ckpt", weights_dir=str(tmp_path), dtype=torch.float32, max_batch=2,
                           device="cpu")
    assert teng.max_seq_len == jeng.max_seq_len
    texts = ["one", "two words", "three words here"]
    assert np.abs(np.array(teng.embed(texts)[0]) - np.array(jeng.embed(texts)[0])).max() <= F32_TOL


QWEN3_DOC = {
    "model_type": "qwen3", "vocab_size": 512, "hidden_size": 128, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2, "intermediate_size": 256,
    "head_dim": 64, "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
    "max_position_embeddings": 512, "tie_word_embeddings": True,
}


def test_decoder_embedder_checkpoint_matches_jax(tmp_path):
    """A Qwen3-Embedding-style checkpoint (a qwen3 decoder's config.json
    and safetensors, written by JAX) resolves to a decoder, loads through
    the decoder mapping and embeds as JAX's engine does from the same
    directory, at full width and at `dimensions`."""
    jcfg = jax_config_from_hf(QWEN3_DOC, name="my-qwen3-embed")
    p = JL.init_llama_params(jcfg, jax.random.PRNGKey(6), dtype=jnp.float32)
    hf = {k: np.asarray(v) for k, v in JW.llama_to_hf_tensors(jcfg, p).items()}
    JW.write_safetensors(str(tmp_path / "model.safetensors"), hf)
    (tmp_path / "config.json").write_text(json.dumps(QWEN3_DOC))
    kw = dict(weights_dir=str(tmp_path), max_batch=2, max_seq_len=64)
    jeng = JaxEmbeddingEngine("my-qwen3-embed", dtype=jnp.float32, **kw)
    teng = EmbeddingEngine("my-qwen3-embed", dtype=torch.float32, device="cpu", **kw)
    assert teng.decoder_arch and jeng.decoder_arch and teng.cfg.qk_norm
    texts = ["last token pooling", "b", "a third input here"]
    for dims in (None, 32):
        want, nw = jeng.embed(texts, dimensions=dims)
        got, ng = teng.embed(texts, dimensions=dims)
        assert ng == nw and np.abs(np.array(got) - np.array(want)).max() <= F32_TOL


def _config_case(fn_port, fn_jax, *args):
    """The two configs field for field, or the same ValueError message."""
    try:
        want = fn_jax(*args)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            fn_port(*args)
        assert str(got.value) == str(e)
        return
    got = fn_port(*args)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


@pytest.mark.parametrize("doc", [
    BERT_DOC, dict(BERT_DOC, hidden_act="gelu_new"), dict(BERT_DOC, hidden_act="tanh"),
    NOMIC_DOC, dict(NOMIC_DOC, activation_function="geglu"),
    dict(NOMIC_DOC, activation_function="mish"), dict(NOMIC_DOC, prenorm=True),
    dict(NOMIC_DOC, rotary_emb_fraction=0.5), dict(NOMIC_DOC, rotary_emb_fraction=0.0),
    dict(NOMIC_DOC, qkv_proj_bias=True, mlp_fc1_bias=True, mlp_fc2_bias=True),
    dict(NOMIC_DOC, mlp_fc1_bias=True), dict(NOMIC_DOC, qkv_proj_bias=True, mlp_fc2_bias=False),
], ids=["bert", "bert-gelu_new", "bert-tanh", "nomic", "nomic-geglu", "nomic-mish",
        "nomic-prenorm", "nomic-rotary-half", "nomic-rotary-off", "nomic-biased",
        "nomic-fc1-bias-split", "nomic-fc2-bias-split"])
def test_encoder_config_from_hf_matches_jax(doc):
    _config_case(config_from_hf, jax_config_from_hf, doc, "org/some-embedder")


@pytest.mark.parametrize("name", ["nomic-embed-text", "qwen3-embedding-8b", "tiny-embed",
                                  "nomic-embed-text:v1.5", "Qwen/Qwen3-Embedding-8B",
                                  "mxbai-embed-large"])
def test_embedding_catalog_matches_jax(name):
    _config_case(get_config, jax_get_config, name)


@pytest.mark.parametrize("pool", [{"pooling_mode_cls_token": True},
                                  {"pooling_mode_mean_tokens": True}, "not json", None])
def test_pooling_dir_matches_jax(tmp_path, pool):
    """sentence-transformers' `1_Pooling/config.json` decides an encoder's
    pooling; a malformed one, or none, keeps the family's default."""
    (tmp_path / "config.json").write_text(json.dumps(BERT_DOC))
    if pool is not None:
        (tmp_path / "1_Pooling").mkdir()
        (tmp_path / "1_Pooling" / "config.json").write_text(
            pool if isinstance(pool, str) else json.dumps(pool))
    _config_case(config_from_hf_dir, jax_config_from_hf_dir, str(tmp_path), "pooled")


def test_generation_engine_refuses_encoders():
    """An encoder config (now that configs resolve them) is refused by the
    generation engine, naming the engine that serves it."""
    from llm_mcp_tpu_torch.executor import GenerationEngine

    with pytest.raises(ValueError, match="EmbeddingEngine"):
        GenerationEngine("tiny-embed", device="cpu")


class _Server:
    def __init__(self, embed_engines):
        self.api = serve({}, embed_engines=embed_engines)
        self.base = f"http://127.0.0.1:{self.api.port}"

    def post(self, body=None, raw: bytes | None = None):
        data = raw if raw is not None else json.dumps(body).encode()
        req = urllib.request.Request(self.base + "/v1/embeddings", data=data,
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def get(self, path: str):
        with urllib.request.urlopen(self.base + path, timeout=60) as r:
            return json.loads(r.read())


def test_embeddings_http():
    """The reference's local path: its 400s and messages, the first local
    engine when no model is named, its body and usage, the 503s it gives
    with no cloud provider and no other device; `/v1/models` and `/health`
    list the embedder."""
    eng = EmbeddingEngine("tiny-embed", dtype=torch.float32, device="cpu", max_seq_len=64)
    srv = _Server({"tiny-embed": eng, "second": eng})
    try:
        for body, raw, msg in (
                (None, b"{not json", "invalid JSON body"),
                ({"input": 3}, None, "input must be a string or list of strings"),
                ({"input": ["a", 1]}, None, "input must be a string or list of strings"),
                ({"input": []}, None, "input must not be empty"),
                ({"input": "a", "dimensions": "wide"}, None, "dimensions must be an integer")):
            code, out = srv.post(body, raw)
            assert (code, out["error"]["message"]) == (400, msg)
        code, out = srv.post({"input": "a", "model": "org/cloud-embedder"})
        assert (code, out["error"]["message"]) == (503, "no cloud provider configured")
        code, out = srv.post({"input": "a", "model": "elsewhere"})
        assert code == 503 and out["error"]["message"].startswith(
            "embeddings unavailable for 'elsewhere'")
        code, out = srv.post({"input": ["hello", "hi"], "dimensions": 8})
        assert code == 200 and out["object"] == "list" and out["model"] == "tiny-embed"
        want, ntok = eng.embed(["hello", "hi"], dimensions=8)
        assert [d["index"] for d in out["data"]] == [0, 1]
        assert all(d["object"] == "embedding" for d in out["data"])
        assert [d["embedding"] for d in out["data"]] == want
        assert out["usage"] == {"prompt_tokens": ntok, "total_tokens": ntok}
        code, out = srv.post({"input": "x", "model": "second"})
        assert code == 200 and out["model"] == "second" and len(out["data"][0]["embedding"]) == 64
        models = srv.get("/v1/models")["data"]
        assert [(m["id"], m["kind"]) for m in models] == [("tiny-embed", "embed"),
                                                          ("second", "embed")]
        health = srv.get("/health")["embedders"]["tiny-embed"]
        assert health["device"] == "cpu" and health["total_inputs"] == eng.total_inputs
    finally:
        srv.api.shutdown()
    empty = _Server({})
    try:
        code, out = empty.post({"input": "a"})
        assert (code, out["error"]["message"]) == (503, "no embedding model available")
    finally:
        empty.api.shutdown()
