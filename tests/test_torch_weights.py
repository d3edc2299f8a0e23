"""The port's checkpoint reading against the JAX package's.

  - safetensors: f32, bf16 and int8 tensors written and read back bit for
    bit by the port with `ml_dtypes`, the `safetensors` package, `jax` and
    `llm_mcp_tpu` blocked from import (a subprocess); the port's files read
    by JAX's reader and JAX's files by the port's;
  - sharded directories, and a missing tensor that raises naming it;
  - for each family and Llama and tiny-v2 (MLA and DeepSeek MoE): a
    checkpoint written by JAX's `llama_to_hf_tensors` + `write_safetensors`
    in two shards, loaded by the port, equals `params_from_numpy` of the
    same tree bit for bit and gives the JAX loader's logits within 1e-5
    (f32), as does `hf_to_llama_params` of the shards; the port's
    `llama_to_hf_tensors` gives JAX's tensors;
  - `resolve_config` on an unseen config.json, as JAX resolves it, an
    encoder's (BERT) too;
  - an engine boots from a checkpoint directory (config.json, shards, the
    real-vocabulary tokenizer.json) and serves the JAX engine's greedy
    tokens from the same directory.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from llm_mcp_tpu.models import llama as JL
from llm_mcp_tpu.models import weights as JW
from llm_mcp_tpu.models.configs import get_config as jax_get_config
from llm_mcp_tpu.models.configs import resolve_config as jax_resolve_config
from llm_mcp_tpu_torch.models import llama as TL
from llm_mcp_tpu_torch.models import weights as TW
from llm_mcp_tpu_torch.models.configs import get_config, resolve_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "tiny_real_vocab")
FAMILIES = ["tiny-llm", "tiny-qwen", "tiny-qwen3", "tiny-mistral", "tiny-gemma", "tiny-moe",
            "tiny-v2"]

_ROUNDTRIP_PROBE = r"""
import sys
for m in ("ml_dtypes", "safetensors", "jax", "llm_mcp_tpu"):
    sys.modules[m] = None
import torch
from llm_mcp_tpu_torch.models.weights import read_safetensors, write_safetensors
g = torch.Generator().manual_seed(0)
ts = {"f32": torch.randn(3, 5, generator=g),
      "bf16": torch.randn(4, 6, generator=g).to(torch.bfloat16),
      "i8": torch.randint(-128, 128, (7,), generator=g, dtype=torch.int8)}
path = sys.argv[1]
write_safetensors(path, ts)
back = read_safetensors(path)
assert set(back) == set(ts)
for k, t in ts.items():
    assert back[k].dtype == t.dtype and torch.equal(back[k], t), k
bad = [k for k, v in sys.modules.items() if v is not None and
       k.split(".")[0] in ("ml_dtypes", "safetensors", "jax", "jaxlib", "llm_mcp_tpu")]
assert not bad, bad
print("ROUNDTRIP_OK")
"""


def test_safetensors_roundtrip_without_ml_dtypes(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", _ROUNDTRIP_PROBE, str(tmp_path / "t.safetensors")],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "ROUNDTRIP_OK" in r.stdout, r.stdout + r.stderr


def test_port_files_read_by_jax_and_jax_files_by_port(tmp_path):
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 4)).astype(np.float32)
    b16 = rng.standard_normal((2, 8)).astype(np.float32).astype(ml_dtypes.bfloat16)
    i8 = rng.integers(-128, 128, (5,), dtype=np.int8)
    # the port writes, JAX reads
    p = str(tmp_path / "port.safetensors")
    TW.write_safetensors(p, {"f32": torch.from_numpy(f32), "i8": torch.from_numpy(i8),
                             "bf16": torch.from_numpy(b16.view(np.uint16)).view(torch.bfloat16)})
    back = JW.read_safetensors(p)
    np.testing.assert_array_equal(back["f32"], f32)
    np.testing.assert_array_equal(back["i8"], i8)
    assert back["bf16"].dtype == np.dtype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(back["bf16"].view(np.uint16), b16.view(np.uint16))
    # JAX writes, the port reads
    q = str(tmp_path / "jax.safetensors")
    JW.write_safetensors(q, {"f32": f32, "bf16": b16, "i8": i8})
    got = TW.read_safetensors(q)
    assert torch.equal(got["f32"], torch.from_numpy(f32))
    assert torch.equal(got["i8"], torch.from_numpy(i8))
    assert got["bf16"].dtype == torch.bfloat16
    assert torch.equal(got["bf16"].view(torch.int16), torch.from_numpy(b16.view(np.int16)))


def _jax_tree(name: str, seed: int = 0) -> dict:
    jp = JL.init_llama_params(jax_get_config(name), jax.random.PRNGKey(seed), dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(seed + 7)
    for stack in ("layers", "dense_layers"):
        for k, v in tree.get(stack, {}).items():
            if k.startswith("b") or "norm" in k:
                tree[stack][k] = v + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
    return tree


def _write_jax_checkpoint(name: str, tree: dict, path) -> None:
    hf = JW.llama_to_hf_tensors(jax_get_config(name), tree)
    names = sorted(hf)
    half = len(names) // 2
    for k, part in enumerate((names[:half], names[half:])):
        JW.write_safetensors(str(path / f"model-0000{k + 1}-of-00002.safetensors"),
                             {n: np.asarray(hf[n]) for n in part})


def _assert_trees_equal(a, b, path=""):
    assert set(a) == set(b), (path, sorted(a), sorted(b))
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k], f"{path}{k}/")
        else:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), f"{path}{k}"


@pytest.mark.parametrize("name", FAMILIES)
def test_checkpoint_load_matches_jax_loader(tmp_path, name):
    tree = _jax_tree(name)
    _write_jax_checkpoint(name, tree, tmp_path)
    cfg, jcfg = get_config(name), jax_get_config(name)
    loaded = TW.load_llama_checkpoint(cfg, str(tmp_path), dtype=torch.float32)
    _assert_trees_equal(loaded, TW.params_from_numpy(tree, cfg, "cpu", torch.float32))
    # the host re-layout, in the file's dtype (f32 here), is the same tree
    _assert_trees_equal(TW.hf_to_llama_params(cfg, TW.read_checkpoint_dir(str(tmp_path))), loaded)
    jloaded = JW.load_llama_checkpoint(jcfg, str(tmp_path), dtype=jnp.float32)
    rng = np.random.default_rng(1)
    tokens = rng.integers(3, cfg.vocab_size, (2, 24)).astype(np.int32)
    lengths = np.asarray([24, 13], np.int32)
    jl, _, _ = JL.llama_prefill(jcfg, jloaded, jnp.asarray(tokens), jnp.asarray(lengths))
    tl, _, _ = TL.llama_prefill(cfg, loaded, torch.from_numpy(tokens), torch.from_numpy(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    # the port's writer is JAX's inverse, name for name
    mine = TW.llama_to_hf_tensors(cfg, loaded)
    theirs = JW.llama_to_hf_tensors(jcfg, tree)
    assert set(mine) == set(theirs)
    for k in theirs:
        assert torch.equal(mine[k], torch.from_numpy(np.array(theirs[k]))), k


def test_missing_tensor_raises(tmp_path):
    tree = _jax_tree("tiny-qwen")
    hf = JW.llama_to_hf_tensors(jax_get_config("tiny-qwen"), tree)
    del hf["model.layers.1.self_attn.k_proj.bias"]
    JW.write_safetensors(str(tmp_path / "model.safetensors"),
                         {k: np.asarray(v) for k, v in hf.items()})
    with pytest.raises(KeyError, match="k_proj.bias"):
        TW.load_llama_checkpoint(get_config("tiny-qwen"), str(tmp_path), dtype=torch.float32)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        TW.read_checkpoint_dir(str(empty))


def test_write_checkpoint_dir_shards_and_index(tmp_path):
    """The port's sharded writer (used to write test and card checkpoints):
    the shards, their index and config.json, read back whole."""
    cfg = get_config("tiny-qwen")
    tree = TW.params_from_numpy(_jax_tree("tiny-qwen"), cfg, "cpu", torch.bfloat16)
    hf = TW.llama_to_hf_tensors(cfg, tree)
    TW.write_checkpoint_dir(str(tmp_path), hf, shards=2, config={"model_type": "qwen2"})
    files = sorted(f for f in os.listdir(tmp_path) if f.endswith(".safetensors"))
    assert len(files) == 2
    index = json.loads((tmp_path / "model.safetensors.index.json").read_text())
    assert set(index["weight_map"]) == set(hf) and set(index["weight_map"].values()) == set(files)
    back = TW.read_checkpoint_dir(str(tmp_path))
    assert all(torch.equal(back[k], v) for k, v in hf.items())
    loaded = TW.load_llama_checkpoint(cfg, str(tmp_path), dtype=torch.bfloat16)
    _assert_trees_equal(loaded, tree)


QWEN2_DOC = {
    "model_type": "qwen2", "vocab_size": 512, "hidden_size": 128, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2, "intermediate_size": 256,
    "rope_theta": 1000000.0, "rms_norm_eps": 1e-6, "max_position_embeddings": 512,
    "tie_word_embeddings": True,
}
GEMMA2_DOC = {
    "model_type": "gemma2", "vocab_size": 512, "hidden_size": 128, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2, "intermediate_size": 256,
    "head_dim": 32, "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
    "max_position_embeddings": 512, "final_logit_softcapping": 30.0,
    "attn_logit_softcapping": 50.0, "sliding_window": 64, "query_pre_attn_scalar": 24,
}
MIXTRAL_DOC = dict(QWEN2_DOC, model_type="mixtral", num_local_experts=4, num_experts_per_tok=2)


@pytest.mark.parametrize("doc", [QWEN2_DOC, GEMMA2_DOC, MIXTRAL_DOC])
def test_resolve_config_unseen_matches_jax(tmp_path, doc):
    from dataclasses import fields

    (tmp_path / "config.json").write_text(json.dumps(doc))
    mine = resolve_config("never-seen-model", str(tmp_path))
    theirs = jax_resolve_config("never-seen-model", str(tmp_path))
    assert mine.name == "never-seen-model"
    for f in fields(mine):
        assert getattr(mine, f.name) == getattr(theirs, f.name), f.name
    assert mine.attn_scale == theirs.attn_scale
    # no config.json, or an unusable one: the catalog
    assert resolve_config("tiny-llm", "/nonexistent").name == "tiny-llm"
    (tmp_path / "config.json").write_text(json.dumps({"model_type": "rwkv"}))
    assert resolve_config("tiny-llm", str(tmp_path)).name == "tiny-llm"


def test_encoder_config_raises_naming_roadmap(tmp_path):
    """An encoder's config.json once raised, naming the ROADMAP item of the
    embedders; now that the port serves them it resolves, field for field,
    to the encoder config the JAX package resolves."""
    from dataclasses import fields

    (tmp_path / "config.json").write_text(json.dumps(
        {"model_type": "bert", "vocab_size": 100, "hidden_size": 64, "num_hidden_layers": 2,
         "num_attention_heads": 4, "intermediate_size": 128}))
    mine = resolve_config("some-embedder", str(tmp_path))
    theirs = jax_resolve_config("some-embedder", str(tmp_path))
    assert mine.arch == "encoder" and mine.name == "some-embedder"
    for f in fields(mine):
        assert getattr(mine, f.name) == getattr(theirs, f.name), f.name


LLAMA_DOC = {
    "model_type": "llama", "vocab_size": 512, "hidden_size": 128, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2, "intermediate_size": 256,
    "rope_theta": 10000.0, "rms_norm_eps": 1e-5, "max_position_embeddings": 512,
    "tie_word_embeddings": True,
}


def test_engine_boots_from_checkpoint_dir(monkeypatch, tmp_path):
    """A directory with config.json (an unseen name), two safetensors
    shards and the real-vocabulary tokenizer.json: the port's engine
    resolves the config, loads the weights and the in-repo BPE, and its
    greedy tokens equal the JAX engine's from the same directory."""
    monkeypatch.setenv("LLM_MCP_TPU_ATTN", "pallas")
    monkeypatch.setenv("LLM_MCP_TPU_RAGGED_IMPL", "kernel")
    from llm_mcp_tpu.executor.engine import GenerationEngine as JaxEngine
    from llm_mcp_tpu.executor.engine import GenRequest as JaxRequest
    from llm_mcp_tpu.models.configs import config_from_hf
    from llm_mcp_tpu_torch.executor import GenerationEngine, GenRequest
    from llm_mcp_tpu_torch.executor.bpe import BPETokenizer

    jcfg = config_from_hf(LLAMA_DOC, name="never-seen-1b")
    jp = JL.init_llama_params(jcfg, jax.random.PRNGKey(4), dtype=jnp.float32)
    (tmp_path / "config.json").write_text(json.dumps(LLAMA_DOC))
    hf = {k: np.asarray(v) for k, v in JW.llama_to_hf_tensors(jcfg, jp).items()}
    names = sorted(hf)
    for k, part in enumerate((names[: len(names) // 2], names[len(names) // 2:])):
        JW.write_safetensors(str(tmp_path / f"model-0000{k + 1}-of-00002.safetensors"),
                             {n: hf[n] for n in part})
    with open(os.path.join(FIXTURE, "tokenizer.json")) as f:
        (tmp_path / "tokenizer.json").write_text(f.read())
    kw = dict(max_slots=2, max_seq_len=128, prefill_chunk=16, decode_chunk=4,
              prompt_cache_mb=0, weights_dir=str(tmp_path))
    prompts = ["Hello there, how are you today?", "The quick brown fox jumps over the lazy dog."]

    def run(eng, make):
        out = []
        for p in prompts:
            r = make(eng.tokenizer.encode(p))
            eng.submit(r)
            toks = []
            while True:
                evt = r.out.get(timeout=300)
                if not isinstance(evt, dict) or evt.get("type") in ("done", "error"):
                    assert not isinstance(evt, dict) or evt["type"] == "done", evt
                    break
                toks.append(evt)
            out.append((eng.tokenizer.encode(p), "".join(e.get("text", "") for e in toks)))
        return out

    jeng = JaxEngine("never-seen-1b", dtype=jnp.float32, **kw).start()
    try:
        want = run(jeng, lambda ids: JaxRequest(prompt_ids=ids, max_tokens=10, temperature=0.0))
    finally:
        jeng.shutdown()
    teng = GenerationEngine("never-seen-1b", dtype=torch.float32, device="cpu", **kw).start()
    try:
        assert teng.cfg.name == "never-seen-1b" and teng.cfg.dim == 128
        assert isinstance(teng.tokenizer, BPETokenizer)
        got = run(teng, lambda ids: GenRequest(prompt_ids=ids, max_tokens=10, temperature=0.0))
    finally:
        teng.shutdown()
    assert got == want
