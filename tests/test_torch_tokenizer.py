"""The port's tokenizers against the JAX package's and HF `tokenizers`.

On `tests/fixtures/tiny_real_vocab/tokenizer.json` (a byte-level BPE with
a real vocabulary's structure): the port's native (C++) and Python BPE
cores give the ids of JAX's `BPETokenizer` and of HF `tokenizers`, decode
back to the text, stream-decode across multibyte boundaries without
splitting a character, resolve the same special ids and strip specials
from decoded text. `load_tokenizer` chooses as JAX's does
(`LLM_MCP_TPU_TOKENIZER=native|python|hf|byte`, no file: bytes), and the
port's native library builds with `g++` from its own copy of the source
and loads.
"""

from __future__ import annotations

import os

import pytest

from llm_mcp_tpu.executor.bpe import BPETokenizer as JaxBPE
from llm_mcp_tpu_torch.executor import tokenizer as T
from llm_mcp_tpu_torch.executor.bpe import BPETokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "tiny_real_vocab")
TOK = os.path.join(FIXTURE, "tokenizer.json")
SAMPLES = [
    "The quick brown fox jumps over the lazy dog.",
    "Numbers 123 4567 890, punctuation?! (parens) [brackets] {braces}",
    "naïve café résumé — ünïcödé tëxt",
    "русский текст и ελληνικά плюс 中文字符 and 日本語テキスト",
    "emoji soup: 🚀🔥✨🎉",
    "def f(x):\n    return x * 2  # comment\n",
    "don't can't won't it's we're they'll I'd you've",
    "",
    "  leading and trailing  ",
]


@pytest.fixture(scope="module")
def toks():
    from tokenizers import Tokenizer

    return {"native": BPETokenizer(TOK), "python": BPETokenizer(TOK, force_python=True),
            "jax": JaxBPE(TOK), "hf": Tokenizer.from_file(TOK)}


def test_native_library_builds_and_loads():
    from llm_mcp_tpu_torch import native

    lib = native.load_bpe()
    assert lib is not None and os.path.exists(native.SO)
    assert native.SO.startswith(os.path.join(REPO, "llm_mcp_tpu_torch", "native", "build"))
    assert BPETokenizer(TOK).is_native


@pytest.mark.parametrize("idx", range(len(SAMPLES)))
def test_ids_match_jax_and_hf(toks, idx):
    text = SAMPLES[idx]
    want = toks["hf"].encode(text, add_special_tokens=False).ids
    assert toks["jax"].encode(text, add_bos=False) == want
    for core in ("native", "python"):
        assert toks[core].encode(text, add_bos=False) == want, core
        ids = toks[core].encode(text)
        assert ids == toks["jax"].encode(text)
        assert toks[core].decode(ids) == text


def test_special_ids_and_stripping(toks):
    for core in ("native", "python"):
        t = toks[core]
        assert (t.bos_id, t.eos_id, t.pad_id, t.vocab_size) == (
            toks["jax"].bos_id, toks["jax"].eos_id, toks["jax"].pad_id, toks["jax"].vocab_size)
        ids = [t.bos_id] + t.encode("hello world", add_bos=False) + [t.eos_id]
        assert t.decode(ids) == "hello world" == toks["jax"].decode(ids)


def test_streaming_decode_at_multibyte_boundaries(toks):
    """Feeding ids one at a time never emits half a character, and the
    concatenated stream equals the whole decode, as JAX's stream does."""
    text = "naïve café 中文字符 🚀🔥 done"
    for core in ("native", "python"):
        t = toks[core]
        ids = t.encode(text, add_bos=False)
        pending, out, jpending, jout = b"", [], b"", []
        for i in ids:
            piece, pending = t.decode_stream(pending, [i])
            jpiece, jpending = toks["jax"].decode_stream(jpending, [i])
            assert "�" not in piece
            assert (piece, pending) == (jpiece, jpending)
            out.append(piece)
        out.append(t.decode_flush(pending))
        assert "".join(out) == text


def test_load_tokenizer_choices(monkeypatch, tmp_path):
    assert isinstance(T.load_tokenizer(""), T.ByteTokenizer)
    assert isinstance(T.load_tokenizer(str(tmp_path)), T.ByteTokenizer)  # no tokenizer.json
    monkeypatch.delenv("LLM_MCP_TPU_TOKENIZER", raising=False)
    tok = T.load_tokenizer(FIXTURE)
    assert isinstance(tok, BPETokenizer) and tok.is_native
    for choice, kind, native in (("python", BPETokenizer, False), ("native", BPETokenizer, True),
                                 ("hf", T.HFTokenizer, None), ("byte", T.ByteTokenizer, None)):
        monkeypatch.setenv("LLM_MCP_TPU_TOKENIZER", choice)
        tok = T.load_tokenizer(FIXTURE)
        assert isinstance(tok, kind), choice
        if native is not None:
            assert tok.is_native is native
    # the HF wrapper gives the same ids and decodes as JAX's
    monkeypatch.setenv("LLM_MCP_TPU_TOKENIZER", "hf")
    hf = T.load_tokenizer(FIXTURE)
    from llm_mcp_tpu.executor.tokenizer import HFTokenizer as JaxHF

    jhf = JaxHF(TOK)
    for text in SAMPLES:
        assert hf.encode(text) == jhf.encode(text)
        assert hf.decode(hf.encode(text)) == jhf.decode(jhf.encode(text))
    assert (hf.bos_id, hf.eos_id, hf.pad_id) == (jhf.bos_id, jhf.eos_id, jhf.pad_id)


def test_not_byte_level_falls_back_to_hf(monkeypatch, tmp_path):
    """A vocabulary without the 256 byte tokens is refused by the BPE, and
    load_tokenizer takes HF, as JAX's does."""
    import json

    doc = json.load(open(TOK))
    doc["model"]["vocab"] = {k: v for k, v in doc["model"]["vocab"].items() if len(k) > 1}
    doc["model"]["merges"] = []
    (tmp_path / "tokenizer.json").write_text(json.dumps(doc))
    monkeypatch.delenv("LLM_MCP_TPU_TOKENIZER", raising=False)
    with pytest.raises(ValueError, match="byte-level"):
        BPETokenizer(str(tmp_path / "tokenizer.json"))
    assert isinstance(T.load_tokenizer(str(tmp_path)), T.HFTokenizer)
