"""Tokenizers (counterpart of `llm_mcp_tpu/executor/tokenizer.py`).

One interface (`Tokenizer`: encode, decode, streaming decode, special
ids) and three implementations, chosen by `load_tokenizer` as the JAX
package chooses them:

  - `bpe.BPETokenizer`: the in-repo byte-level BPE over a checkpoint's
    `tokenizer.json` (native C++ merge core, or its Python twin);
  - `HFTokenizer`: the HuggingFace `tokenizers` library over the same
    file, where it is installed;
  - `ByteTokenizer`: dependency-free UTF-8 bytes (259 ids), so a randomly
    initialized model serves the full API without vocabulary files.

Streaming decode holds back an incomplete trailing UTF-8 sequence, so
multi-byte characters never split across SSE chunks.
"""

from __future__ import annotations

import logging
import os
import struct
from typing import Protocol

log = logging.getLogger("executor")


class Tokenizer(Protocol):
    vocab_size: int
    bos_id: int
    eos_id: int
    pad_id: int

    def encode(self, text: str, add_bos: bool = True) -> list[int]: ...
    def decode(self, ids: list[int]) -> str: ...
    def decode_stream(self, pending: bytes, new_ids: list[int]) -> tuple[str, bytes]: ...
    def decode_flush(self, pending: bytes) -> str: ...


def utf8_hold(data: bytes) -> int:
    """How many trailing bytes form an INCOMPLETE UTF-8 sequence (0-3)."""
    for i in range(1, min(3, len(data)) + 1):
        b = data[-i]
        if b < 0x80:  # ASCII — sequence complete
            return 0
        if b >= 0xC0:  # lead byte of a 2-4 byte sequence
            need = 2 if b < 0xE0 else 3 if b < 0xF0 else 4
            return i if i < need else 0
        # else continuation byte — keep scanning backwards
    return 0


class ByteTokenizer:
    """UTF-8 byte-level tokenizer: 0=pad, 1=bos, 2=eos, byte b → 3+b."""

    PAD, BOS, EOS = 0, 1, 2
    OFFSET = 3

    def __init__(self) -> None:
        self.vocab_size = 259
        self.pad_id = self.PAD
        self.bos_id = self.BOS
        self.eos_id = self.EOS

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = [self.OFFSET + b for b in text.encode("utf-8")]
        return ([self.BOS] + ids) if add_bos else ids

    def _bytes(self, ids: list[int]) -> bytes:
        # ids outside the byte range (a model vocab padded past 259) decode
        # to nothing rather than crashing
        return bytes(i - self.OFFSET for i in ids if self.OFFSET <= i < self.OFFSET + 256)

    def decode(self, ids: list[int]) -> str:
        return self._bytes(ids).decode("utf-8", errors="replace")

    def decode_stream(self, pending: bytes, new_ids: list[int]) -> tuple[str, bytes]:
        """Incremental decode: returns (complete_text, leftover_bytes)."""
        data = pending + self._bytes(new_ids)
        hold = utf8_hold(data)
        if hold:
            return data[:-hold].decode("utf-8", errors="replace"), data[-hold:]
        return data.decode("utf-8", errors="replace"), b""

    def decode_flush(self, pending: bytes) -> str:
        """Decode whatever is still buffered at end of stream."""
        return pending.decode("utf-8", errors="replace") if pending else ""


class HFTokenizer:
    """The HuggingFace `tokenizers` library over a `tokenizer.json`."""

    def __init__(self, path: str):
        from tokenizers import Tokenizer as _Tok

        self._tok = _Tok.from_file(path)
        self.vocab_size = self._tok.get_vocab_size()
        # -1: unresolved, so a real token at id 0 is never masked or stripped
        self.pad_id = self._special("<|finetune_right_pad_id|>", "<pad>", "[PAD]")
        self.bos_id = self._special("<|begin_of_text|>", "<s>", "[CLS]", "<bos>")
        self.eos_id = self._special(
            "<|end_of_text|>", "<|eot_id|>", "</s>", "[SEP]", "<eos>", "<end_of_turn>"
        )

    def _special(self, *names: str) -> int:
        for n in names:
            i = self._tok.token_to_id(n)
            if i is not None:
                return i
        return -1

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = self._tok.encode(text, add_special_tokens=False).ids
        return ([self.bos_id] + ids) if add_bos and self.bos_id >= 0 else ids

    def decode(self, ids: list[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)

    def decode_stream(self, pending: bytes, new_ids: list[int]) -> tuple[str, bytes]:
        """`pending` carries the undecoded ids as little-endian int32s; ids
        are held while the text ends in U+FFFD (a byte token mid-character),
        up to 8 of them (a character spans at most 4)."""
        prev = list(struct.unpack(f"<{len(pending) // 4}i", pending)) if pending else []
        ids = prev + new_ids
        text = self.decode(ids)
        if text.endswith("\ufffd") and len(ids) < 8:
            return "", struct.pack(f"<{len(ids)}i", *ids)
        return text, b""

    def decode_flush(self, pending: bytes) -> str:
        if not pending:
            return ""
        return self.decode(list(struct.unpack(f"<{len(pending) // 4}i", pending)))


def load_tokenizer(weights_dir: str = "") -> Tokenizer:
    """The tokenizer of a weights directory, as the JAX package chooses it:
    with a `tokenizer.json`, the in-repo BPE (native core, else Python), or
    HF `tokenizers` when the file is not byte-level BPE or `regex` is
    missing, else (logged as an error) the byte tokenizer; without one,
    the byte tokenizer. `LLM_MCP_TPU_TOKENIZER=native|python|hf|byte`
    forces a backend (a forced `hf` raises rather than degrade)."""
    if weights_dir:
        path = os.path.join(weights_dir, "tokenizer.json")
        if os.path.exists(path):
            choice = os.environ.get("LLM_MCP_TPU_TOKENIZER", "native")
            if choice == "byte":
                return ByteTokenizer()
            if choice in ("native", "python"):
                try:
                    from .bpe import BPETokenizer

                    return BPETokenizer(path, force_python=(choice == "python"))
                except Exception as e:  # not byte-level BPE, or no `regex`: try HF
                    log.warning("native BPE unavailable for %s (%s); trying HF", path, e)
            if choice == "hf":
                return HFTokenizer(path)
            try:
                return HFTokenizer(path)
            except ImportError as e:
                log.error(
                    "no tokenizer backend available for %s (%s); degrading to the BYTE "
                    "tokenizer: decoded text will not match the model's vocabulary. "
                    "Install `regex` or `tokenizers`.", path, e,
                )
                return ByteTokenizer()
    return ByteTokenizer()
