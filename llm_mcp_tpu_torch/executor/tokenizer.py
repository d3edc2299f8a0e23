"""Byte tokenizer (counterpart of `llm_mcp_tpu/executor/tokenizer.py`).

Dependency-free UTF-8 byte tokenizer (259 ids) so a randomly initialized
model serves the full API without vocabulary files. Streaming decode holds
back an incomplete trailing UTF-8 sequence so multi-byte characters never
split across SSE chunks. The BPE and HF tokenizers come with checkpoint
loading, in a later slice.
"""

from __future__ import annotations


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
