"""Byte-level BPE tokenizer over the native (C++) merge core (counterpart
of `llm_mcp_tpu/executor/bpe.py`, copied).

The tokenizer for `tokenizer.json` vocabularies (Llama-3, Qwen and other
GPT-2-lineage byte-level BPE): Python owns the cold path (JSON parsing,
the GPT-2 byte-unicode remapping, regex pretokenization through the
`regex` package's \\p classes) and `native/bpe_tokenizer.cpp` the hot path
(the per-piece merge loop and the streaming UTF-8 boundary scan). A
pure-Python merge loop is the fallback where no C++ toolchain exists, and
the equivalence oracle in tests.
"""

from __future__ import annotations

import json
import logging
from functools import lru_cache

log = logging.getLogger("executor.bpe")

# Well-known byte-level BPE pretokenization patterns (public knowledge;
# the `regex` module provides the \p unicode classes).
GPT2_PATTERN = (
    r"'s|'t|'re|'ve|'m|'ll|'d"
    r"| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"
)
LLAMA3_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)"
    r"|[^\r\n\p{L}\p{N}]?\p{L}+"
    r"|\p{N}{1,3}"
    r"| ?[^\s\p{L}\p{N}]+[\r\n]*"
    r"|\s*[\r\n]+"
    r"|\s+(?!\S)"
    r"|\s+"
)


def _find_split_pattern(node: dict | None) -> str | None:
    """Walk a pre_tokenizer config for an embedded Split regex (Llama-3
    style tokenizer.json carries its exact pattern there)."""
    if not isinstance(node, dict):
        return None
    if node.get("type") == "Split":
        pat = node.get("pattern") or {}
        return pat.get("Regex") or pat.get("String")
    if node.get("type") == "Sequence":
        for sub in node.get("pretokenizers") or []:
            found = _find_split_pattern(sub)
            if found:
                return found
    return None


@lru_cache(maxsize=1)
def gpt2_byte_to_unicode() -> dict[int, str]:
    """The GPT-2 printable-unicode remapping of raw bytes (standard table)."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


@lru_cache(maxsize=1)
def gpt2_unicode_to_byte() -> dict[str, int]:
    return {c: b for b, c in gpt2_byte_to_unicode().items()}


def token_str_to_bytes(token: str) -> bytes:
    """tokenizer.json vocab strings → raw bytes (undo the GPT-2 remap)."""
    u2b = gpt2_unicode_to_byte()
    out = bytearray()
    for ch in token:
        b = u2b.get(ch)
        if b is None:
            out.extend(ch.encode("utf-8"))  # added/special tokens stay UTF-8
        else:
            out.append(b)
    return bytes(out)


class _PyBpeCore:
    """Pure-Python twin of native/bpe_tokenizer.cpp (fallback + test oracle)."""

    def __init__(self):
        self.token_to_id: dict[bytes, int] = {}
        self.id_to_token: dict[int, bytes] = {}
        self.merges: dict[tuple[int, int], tuple[int, int]] = {}  # pair -> (rank, merged)
        self.byte_ids = [-1] * 256

    def add_token(self, raw: bytes, idx: int) -> None:
        self.token_to_id[raw] = idx
        self.id_to_token[idx] = raw
        if len(raw) == 1:
            self.byte_ids[raw[0]] = idx

    def add_merge(self, left: int, right: int, rank: int, merged: int) -> None:
        self.merges[(left, right)] = (rank, merged)

    def encode_piece(self, piece: bytes) -> list[int]:
        sym = [self.byte_ids[b] for b in piece if self.byte_ids[b] >= 0]
        while len(sym) >= 2:
            best_pos, best_rank, best_id = -1, 1 << 31, -1
            for i in range(len(sym) - 1):
                info = self.merges.get((sym[i], sym[i + 1]))
                if info is not None and info[0] < best_rank:
                    best_rank, best_pos, best_id = info[0], i, info[1]
            if best_pos < 0:
                break
            sym[best_pos : best_pos + 2] = [best_id]
        return sym

    def decode(self, ids: list[int]) -> bytes:
        return b"".join(self.id_to_token.get(i, b"") for i in ids)


class _NativeBpeCore:
    """ctypes wrapper presenting the same surface as _PyBpeCore."""

    def __init__(self, lib):
        import ctypes

        self._ct = ctypes
        self.lib = lib
        self.handle = lib.bpe_new()
        self._id_to_len: dict[int, int] = {}

    def __del__(self):
        try:
            if getattr(self, "handle", None):
                self.lib.bpe_free(self.handle)
        except Exception:
            pass

    def add_token(self, raw: bytes, idx: int) -> None:
        ct = self._ct
        buf = (ct.c_uint8 * max(1, len(raw))).from_buffer_copy(raw or b"\0")
        self.lib.bpe_add_token(self.handle, buf, len(raw), idx)
        self._id_to_len[idx] = len(raw)

    def add_merge(self, left: int, right: int, rank: int, merged: int) -> None:
        self.lib.bpe_add_merge(self.handle, left, right, rank, merged)

    def encode_piece(self, piece: bytes) -> list[int]:
        ct = self._ct
        n = len(piece)
        inp = (ct.c_uint8 * max(1, n)).from_buffer_copy(piece or b"\0")
        out = (ct.c_int32 * max(1, n))()
        wrote = self.lib.bpe_encode(self.handle, inp, n, out, n)
        if wrote < 0:
            return []
        return list(out[:wrote])

    def encode_pieces(self, pieces: list[bytes]) -> list[int]:
        """All pieces in ONE C call — per-call overhead dominates otherwise."""
        ct = self._ct
        data = b"".join(pieces)
        offsets = [0]
        for p in pieces:
            offsets.append(offsets[-1] + len(p))
        n = len(data)
        inp = (ct.c_uint8 * max(1, n)).from_buffer_copy(data or b"\0")
        offs = (ct.c_int32 * len(offsets))(*offsets)
        out = (ct.c_int32 * max(1, n))()
        wrote = self.lib.bpe_encode_batch(self.handle, inp, offs, len(pieces), out, max(1, n))
        if wrote < 0:
            return []
        return list(out[:wrote])

    def decode(self, ids: list[int]) -> bytes:
        ct = self._ct
        n = len(ids)
        if n == 0:
            return b""
        arr = (ct.c_int32 * n)(*ids)
        cap = sum(self._id_to_len.get(i, 0) for i in ids) + 16
        out = (ct.c_uint8 * cap)()
        wrote = self.lib.bpe_decode(self.handle, arr, n, out, cap)
        return bytes(out[:wrote]) if wrote > 0 else b""


def _make_core(force_python: bool = False):
    if not force_python:
        from ..native import load_bpe

        lib = load_bpe()
        if lib is not None:
            return _NativeBpeCore(lib), True
    return _PyBpeCore(), False


class BPETokenizer:
    """tokenizer.json-backed BPE implementing the executor Tokenizer protocol."""

    def __init__(self, path: str, force_python: bool = False):
        # fail fast (before the expensive vocab load) when \p-class regex
        # support is missing — load_tokenizer treats that as "use HF"
        import regex

        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        model = doc.get("model") or {}
        if model.get("type") not in (None, "BPE"):
            raise ValueError(f"unsupported tokenizer model: {model.get('type')}")
        vocab: dict[str, int] = model.get("vocab") or {}
        merges_raw = model.get("merges") or []

        # Byte-level BPE requires full single-byte coverage in the vocab;
        # SentencePiece-converted BPE files ('<0x41>'-style byte tokens)
        # would otherwise silently encode every prompt to nothing.
        byte_coverage = sum(1 for tok in vocab if len(token_str_to_bytes(tok)) == 1)
        if byte_coverage < 256:
            raise ValueError(
                f"not a byte-level BPE vocabulary ({byte_coverage}/256 byte tokens); "
                "use the HF tokenizer backend"
            )

        self.core, self.is_native = _make_core(force_python)
        raw_by_id: dict[int, bytes] = {}
        token_ids: dict[bytes, int] = {}
        for tok, idx in vocab.items():
            raw = token_str_to_bytes(tok)
            self.core.add_token(raw, int(idx))
            raw_by_id[int(idx)] = raw
            token_ids[raw] = int(idx)
        self.special_ids: set[int] = set()
        special_names: dict[str, int] = {}
        for added in doc.get("added_tokens") or []:
            idx = int(added.get("id", -1))
            content = str(added.get("content") or "")
            if idx < 0 or not content:
                continue
            if idx not in raw_by_id:
                raw = content.encode("utf-8")
                self.core.add_token(raw, idx)
                raw_by_id[idx] = raw
                token_ids[raw] = idx
            if added.get("special", True):
                self.special_ids.add(idx)
                special_names[content] = idx

        dropped = 0
        for rank, m in enumerate(merges_raw):
            if isinstance(m, str):
                left_s, _, right_s = m.partition(" ")
            else:
                left_s, right_s = m[0], m[1]
            left_b, right_b = token_str_to_bytes(left_s), token_str_to_bytes(right_s)
            left = token_ids.get(left_b)
            right = token_ids.get(right_b)
            merged = token_ids.get(left_b + right_b)
            if left is None or right is None or merged is None:
                dropped += 1
                continue
            self.core.add_merge(left, right, rank, merged)
        if dropped:
            log.warning("dropped %d merges with out-of-vocab sides", dropped)

        self.vocab_size = max(raw_by_id, default=-1) + 1
        # specials may live in the base vocab rather than added_tokens
        # (GPT-2's <|endoftext|> does); pick from both.
        specials = dict(special_names)
        for raw, i in token_ids.items():
            if raw.startswith(b"<") or raw.startswith(b"["):
                specials.setdefault(raw.decode("utf-8", "replace"), i)
        # -1 = unresolved: never matches a real token, so encode skips the
        # bos prepend and decode never strips a legitimate id-0 vocab token
        # (engine masking already guards with a 0 <= id < vocab check).
        self.bos_id = self._pick(
            specials, "<|begin_of_text|>", "<s>", "[CLS]", "<|im_start|>", "<bos>",
            "<|endoftext|>",
        )
        self.eos_id = self._pick(
            specials, "<|end_of_text|>", "<|eot_id|>", "</s>", "[SEP]", "<|im_end|>",
            "<eos>", "<end_of_turn>", "<|endoftext|>",
        )
        self.pad_id = self._pick(
            specials, "<|finetune_right_pad_id|>", "<pad>", "[PAD]", "<|endoftext|>"
        )
        self.special_ids.update(
            i for i in (self.bos_id, self.eos_id, self.pad_id) if i >= 0
        )

        pre = doc.get("pre_tokenizer")
        pattern = _find_split_pattern(pre) or (
            GPT2_PATTERN if pre and "ByteLevel" in json.dumps(pre) else LLAMA3_PATTERN
        )
        self._pretok = regex.compile(pattern)

    @staticmethod
    def _pick(specials: dict[str, int], *names: str, default: int = -1) -> int:
        for n in names:
            if n in specials:
                return specials[n]
        return default

    # -- protocol ----------------------------------------------------------

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids: list[int] = [self.bos_id] if add_bos and self.bos_id >= 0 else []
        pieces = [p.encode("utf-8") for p in self._pretok.findall(text)]
        if hasattr(self.core, "encode_pieces"):
            ids.extend(self.core.encode_pieces(pieces))
        else:
            for piece in pieces:
                ids.extend(self.core.encode_piece(piece))
        return ids

    def decode(self, ids: list[int]) -> str:
        # all special tokens are stripped from user-visible text, matching
        # HFTokenizer's decode(skip_special_tokens=True) this replaces
        kept = [i for i in ids if i not in self.special_ids]
        return self.core.decode(kept).decode("utf-8", errors="replace")

    def decode_stream(self, pending: bytes, new_ids: list[int]) -> tuple[str, bytes]:
        data = pending + self.core.decode([i for i in new_ids if i not in self.special_ids])
        hold = _utf8_hold(data, self.core)
        if hold:
            return data[:-hold].decode("utf-8", errors="replace"), data[-hold:]
        return data.decode("utf-8", errors="replace"), b""

    def decode_flush(self, pending: bytes) -> str:
        return pending.decode("utf-8", errors="replace") if pending else ""


def _utf8_hold(data: bytes, core) -> int:
    """Trailing incomplete-UTF-8 byte count; native scanner when available."""
    if not data:
        return 0
    if isinstance(core, _NativeBpeCore):
        import ctypes

        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        return core.lib.utf8_hold(buf, len(data))
    from .tokenizer import utf8_hold

    return utf8_hold(data)
