"""ctypes loader for the port's native BPE core (counterpart of
`llm_mcp_tpu/native/__init__.py`).

`load_bpe()` returns the compiled `libbpe` handle, building it from
`bpe_tokenizer.cpp` beside this file with `g++` at first use into
`build/` here (listed in `.gitignore`). Set `LLM_MCP_TPU_NO_NATIVE=1` to
force the pure-Python merge loop. A failed build logs a warning and
returns None: `executor/bpe.py` then takes its Python core.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

log = logging.getLogger("native")

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "bpe_tokenizer.cpp")
SO = os.path.join(_HERE, "build", "libbpe.so")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_failed = False


def build() -> bool:
    """Compile the library to a per-process temporary name and rename it
    into place, so concurrent processes never load a half-written file."""
    os.makedirs(os.path.dirname(SO), exist_ok=True)
    tmp = f"{SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O2", "-Wall", "-std=c++17", "-fPIC", "-shared", "-o", tmp, SRC]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        log.warning("native build failed to run: %s", e)
        return False
    if r.returncode != 0:
        log.warning("native build failed:\n%s", r.stderr[-2000:])
        return False
    try:
        os.replace(tmp, SO)
    except OSError as e:
        log.warning("native build rename failed: %s", e)
        return False
    return True


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p, i32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32)
    lib.bpe_new.restype = ctypes.c_void_p
    lib.bpe_free.argtypes = [ctypes.c_void_p]
    lib.bpe_add_token.argtypes = [ctypes.c_void_p, u8p, ctypes.c_int, ctypes.c_int32]
    lib.bpe_add_token.restype = ctypes.c_int
    lib.bpe_add_merge.argtypes = [ctypes.c_void_p] + [ctypes.c_int32] * 4
    lib.bpe_add_merge.restype = ctypes.c_int
    lib.bpe_num_tokens.argtypes = [ctypes.c_void_p]
    lib.bpe_num_tokens.restype = ctypes.c_int
    lib.bpe_encode.argtypes = [ctypes.c_void_p, u8p, ctypes.c_int, i32p, ctypes.c_int]
    lib.bpe_encode.restype = ctypes.c_int
    lib.bpe_encode_batch.argtypes = [
        ctypes.c_void_p, u8p, i32p, ctypes.c_int, i32p, ctypes.c_int
    ]
    lib.bpe_encode_batch.restype = ctypes.c_int
    lib.bpe_decode.argtypes = [ctypes.c_void_p, i32p, ctypes.c_int, u8p, ctypes.c_int]
    lib.bpe_decode.restype = ctypes.c_int
    lib.utf8_hold.argtypes = [u8p, ctypes.c_int]
    lib.utf8_hold.restype = ctypes.c_int
    return lib


def load_bpe() -> ctypes.CDLL | None:
    """The libbpe handle, or None when native code is unavailable."""
    global _lib, _failed
    if _lib is not None:
        return _lib
    if _failed or os.environ.get("LLM_MCP_TPU_NO_NATIVE", "") in ("1", "true"):
        return None
    with _lock:
        if _lib is not None or _failed:
            return _lib
        stale = not os.path.exists(SO) or os.path.getmtime(SRC) > os.path.getmtime(SO)
        if stale and not build():
            _failed = True
            return None
        try:
            _lib = _bind(ctypes.CDLL(SO))
        except OSError as e:
            log.warning("failed to load %s: %s", SO, e)
            _failed = True
            return None
    return _lib
