"""Build and load the port's CUDA kernels.

Each source `csrc/<name>.cu` compiles with `nvcc` into its own shared
library with a plain C interface, `build/<name>-<digest>.so`, loaded with
`ctypes`. No PyTorch header is involved, so a build takes seconds. The
digest covers the source, the headers and the flags, so an edited source
rebuilds and a stale library is never loaded. The build runs at first use,
from the checkout's sources only; all missing libraries compile in
parallel, one `nvcc` per source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
SOURCES = ("append_kv", "append_kv_q8", "decode_attend", "decode_attend_hd64", "flash_prefill",
           "flash_prefill_hd64", "flash_prefill_hd256", "ragged_prefill", "ragged_prefill_hd64",
           "decode_attend_mla", "ragged_prefill_mla")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def _digest(name: str, flags: tuple[str, ...]) -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def library_path(name: str, flags: tuple[str, ...] = NVCC_FLAGS) -> Path:
    return BUILD / f"{name}-{_digest(name, flags)}.so"


def build(names: tuple[str, ...] = SOURCES, *, verbose: bool = False) -> dict[str, str]:
    """Compile every library of `names` that is not built yet, all at once.
    Returns {name: compiler output} for the sources it compiled (with
    `verbose`, ptxas's register and shared-memory report). Raises with
    the compiler's output when a source does not build."""
    flags = NVCC_FLAGS + (("-Xptxas=-v",) if verbose else ())
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = library_path(name)
        if target.exists() and not verbose:
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *flags, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            target,
        )
    outputs: dict[str, str] = {}
    failed = []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        outputs[name] = out
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return outputs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel source `name`, building every missing
    library first."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            if not library_path(name).exists():
                build()
            _libs[name] = ctypes.CDLL(str(library_path(name)))
        return _libs[name]
