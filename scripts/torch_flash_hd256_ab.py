#!/usr/bin/env python3
"""Compare the PyTorch port's head_dim-256 flash prefill kernel across checkouts, in turns.

    python3 scripts/torch_flash_hd256_ab.py PARENT CHANGE CHANGE PARENT

Each argument is a checkout holding `llm_mcp_tpu_torch/`; each run takes a
process of its own (so each imports and builds its own kernels), in the
order given, on one NVIDIA GPU. A run hands the checkout's
`flash_prefill_attention` to `kernel_phase_hd256` of this script's own
`chip_smoke.py` (without the flex_attention yardstick), so every checkout
is measured by the same code at Gemma-2-9B's attention: an 8192-token
prompt, sliding and global layers, and the admission shape (4 prompts in a
512 bucket); each row's ms, error against the plain version and bit-equal
repeats. One JSON line per run, then the card's name and power limit.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

SMOKE = Path(__file__).resolve().parent.parent / "chip_smoke.py"


def run(root: str) -> dict:
    sys.path.insert(0, str(Path(root).resolve()))
    from llm_mcp_tpu_torch.kernels import attention as K

    assert Path(K.__file__).resolve().is_relative_to(Path(root).resolve())
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    rows = smoke.kernel_phase_hd256(library=False)
    out = {"checkout": root, "failures": smoke.FAILURES}
    for name, r in rows.items():
        out[name] = {k: r[k] for k in ("ms", "max_abs_err", "worst_err_over_limit",
                                       "repeats_bitwise", "bound_ms")}
        glob = r["shape"].get("global_layer")
        if glob:
            out[name]["global_ms"] = glob["ms"]
    return out


def main() -> None:
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(run(sys.argv[2])), flush=True)
        return
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    for root in sys.argv[1:]:
        proc = subprocess.run([sys.executable, __file__, "--one", root], capture_output=True,
                              text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        if proc.returncode != 0 or not lines:
            sys.exit(f"run in {root} failed (exit {proc.returncode}):\n{proc.stderr[-3000:]}")
        print(lines[-1], flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"], capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
