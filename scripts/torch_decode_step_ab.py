#!/usr/bin/env python3
"""Compare the PyTorch port's Llama-3.1-8B decode step across checkouts, in turns.

    python3 scripts/torch_decode_step_ab.py PARENT CHANGE CHANGE PARENT

Each argument is a checkout holding `llm_mcp_tpu_torch/`; each run takes a
process of its own (so each imports and builds its own kernels), in the
order given, on one NVIDIA GPU. A run builds Llama-3.1-8B at full depth
and width with random weights from seed 0, in bf16 and then with the int8
engine's weights over the fused int8 KV cache, and hands each to
`breakdown_phase` of this script's own `chip_smoke.py`, so every checkout
is measured by the same code: the decode steps' and the ragged chunk's
wall, device busy, idle share and launches a call. One JSON line per run,
then the card's name and power limit.
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
    import torch

    from llm_mcp_tpu_torch.models import llama as TL
    from llm_mcp_tpu_torch.models.configs import get_config
    from llm_mcp_tpu_torch.models.quant import (
        fuse_layer_weights, gemm_layout, init_llama_params_quantized, quantize_params)

    assert Path(TL.__file__).resolve().is_relative_to(Path(root).resolve())
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    dev = torch.device("cuda")
    cfg = get_config("llama-3.1-8b")
    out = {"checkout": root}
    for quantized in (False, True):
        g = torch.Generator(device=dev).manual_seed(0)
        if quantized:
            params = gemm_layout(fuse_layer_weights(quantize_params(
                init_llama_params_quantized(cfg, g, torch.bfloat16, device=dev))))
        else:
            params = TL.init_llama_params(cfg, g, torch.bfloat16, device=dev)
        out.update(smoke.breakdown_phase(cfg, params, dev, quantized=quantized))
        del params
        torch.cuda.empty_cache()
    return out


def main() -> None:
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(run(sys.argv[2])), flush=True)
        return
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    for root in sys.argv[1:]:
        proc = subprocess.run([sys.executable, __file__, "--one", root], capture_output=True,
                              text=True, timeout=1200)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        if proc.returncode != 0 or not lines:
            sys.exit(f"run in {root} failed (exit {proc.returncode}):\n{proc.stderr[-3000:]}")
        print(lines[-1], flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"], capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
