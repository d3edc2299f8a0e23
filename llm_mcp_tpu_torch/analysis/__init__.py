"""llmtpu-lint for the port: the static-analysis suite over
`llm_mcp_tpu_torch/` (counterpart of `llm_mcp_tpu/analysis/`).

Five AST-only passes — lock-order, donation-safety, knob-registry,
import-purity, registry-census — behind one runner with a
justified-allowlist baseline (`baseline.txt` here). Entry points:

- ``python -m llm_mcp_tpu_torch.analysis`` (human report; ``--json``)
- ``chip_smoke.py --lint`` (the suite on the card's checkout, then the
  kernel census held against the built libraries' exported symbols)
- ``tests/test_torch_analysis.py`` (zero non-baselined findings)

JAX's module names, pass ids, finding keys, baseline syntax and ``--json``
v1 contract are kept, so each counterpart is found at once. This package
imports the standard library only: no torch, no jax, nothing of
``llm_mcp_tpu``; it runs on a CPU-only host in a few seconds.
"""

from .core import (
    BASELINE_PATH,
    DEFAULT_CONFIG,
    BaselineEntry,
    Finding,
    PassResult,
    RepoIndex,
    SuiteResult,
    default_passes,
    parse_baseline,
    render_report,
    run_suite,
)

__all__ = [
    "BASELINE_PATH",
    "DEFAULT_CONFIG",
    "BaselineEntry",
    "Finding",
    "PassResult",
    "RepoIndex",
    "SuiteResult",
    "default_passes",
    "parse_baseline",
    "render_report",
    "run_suite",
]
