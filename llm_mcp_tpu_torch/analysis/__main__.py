"""CLI for the port's static-analysis suite.

    python -m llm_mcp_tpu_torch.analysis                 # report, rc 1 on FAIL
    python -m llm_mcp_tpu_torch.analysis --json          # machine report (v1)
    python -m llm_mcp_tpu_torch.analysis --no-baseline   # everything as new
    python -m llm_mcp_tpu_torch.analysis --write-lock-table
        # regenerate the rank table between the markers in README.md's
        # port section from the lock pass's extracted map

Exit codes as JAX's: 0 clean, 1 new findings, 2 usage error (argparse).
The --json payload carries the per-pass finding counts, new/baselined
findings with symbolic keys, the extracted env-knob registry and the
lock rank map (JAX's v1 keys)."""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import lock_order
from .core import RepoIndex, render_report, run_suite
from .knobs import registry_json


def _repo_root() -> str:
    # llm_mcp_tpu_torch/analysis/__main__.py -> repo root two levels up
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(here))


def write_lock_table(root: str) -> str:
    """Regenerate the rank table between the markers of the concurrency
    doc (README.md). Returns the new table text; raises if the markers
    are missing."""
    index = RepoIndex(root)
    doc_rel = index.config["doc_concurrency"]
    text = index.text(doc_rel)
    if text is None:
        raise SystemExit(f"{doc_rel} not found under {root}")
    begin = text.find(lock_order.TABLE_BEGIN)
    end = text.find(lock_order.TABLE_END)
    if not (0 <= begin < end):
        raise SystemExit(
            f"{doc_rel} has no {lock_order.TABLE_BEGIN} ... "
            f"{lock_order.TABLE_END} marker block to regenerate"
        )
    table = lock_order.render_table(index)
    head = text[: text.index("\n", begin) + 1]  # keep the begin-marker line
    with open(index.abspath(doc_rel), "w", encoding="utf-8") as fh:
        fh.write(head + table + "\n" + text[end:])
    return table


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m llm_mcp_tpu_torch.analysis",
        description="run the port's llmtpu-lint static-analysis suite",
    )
    ap.add_argument("--root", default=_repo_root(),
                    help="repo root (default: auto-detected)")
    ap.add_argument("--json", action="store_true", dest="json_mode",
                    help="machine-readable report on stdout")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore baseline.txt; every finding is new")
    ap.add_argument("--write-lock-table", action="store_true",
                    help="regenerate README.md's port lock-rank table "
                         "and exit")
    args = ap.parse_args(argv)

    if args.write_lock_table:
        print(write_lock_table(args.root))
        return 0

    index = RepoIndex(args.root)
    result = run_suite(
        args.root, baseline_text="" if args.no_baseline else None,
        index=index,
    )
    if args.json_mode:
        payload = result.to_dict()
        payload["knob_registry"] = registry_json(index)
        payload["lock_ranks"] = lock_order.rank_map(index)
        print(json.dumps(payload, indent=2, sort_keys=True))
    else:
        print(render_report(result))
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
