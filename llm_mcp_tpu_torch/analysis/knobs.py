"""Knob-registry pass: every TPU_*/LLM_MCP_TPU_* env read of the port,
accounted for (counterpart of `llm_mcp_tpu/analysis/knobs.py`).

The port and `chip_smoke.py` read their knobs through JAX's four idioms:
`os.environ.get`, `os.environ[...]`, the typed `getenv*` helpers in
utils/config.py, and the local `_env_int`/`_env_float` helpers the
stdlib-only telemetry modules keep so they don't import config. Their
documentation is the "Port knobs" table in README.md's port section: one
row a knob, its default and where it is read.

This pass extracts the registry from the AST — knob name, default (when
the read passes a literal), every reading site — and fails in both
directions:

- **undocumented**: a knob some code reads with no row in the table. Fix:
  add the row (or baseline a deliberately internal knob).
- **dead-doc**: a row naming a knob no code reads. Fix: delete the row or
  restore the reader.

Scan roots are the package plus `chip_smoke.py`; tests never count as
reading sites. A "doc row" is a markdown table row whose FIRST cell
backticks the name — prose mentions do not document a knob. Rows outside
README.md's port section are the JAX package's and are not read here.

The full registry rides the `--json` report.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field

from .core import Finding, RepoIndex, all_nodes

PASS_ID = "knob-registry"

# callable names that read an env var with the var name as first argument
_READER_NAMES = {
    "get", "getenv", "getenv_int", "getenv_float", "getenv_bool",
    "pop", "setdefault",
}
_READER_PREFIXES = ("_env",)  # _env_int / _env_float / _env_bool helpers


@dataclass
class Knob:
    name: str
    sites: list[str] = field(default_factory=list)  # "path:line"
    defaults: list[str] = field(default_factory=list)  # literal 2nd args

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "sites": sorted(self.sites),
            "defaults": sorted(set(self.defaults)),
        }


def _is_reader(func: ast.expr) -> bool:
    name = None
    if isinstance(func, ast.Attribute):
        name = func.attr
    elif isinstance(func, ast.Name):
        name = func.id
    if name is None:
        return False
    return name in _READER_NAMES or name.startswith(_READER_PREFIXES)


def extract_registry(index: RepoIndex) -> dict[str, Knob]:
    prefixes = tuple(index.config["knob_prefixes"])
    roots = [index.config["package"]] + list(
        index.config["knob_extra_roots"]
    )
    files: list[str] = []
    for r in roots:
        files.extend(index.files_under(r))
    knobs: dict[str, Knob] = {}

    def note(name: str, relpath: str, line: int, default: str | None):
        k = knobs.setdefault(name, Knob(name))
        k.sites.append(f"{relpath}:{line}")
        if default is not None:
            k.defaults.append(default)

    for relpath in files:
        tree = index.ast(relpath)
        if tree is None:
            continue
        for node in all_nodes(tree):
            if isinstance(node, ast.Call) and _is_reader(node.func):
                if (
                    node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                    and node.args[0].value.startswith(prefixes)
                ):
                    default = None
                    if len(node.args) > 1 and isinstance(
                        node.args[1], ast.Constant
                    ):
                        default = repr(node.args[1].value)
                    note(
                        node.args[0].value, relpath, node.lineno, default
                    )
            elif isinstance(node, ast.Subscript):
                base = node.value
                is_environ = (
                    isinstance(base, ast.Attribute)
                    and base.attr == "environ"
                ) or (isinstance(base, ast.Name) and base.id == "environ")
                if (
                    is_environ
                    and isinstance(node.slice, ast.Constant)
                    and isinstance(node.slice.value, str)
                    and node.slice.value.startswith(prefixes)
                    and isinstance(getattr(node, "ctx", None), ast.Load)
                ):
                    note(node.slice.value, relpath, node.lineno, None)
    return knobs


_ROW_CELL_RE = re.compile(r"^\|([^|]*)\|")
_TICKED_RE = re.compile(r"`([A-Z][A-Z0-9_]*)`")


def doc_rows(text: str, prefixes: tuple[str, ...]) -> dict[str, int]:
    """name -> first doc line for every knob named in the FIRST cell of a
    markdown table row (handles `A` / `B` twin rows)."""
    out: dict[str, int] = {}
    for lineno, line in enumerate(text.splitlines(), start=1):
        m = _ROW_CELL_RE.match(line.strip())
        if not m:
            continue
        for name in _TICKED_RE.findall(m.group(1)):
            if name.startswith(prefixes):
                out.setdefault(name, lineno)
    return out


class KnobRegistryPass:
    pass_id = PASS_ID

    def run(self, index: RepoIndex) -> list[Finding]:
        prefixes = tuple(index.config["knob_prefixes"])
        doc_rel = index.config["doc_readme"]
        text = index.doc_text("doc_readme")
        if text is None:
            return [
                Finding(
                    PASS_ID, doc_rel, 0, "doc-missing",
                    f"{doc_rel} not found — the env catalog must exist",
                )
            ]
        registry = extract_registry(index)
        documented = doc_rows(text, prefixes)
        findings: list[Finding] = []
        for name, knob in sorted(registry.items()):
            if name not in documented:
                site = sorted(knob.sites)[0]
                path, _, line = site.rpartition(":")
                findings.append(
                    Finding(
                        PASS_ID, path, int(line),
                        f"undocumented:{name}",
                        f"env knob {name} is read at {len(knob.sites)} "
                        f"site(s) (first: {site}) but has no row in "
                        f"{doc_rel} — document it or baseline it as "
                        "internal",
                    )
                )
        for name, line in sorted(documented.items()):
            if name not in registry:
                findings.append(
                    Finding(
                        PASS_ID, doc_rel, line,
                        f"dead-doc:{name}",
                        f"{doc_rel}:{line} documents env knob {name} that "
                        "no code reads — delete the row or restore the "
                        "reader",
                    )
                )
        return findings


def registry_json(index: RepoIndex) -> list[dict]:
    """Stable-ordered registry for the --json report."""
    return [
        k.to_dict() for _, k in sorted(extract_registry(index).items())
    ]
