"""llmtpu-lint core for the port (counterpart of
`llm_mcp_tpu/analysis/core.py`): the pass framework every analyzer plugs
into.

The port's invariants were guarded at runtime only: the OrderedLock rank
raises on the paths some test walks, a subprocess probe that imports every
module without jax, and text greps over the kernel registries in one test
file. This package checks them statically, with JAX's framework: a shared
AST/module index over the port, a `Finding` with a stable fingerprint
(pass id + symbolic key, NO line numbers), a justified-allowlist baseline
so only *new* violations fail, and one suite runner behind every entry
point (`python -m llm_mcp_tpu_torch.analysis`, `chip_smoke.py --lint`,
tests/test_torch_analysis.py).

Design rules for passes (JAX's):

- **AST only, never import.** A pass never imports the module it inspects:
  most of the port imports torch. This package imports the standard
  library and nothing else (not torch, not jax, nothing of `llm_mcp_tpu`,
  not even JAX's stdlib-only `analysis/`). What a pass needs from a module
  (registry dicts, tuples, docstrings) comes from the parse tree: the
  `literal_assignment` helpers and `module_env`, a small evaluator for
  the literal registries the port builds with comprehensions.
- **Symbolic keys.** A finding's `key` names the violation, not its
  coordinates; the baseline matches on `(pass_id, key)`.
- **Config over hardcoding.** Every repo path a pass touches comes from
  `RepoIndex.config` (DEFAULT_CONFIG below), so a test points a pass at
  fixture files in a tmp dir and asserts that it fires exactly once.
"""

from __future__ import annotations

import ast
import json
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Iterable

# Every path is repo-root-relative with forward slashes (normalized in
# RepoIndex.rel) so fingerprints are stable across platforms.
DEFAULT_CONFIG: dict = {
    # the package the suite walks
    "package": "llm_mcp_tpu_torch",
    # documentation inputs: README.md's port section holds the knob table
    # and the lock-rank marker block (the JAX package's are in doc/)
    "doc_readme": "README.md",
    "doc_concurrency": "README.md",
    "doc_section": "## PyTorch/CUDA port",
    # registry-census inputs
    "kernel_module": "llm_mcp_tpu_torch/kernels/attention.py",
    "csrc_dir": "llm_mcp_tpu_torch/kernels/csrc",
    # the Pallas bodies the entry points replace: read as a file, never
    # imported
    "pallas_module": "llm_mcp_tpu/kernels/attention.py",
    "parity_registry": "tests/test_torch_port_parity.py",
    "smoke_module": "chip_smoke.py",
    "engine_module": "llm_mcp_tpu_torch/executor/engine.py",
    # dispatch-surface inputs: the step vocabulary's module
    "dispatch_module": "llm_mcp_tpu_torch/executor/dispatch.py",
    "zoo_module": "llm_mcp_tpu_torch/executor/zoo.py",
    "perf_module": "llm_mcp_tpu_torch/telemetry/perf.py",
    "recorder_module": "llm_mcp_tpu_torch/telemetry/recorder.py",
    # knob-registry scan: the package plus the card script
    "knob_extra_roots": ["chip_smoke.py"],
    "knob_prefixes": ("TPU_", "LLM_MCP_TPU_"),
    # the package-wide import rule covers these beside the package
    "import_extra_roots": ["chip_smoke.py"],
    # etypes the recorder census must list (JAX's required_etypes)
    "required_etypes": (
        "pf_rag", "fused_rag", "perf", "wl", "wf",
        "zoo", "swap_in", "swap_out",
        "cn_cmp", "cnstep", "cn_spec",
    ),
}

BASELINE_PATH = "llm_mcp_tpu_torch/analysis/baseline.txt"


@dataclass(frozen=True)
class Finding:
    """One violation: where it is and — via `key` — *what* it is.

    `path`/`line` are for humans and editors; `fingerprint` (pass_id +
    key) is what the baseline matches on.
    """

    pass_id: str
    path: str
    line: int
    key: str
    message: str

    @property
    def fingerprint(self) -> str:
        return f"{self.pass_id}::{self.key}"

    def to_dict(self) -> dict:
        return {
            "pass": self.pass_id,
            "path": self.path,
            "line": self.line,
            "key": self.key,
            "message": self.message,
        }


class RepoIndex:
    """Shared parse-once AST loader over the repo tree.

    Passes ask for files by repo-relative path; parse results are cached.
    Missing files return None — a pass decides whether that is a finding
    (a registry moved) or a skip (an optional doc)."""

    def __init__(self, root: str, config: dict | None = None):
        self.root = os.path.abspath(root)
        self.config = dict(DEFAULT_CONFIG)
        if config:
            self.config.update(config)
        self._ast_cache: dict[str, ast.Module | None] = {}
        self._text_cache: dict[str, str | None] = {}
        self._env_cache: dict[str, dict] = {}
        self.parse_errors: list[Finding] = []

    # -- file access -------------------------------------------------------

    def rel(self, path: str) -> str:
        return os.path.relpath(path, self.root).replace(os.sep, "/")

    def abspath(self, relpath: str) -> str:
        return os.path.join(self.root, relpath.replace("/", os.sep))

    def exists(self, relpath: str) -> bool:
        return os.path.isfile(self.abspath(relpath))

    def text(self, relpath: str) -> str | None:
        if relpath not in self._text_cache:
            try:
                with open(self.abspath(relpath), encoding="utf-8") as fh:
                    self._text_cache[relpath] = fh.read()
            except OSError:
                self._text_cache[relpath] = None
        return self._text_cache[relpath]

    def doc_text(self, key: str) -> str | None:
        """The text of the doc that config[key] names, cut to the
        `doc_section` heading's section when one is configured (README.md's
        port section: the JAX package's own rows are not the port's)."""
        text = self.text(self.config[key])
        head = self.config.get("doc_section")
        if text is None or not head:
            return text
        lines = text.splitlines(keepends=True)
        out: list[str] = []
        inside = False
        for line in lines:
            if line.rstrip("\n") == head:
                inside = True
            elif inside and line.startswith("## "):
                break
            # lines outside the section stay as blank lines, so line
            # numbers in findings are the file's
            out.append(line if inside else "\n")
        return "".join(out) if inside else ""

    def ast(self, relpath: str) -> ast.Module | None:
        if relpath not in self._ast_cache:
            src = self.text(relpath)
            if src is None:
                self._ast_cache[relpath] = None
            else:
                try:
                    tree = ast.parse(src)
                    attach_parents(tree)
                    self._ast_cache[relpath] = tree
                except SyntaxError as exc:
                    self._ast_cache[relpath] = None
                    self.parse_errors.append(
                        Finding(
                            "framework", relpath, exc.lineno or 0,
                            f"syntax:{relpath}",
                            f"unparseable module: {exc.msg}",
                        )
                    )
        return self._ast_cache[relpath]

    def env(self, relpath: str) -> dict | None:
        """`module_env` of a module, cached; None when it is missing."""
        if relpath not in self._env_cache:
            tree = self.ast(relpath)
            if tree is None:
                return None
            self._env_cache[relpath] = module_env(tree)
        return self._env_cache[relpath]

    # -- tree walks --------------------------------------------------------

    def package_files(self) -> list[str]:
        """Sorted repo-relative paths of every .py file in the package."""
        return self.files_under(self.config["package"])

    def files_under(self, relpath: str, suffix: str = ".py") -> list[str]:
        top = self.abspath(relpath)
        if os.path.isfile(top):
            return [relpath] if relpath.endswith(suffix) else []
        out: list[str] = []
        for dirpath, dirnames, filenames in os.walk(top):
            dirnames[:] = [
                d for d in dirnames if d not in ("__pycache__", "build")
            ]
            for fn in sorted(filenames):
                if fn.endswith(suffix):
                    out.append(self.rel(os.path.join(dirpath, fn)))
        return sorted(out)


# -- AST extraction helpers shared by passes --------------------------------


def attach_parents(tree: ast.Module) -> None:
    """Thread `_lint_parent` links through the tree (ast has no parent
    pointers) and keep one pre-order walk of it (`preorder`); RepoIndex
    does this on every parse so passes can walk up, and scan a tree
    without walking it again."""
    nodes: list[ast.AST] = []
    classes: list[str | None] = []
    depths: list[int] = []
    stack: list[tuple[ast.AST, int, str | None]] = [(tree, 0, None)]
    while stack:  # pre-order, in source order
        node, d, cls = stack.pop()
        nodes.append(node)
        classes.append(cls)
        depths.append(d)
        for child in reversed(list(ast.iter_child_nodes(node))):
            child._lint_parent = node  # type: ignore[attr-defined]
            stack.append((child, d + 1,
                          child.name if isinstance(child, ast.ClassDef)
                          else cls))
    # ends[i]: one past the last node of node i's subtree (pre-order keeps a
    # subtree contiguous, so a function's body is a slice, not a walk)
    ends = [len(nodes)] * len(nodes)
    open_: list[int] = []
    for i, d in enumerate(depths):
        while open_ and depths[open_[-1]] >= d:
            ends[open_.pop()] = i
        open_.append(i)
    tree._lint_preorder = (nodes, classes, ends)  # type: ignore[attr-defined]


def preorder(tree: ast.Module) -> tuple[list, list, list]:
    """(nodes, enclosing class name of each, subtree end of each) of a
    parsed tree, in pre-order; nodes[0] is the module."""
    got = getattr(tree, "_lint_preorder", None)
    if got is None:
        attach_parents(tree)
        got = tree._lint_preorder  # type: ignore[attr-defined]
    return got


def all_nodes(tree: ast.Module) -> list[ast.AST]:
    """Every node of a parsed tree, the module included."""
    return preorder(tree)[0]


def enclosing_function(node: ast.AST):
    """The nearest enclosing (Async)FunctionDef of `node`, or None."""
    cur = getattr(node, "_lint_parent", None)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur
        cur = getattr(cur, "_lint_parent", None)
    return None


def literal_assignment(tree: ast.Module, name: str) -> ast.expr | None:
    """The value expression of a module-level `name = <expr>` assignment
    (last one wins, matching runtime semantics)."""
    found: ast.expr | None = None
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id == name:
                    found = node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            if isinstance(node.target, ast.Name) and node.target.id == name:
                found = node.value
    return found


def string_tuple(tree: ast.Module, name: str) -> list[str] | None:
    """A module-level tuple/list-of-strings assignment, e.g.
    DISPATCH_PHASES."""
    expr = literal_assignment(tree, name)
    if not isinstance(expr, (ast.Tuple, ast.List)):
        return None
    out = []
    for elt in expr.elts:
        if not (isinstance(elt, ast.Constant) and isinstance(elt.value, str)):
            return None
        out.append(elt.value)
    return out


def dict_string_keys(tree: ast.Module, name: str) -> list[str] | None:
    """String keys of a module-level dict literal (values may be anything,
    including callables — PHASE_COSTS)."""
    expr = literal_assignment(tree, name)
    if not isinstance(expr, ast.Dict):
        return None
    out = []
    for k in expr.keys:
        if not (isinstance(k, ast.Constant) and isinstance(k.value, str)):
            return None
        out.append(k.value)
    return out


def int_constants(tree: ast.Module) -> dict[str, int]:
    """Module-level NAME = <int literal> bindings — enough to resolve
    `rank=MIGRATION_LOCK_RANK`-style indirection without importing."""
    out: dict[str, int] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt = node.targets[0]
            if (
                isinstance(tgt, ast.Name)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, int)
                and not isinstance(node.value.value, bool)
            ):
                out[tgt.id] = node.value.value
    return out


def string_constants(expr: ast.AST) -> set[str]:
    """Every string constant inside an expression: the phases a
    phase-choosing expression (`"a" if c else ("b" if d else "c")`, a
    literal tuple) may yield."""
    return {
        n.value for n in ast.walk(expr)
        if isinstance(n, ast.Constant) and isinstance(n.value, str)
    }


def walk_skipping_functions(node: ast.AST) -> Iterable[ast.AST]:
    """Walk a tree but do not descend into function/lambda bodies — the
    shape of "executed at import time"."""
    stack = [node]
    while stack:
        cur = stack.pop()
        yield cur
        for child in ast.iter_child_nodes(cur):
            if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                continue
            stack.append(child)


# -- a literal evaluator for registries built with comprehensions -----------
#
# PORT_PARITY, _SIGNATURES and chip_smoke.py's row maps are dict literals
# with `**{f"..._{a}": ... for a in (...)}` splats, f-strings, IfExps and
# `.split`/`.get` calls over literals. `static_eval` computes such
# expressions from the parse tree alone; whatever it cannot compute (a
# ctypes type, a call into the module) is OPAQUE, which propagates.


class _Opaque:
    def __repr__(self) -> str:
        return "OPAQUE"


OPAQUE = _Opaque()


class Unresolved(ValueError):
    """A registry key the evaluator cannot compute."""


# what the registries call on their literals (`a.split("_")[0]`,
# `{...}.get((a, g))`)
_SAFE_METHODS = {str: {"split", "replace", "join"}, dict: {"get"}}
_BINOPS = {ast.Add: lambda a, b: a + b, ast.Mult: lambda a, b: a * b}
_CMPOPS = {ast.Eq: lambda a, b: a == b, ast.NotEq: lambda a, b: a != b,
           ast.In: lambda a, b: a in b, ast.NotIn: lambda a, b: a not in b}


def _opaque(*vals) -> bool:
    return any(v is OPAQUE for v in vals)


def static_eval(node: ast.AST, env: dict):
    """The value of a literal-registry expression, or OPAQUE. Dict keys
    must be computable (Unresolved otherwise)."""
    try:
        return _eval(node, env)
    except Unresolved:
        raise
    except (TypeError, ValueError, KeyError, IndexError, AttributeError):
        return OPAQUE


def _eval(node: ast.AST, env: dict):
    if isinstance(node, ast.Constant):
        return node.value
    if isinstance(node, ast.Name):
        return env.get(node.id, OPAQUE)
    if isinstance(node, (ast.Tuple, ast.List)):
        items = [_eval(elt, env) for elt in node.elts]
        return tuple(items) if isinstance(node, ast.Tuple) else items
    if isinstance(node, ast.Dict):
        out: dict = {}
        for k, v in zip(node.keys, node.values):
            if k is None:  # **splat
                sub = _eval(v, env)
                if not isinstance(sub, dict):
                    raise Unresolved(ast.unparse(v)[:80])
                out.update(sub)
            else:
                key = _eval(k, env)
                if key is OPAQUE:
                    raise Unresolved(ast.unparse(k)[:80])
                out[key] = _eval(v, env)
        return out
    if isinstance(node, ast.JoinedStr):
        parts = []
        for v in node.values:
            p = _eval(v, env)
            if p is OPAQUE:
                return OPAQUE
            parts.append(p)
        return "".join(parts)
    if isinstance(node, ast.FormattedValue):
        v = _eval(node.value, env)
        if v is OPAQUE:
            return OPAQUE
        spec = _eval(node.format_spec, env) if node.format_spec else ""
        if spec is OPAQUE:
            return OPAQUE
        return format(repr(v) if node.conversion == 114 else v, spec)
    if isinstance(node, ast.BinOp) and type(node.op) in _BINOPS:
        a, b = _eval(node.left, env), _eval(node.right, env)
        return OPAQUE if _opaque(a, b) else _BINOPS[type(node.op)](a, b)
    if isinstance(node, ast.Compare):
        left = _eval(node.left, env)
        for op, comp in zip(node.ops, node.comparators):
            right = _eval(comp, env)
            if _opaque(left, right) or type(op) not in _CMPOPS:
                return OPAQUE
            if not _CMPOPS[type(op)](left, right):
                return False
            left = right
        return True
    if isinstance(node, ast.IfExp):
        test = _eval(node.test, env)
        if test is OPAQUE:
            return OPAQUE
        return _eval(node.body if test else node.orelse, env)
    if isinstance(node, ast.Subscript):
        base, idx = _eval(node.value, env), _eval(node.slice, env)
        return OPAQUE if _opaque(base, idx) else base[idx]
    if (
        isinstance(node, ast.Call)
        and not node.keywords
        and isinstance(node.func, ast.Attribute)
    ):
        args = [_eval(a, env) for a in node.args]
        obj = _eval(node.func.value, env)
        if _opaque(obj, *args) or node.func.attr not in _SAFE_METHODS.get(type(obj), ()):
            return OPAQUE
        return getattr(obj, node.func.attr)(*args)
    if isinstance(node, ast.DictComp):
        return _comprehension(node, env)
    return OPAQUE


def _comprehension(node: ast.DictComp, env: dict) -> dict:
    """A dict comprehension over literal iterables; its keys must be
    computable (Unresolved otherwise)."""
    results: list = []

    def rec(i: int, scope: dict) -> None:
        if i == len(node.generators):
            key = _eval(node.key, scope)
            if key is OPAQUE:
                raise Unresolved(ast.unparse(node.key)[:80])
            results.append((key, _eval(node.value, scope)))
            return
        gen = node.generators[i]
        seq = _eval(gen.iter, scope)
        if not isinstance(seq, (tuple, list, dict, str)):
            raise _Bail
        for item in seq:
            inner = dict(scope)
            if not _bind(gen.target, item, inner):
                raise _Bail
            conds = [_eval(c, inner) for c in gen.ifs]
            if _opaque(*conds):
                raise _Bail
            if all(conds):
                rec(i + 1, inner)

    try:
        rec(0, env)
    except _Bail:
        raise Unresolved(ast.unparse(node)[:80]) from None
    return dict(results)


class _Bail(Exception):
    pass


def _bind(target: ast.expr, value, scope: dict) -> bool:
    if isinstance(target, ast.Name):
        scope[target.id] = value
        return True
    if isinstance(target, (ast.Tuple, ast.List)):
        try:
            vals = list(value)
        except TypeError:
            return False
        if len(vals) != len(target.elts):
            return False
        return all(_bind(t, v, scope) for t, v in zip(target.elts, vals))
    return False


def module_env(tree: ast.Module) -> dict:
    """Module-level names bound to values `static_eval` can compute, in
    statement order, with `NAME.update({...})` calls on dicts applied.
    A registry whose keys cannot be computed maps to Unresolved (the
    exception object), so a pass can report *why* it is unreadable."""
    env: dict = {}
    for node in tree.body:
        targets: list[ast.expr] = []
        value = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        elif (
            isinstance(node, ast.Expr)
            and isinstance(node.value, ast.Call)
            and isinstance(node.value.func, ast.Attribute)
            and node.value.func.attr == "update"
            and isinstance(node.value.func.value, ast.Name)
            and isinstance(env.get(node.value.func.value.id), dict)
            and len(node.value.args) == 1
        ):
            try:
                sub = static_eval(node.value.args[0], env)
            except Unresolved as exc:
                env[node.value.func.value.id] = exc
                continue
            if isinstance(sub, dict):
                env[node.value.func.value.id].update(sub)
            continue
        for tgt in targets:
            if isinstance(tgt, ast.Name):
                try:
                    env[tgt.id] = static_eval(value, env)
                except Unresolved as exc:
                    env[tgt.id] = exc
    return env


# -- baseline ----------------------------------------------------------------
#
# Format: one finding per line, `pass_id<spaces>key  # justification`.
# The justification comment is MANDATORY — a baseline entry is a decision,
# and decisions get written down.


@dataclass
class BaselineEntry:
    pass_id: str
    key: str
    justification: str
    line: int

    @property
    def fingerprint(self) -> str:
        return f"{self.pass_id}::{self.key}"


def parse_baseline(text: str, path: str = BASELINE_PATH) -> list[BaselineEntry]:
    entries: list[BaselineEntry] = []
    for lineno, raw in enumerate(text.splitlines(), start=1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        body, _, comment = line.partition("#")
        fields = body.split()
        if len(fields) != 2 or not comment.strip():
            raise ValueError(
                f"{path}:{lineno}: baseline entries are "
                f"'pass_id key  # justification' (justification required); "
                f"got {raw!r}"
            )
        entries.append(
            BaselineEntry(fields[0], fields[1], comment.strip(), lineno)
        )
    return entries


# -- suite -------------------------------------------------------------------


@dataclass
class PassResult:
    pass_id: str
    findings: list[Finding]
    seconds: float


@dataclass
class SuiteResult:
    results: list[PassResult]
    new: list[Finding] = field(default_factory=list)
    baselined: list[Finding] = field(default_factory=list)
    stale_baseline: list[BaselineEntry] = field(default_factory=list)
    baseline_error: str | None = None
    seconds: float = 0.0

    @property
    def findings(self) -> list[Finding]:
        return [f for r in self.results for f in r.findings]

    @property
    def ok(self) -> bool:
        return not self.new and self.baseline_error is None

    def to_dict(self) -> dict:
        return {
            "version": 1,
            "ok": self.ok,
            "seconds": round(self.seconds, 3),
            "passes": [
                {
                    "pass": r.pass_id,
                    "findings": len(r.findings),
                    "seconds": round(r.seconds, 3),
                }
                for r in self.results
            ],
            "new": [f.to_dict() for f in self.new],
            "baselined": [f.to_dict() for f in self.baselined],
            "stale_baseline": [
                {"pass": e.pass_id, "key": e.key, "line": e.line}
                for e in self.stale_baseline
            ],
            "baseline_error": self.baseline_error,
        }


def default_passes() -> list:
    """The six registered passes, in report order (JAX's order). Imported
    lazily so `core` stays importable from any of them."""
    from . import census, dispatch_surface, donation, imports_lint, knobs, lock_order

    return [
        lock_order.LockOrderPass(),
        donation.DonationSafetyPass(),
        knobs.KnobRegistryPass(),
        imports_lint.ImportPurityPass(),
        census.RegistryCensusPass(),
        dispatch_surface.DispatchSurfacePass(),
    ]


def run_suite(
    root: str,
    passes: list | None = None,
    config: dict | None = None,
    baseline_text: str | None = None,
    index: RepoIndex | None = None,
) -> SuiteResult:
    """Run the passes over `root`, split findings into new vs baselined.

    `baseline_text=None` loads the committed baseline file (missing file
    == empty baseline); pass `""` to run baseline-free. A caller that reads
    the tree again afterwards (the CLI's --json) passes its own `index`,
    so nothing is parsed twice."""
    index = index or RepoIndex(root, config)
    results: list[PassResult] = []
    t_suite = time.monotonic()
    for p in passes if passes is not None else default_passes():
        t0 = time.monotonic()
        found = sorted(
            p.run(index), key=lambda f: (f.path, f.line, f.key)
        )
        results.append(PassResult(p.pass_id, found, time.monotonic() - t0))
    if index.parse_errors:
        results.insert(
            0, PassResult("framework", list(index.parse_errors), 0.0)
        )

    out = SuiteResult(results)
    if baseline_text is None:
        baseline_text = index.text(BASELINE_PATH) or ""
    try:
        entries = parse_baseline(baseline_text)
    except ValueError as exc:
        out.baseline_error = str(exc)
        entries = []
    allow = {e.fingerprint: e for e in entries}
    seen: set[str] = set()
    for f in out.findings:
        if f.fingerprint in allow:
            out.baselined.append(f)
            seen.add(f.fingerprint)
        else:
            out.new.append(f)
    out.stale_baseline = [e for e in entries if e.fingerprint not in seen]
    out.seconds = time.monotonic() - t_suite
    return out


def render_report(result: SuiteResult, json_mode: bool = False) -> str:
    if json_mode:
        return json.dumps(result.to_dict(), indent=2, sort_keys=True)
    lines: list[str] = []
    for r in result.results:
        lines.append(
            f"[{r.pass_id}] {len(r.findings)} finding(s) "
            f"({r.seconds * 1000:.0f} ms)"
        )
    if result.baseline_error:
        lines.append(f"BASELINE ERROR: {result.baseline_error}")
    for f in result.new:
        lines.append(f"  NEW {f.pass_id} {f.path}:{f.line}: {f.message}")
        lines.append(f"      key: {f.key}")
    for f in result.baselined:
        lines.append(
            f"  baselined {f.pass_id} {f.path}:{f.line}: {f.key}"
        )
    for e in result.stale_baseline:
        lines.append(
            f"  stale-baseline {e.pass_id} {e.key} "
            f"(baseline.txt:{e.line} matches nothing — delete the entry)"
        )
    verdict = "OK" if result.ok else "FAIL"
    lines.append(
        f"{verdict}: {len(result.new)} new, {len(result.baselined)} "
        f"baselined, {len(result.stale_baseline)} stale baseline entr"
        f"{'y' if len(result.stale_baseline) == 1 else 'ies'} "
        f"in {result.seconds:.2f}s"
    )
    return "\n".join(lines)


# Typing convenience for passes (duck-typed: anything with pass_id + run).
PassFn = Callable[[RepoIndex], list[Finding]]
