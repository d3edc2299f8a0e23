"""Lock-order pass: the port's OrderedLock rank discipline, checked before
runtime (counterpart of `llm_mcp_tpu/analysis/lock_order.py`).

`utils/locks.py` enforces rank order at acquire time — but only on the
code path some thread actually walks. The port has four ranked locks
(`engine.stats`, `kvpool`, `paging`, and `migration` at
`MIGRATION_LOCK_RANK`). This pass makes the discipline static:

1. **Rank map extraction** — every `OrderedLock(name, rank)` construction
   in the port, with `rank=` resolved through module-level integer
   constants (`MIGRATION_LOCK_RANK`). Duplicate ranks and duplicate names
   are findings: two locks sharing a rank can deadlock each other while
   the runtime check stays silent (equal is rejected at acquire, so the
   first nesting raises — but only at runtime).
2. **Doc drift** — the extracted map must match the rank table in
   README.md's port section row for row. The table is regenerated from
   this pass's map (`python -m llm_mcp_tpu_torch.analysis
   --write-lock-table`), so it cannot drift; the check catches hand edits.
3. **Acquisition-order audit** — a conservative interprocedural walk:
   every `with <lock>:` whose context expression resolves to a ranked
   lock opens a held scope; inside it, directly nested ranked `with`s and
   calls whose (transitive) may-acquire set contains a rank <= the held
   rank are findings.

Call resolution is deliberately narrow — `self.method()` to the enclosing
class, `name()` to a same-module function, `self.attr.method()` through a
global `self.attr = ClassName(...)` assignment census (unambiguous attr
names only). Narrow means no false positives from duck typing; the
runtime check stays the backstop for dynamic dispatch.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field

from .core import Finding, RepoIndex, int_constants, preorder

PASS_ID = "lock-order"

# rank-table markers, JAX's strings (also used by --write-lock-table)
TABLE_BEGIN = "<!-- lock-rank-table:begin"
TABLE_END = "<!-- lock-rank-table:end -->"
_ROW_RE = re.compile(r"^\|\s*(\d+)\s*\|\s*`([^`]+)`")


@dataclass
class LockDef:
    name: str
    rank: int
    path: str
    line: int
    cls: str | None  # enclosing class when constructed as self.X = ...
    attr: str | None  # the attribute it is bound to


@dataclass
class _Acq:
    """One direct ranked acquisition inside a function."""

    rank: int
    lock: str
    line: int


@dataclass
class _FuncInfo:
    qualname: str  # "module.py::Class.method" or "module.py::func"
    path: str
    direct: list[_Acq] = field(default_factory=list)
    # calls made anywhere in the body: resolved callee qualnames
    calls: list[str] = field(default_factory=list)


def extract_lock_defs(index: RepoIndex) -> tuple[list[LockDef], list[Finding]]:
    defs: list[LockDef] = []
    findings: list[Finding] = []
    for relpath in index.package_files():
        tree = index.ast(relpath)
        if tree is None:
            continue
        consts = int_constants(tree)
        for _, node, cls in _walk_with_class(tree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "OrderedLock"
            ):
                continue
            name = rank = None
            args = list(node.args)
            if args and isinstance(args[0], ast.Constant):
                name = args[0].value
            if len(args) > 1:
                rank = _resolve_int(args[1], consts)
            for kw in node.keywords:
                if kw.arg == "name" and isinstance(kw.value, ast.Constant):
                    name = kw.value.value
                if kw.arg == "rank":
                    rank = _resolve_int(kw.value, consts)
            if relpath.endswith("utils/locks.py"):
                continue  # the class's own repr/docstring examples
            if not isinstance(name, str) or rank is None:
                findings.append(
                    Finding(
                        PASS_ID, relpath, node.lineno,
                        f"unresolved:{relpath}:{ast.unparse(node)[:60]}",
                        "OrderedLock construction with non-literal name or "
                        "rank — the static rank map cannot see it",
                    )
                )
                continue
            defs.append(
                LockDef(name, rank, relpath, node.lineno, cls,
                        _bound_attr(node)))
    return defs, findings


def _walk_with_class(tree: ast.Module):
    """(index, node, enclosing_class_name) for every node below the module,
    in pre-order (the parse's walk, core.preorder)."""
    nodes, classes, _ = preorder(tree)
    return zip(range(1, len(nodes)), nodes[1:], classes[1:])


def _subtree(tree: ast.Module, i: int) -> list:
    """The nodes under node i of `_walk_with_class(tree)` (not i itself)."""
    nodes, _, ends = preorder(tree)
    return nodes[i + 1: ends[i]]


def _resolve_int(expr: ast.expr, consts: dict[str, int]) -> int | None:
    if isinstance(expr, ast.Constant) and isinstance(expr.value, int):
        return expr.value
    if isinstance(expr, ast.Name):
        return consts.get(expr.id)
    return None


def _bound_attr(call: ast.Call) -> str | None:
    """The `X` of `self.X = OrderedLock(...)` / `X = OrderedLock(...)`,
    recovered from the parent assignment (RepoIndex attaches
    `_lint_parent` links at parse time — core.attach_parents)."""
    parent = getattr(call, "_lint_parent", None)
    if isinstance(parent, ast.Assign) and len(parent.targets) == 1:
        tgt = parent.targets[0]
        if isinstance(tgt, ast.Attribute):
            return tgt.attr
        if isinstance(tgt, ast.Name):
            return tgt.id
    return None


def parse_doc_table(text: str) -> dict[str, int] | None:
    """name -> rank from the concurrency doc's rank table. Uses the
    marker block when present, else every `| N | \\`name\\` |` row."""
    begin = text.find(TABLE_BEGIN)
    end = text.find(TABLE_END)
    region = text[begin:end] if 0 <= begin < end else text
    rows: dict[str, int] = {}
    for line in region.splitlines():
        m = _ROW_RE.match(line.strip())
        if m:
            rows[m.group(2)] = int(m.group(1))
    return rows or None


class LockOrderPass:
    pass_id = PASS_ID

    def run(self, index: RepoIndex) -> list[Finding]:
        findings: list[Finding] = []
        defs, extract_findings = extract_lock_defs(index)
        findings.extend(extract_findings)
        findings.extend(self._uniqueness(defs))
        findings.extend(self._doc_drift(index, defs))
        findings.extend(self._order_audit(index, defs))
        return findings

    # -- checks -------------------------------------------------------------

    def _uniqueness(self, defs: list[LockDef]) -> list[Finding]:
        out: list[Finding] = []
        by_rank: dict[int, LockDef] = {}
        by_name: dict[str, LockDef] = {}
        for d in defs:
            prev = by_rank.get(d.rank)
            if prev and prev.name != d.name:
                out.append(
                    Finding(
                        PASS_ID, d.path, d.line,
                        f"dup-rank:{d.rank}:{prev.name}+{d.name}",
                        f"locks {prev.name!r} ({prev.path}) and {d.name!r} "
                        f"share rank {d.rank} — they can never nest and the "
                        "runtime check only catches it when they do",
                    )
                )
            by_rank.setdefault(d.rank, d)
            prev = by_name.get(d.name)
            if prev and prev.rank != d.rank:
                out.append(
                    Finding(
                        PASS_ID, d.path, d.line,
                        f"dup-name:{d.name}:{prev.rank}+{d.rank}",
                        f"lock name {d.name!r} constructed with two ranks "
                        f"({prev.rank} at {prev.path}:{prev.line}, "
                        f"{d.rank} here)",
                    )
                )
            by_name.setdefault(d.name, d)
        return out

    def _doc_drift(
        self, index: RepoIndex, defs: list[LockDef]
    ) -> list[Finding]:
        doc_rel = index.config["doc_concurrency"]
        text = index.doc_text("doc_concurrency")
        if text is None:
            return [
                Finding(
                    PASS_ID, doc_rel, 0, "doc-missing",
                    f"{doc_rel} not found — the rank table must exist",
                )
            ]
        doc = parse_doc_table(text)
        if doc is None:
            return [
                Finding(
                    PASS_ID, doc_rel, 0, "doc-no-table",
                    f"no rank table rows found in {doc_rel}",
                )
            ]
        code = {d.name: d.rank for d in defs}
        out: list[Finding] = []
        for name, rank in sorted(code.items()):
            if name not in doc:
                out.append(
                    Finding(
                        PASS_ID, doc_rel, 0, f"doc-missing-lock:{name}",
                        f"lock {name!r} (rank {rank}) is constructed in code "
                        f"but has no row in {doc_rel} — run "
                        "`python -m llm_mcp_tpu_torch.analysis --write-lock-table`",
                    )
                )
            elif doc[name] != rank:
                out.append(
                    Finding(
                        PASS_ID, doc_rel, 0,
                        f"doc-rank-drift:{name}:{doc[name]}!={rank}",
                        f"doc says {name!r} has rank {doc[name]}, code says "
                        f"{rank} — regenerate the table",
                    )
                )
        for name in sorted(set(doc) - set(code)):
            out.append(
                Finding(
                    PASS_ID, doc_rel, 0, f"doc-stale-lock:{name}",
                    f"{doc_rel} documents lock {name!r} that no code "
                    "constructs — delete the row or restore the lock",
                )
            )
        return out

    # -- acquisition-order audit --------------------------------------------

    def _order_audit(
        self, index: RepoIndex, defs: list[LockDef]
    ) -> list[Finding]:
        # lock lookup structures
        by_cls_attr: dict[tuple[str, str], LockDef] = {}
        by_global: dict[tuple[str, str], LockDef] = {}  # (path, var name)
        for d in defs:
            if d.cls and d.attr:
                by_cls_attr[(d.cls, d.attr)] = d
            elif d.attr:
                by_global[(d.path, d.attr)] = d

        # global attr -> class census for self.attr.method() resolution;
        # ambiguous attr names resolve to nothing.
        attr_cls: dict[str, str | None] = {}
        class_files: dict[str, str] = {}
        for relpath in index.package_files():
            tree = index.ast(relpath)
            if tree is None:
                continue
            for _, node, cls in _walk_with_class(tree):
                if isinstance(node, ast.ClassDef):
                    class_files.setdefault(node.name, relpath)
                if (
                    isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)
                    and isinstance(node.value.func, ast.Name)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Attribute)
                ):
                    attr = node.targets[0].attr
                    cls_name = node.value.func.id
                    if attr in attr_cls and attr_cls[attr] != cls_name:
                        attr_cls[attr] = None  # ambiguous
                    else:
                        attr_cls.setdefault(attr, cls_name)

        def lock_of(expr: ast.expr, relpath: str, cls: str | None):
            """Resolve a with-item context expression to a LockDef."""
            if isinstance(expr, ast.Attribute) and isinstance(
                expr.value, ast.Name
            ):
                if expr.value.id == "self" and cls:
                    return by_cls_attr.get((cls, expr.attr))
            if isinstance(expr, ast.Name):
                return by_global.get((relpath, expr.id))
            return None

        # pass 1: per-function direct acquisitions + resolved call edges
        funcs: dict[str, _FuncInfo] = {}

        def qual(relpath: str, cls: str | None, name: str) -> str:
            return f"{relpath}::{cls + '.' if cls else ''}{name}"

        for relpath in index.package_files():
            tree = index.ast(relpath)
            if tree is None:
                continue
            module_funcs = {
                n.name for n in tree.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            }
            for i, node, cls in _walk_with_class(tree):
                if not isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    continue
                info = _FuncInfo(qual(relpath, cls, node.name), relpath)
                for sub in _subtree(tree, i):
                    if isinstance(sub, ast.With):
                        for item in sub.items:
                            d = lock_of(item.context_expr, relpath, cls)
                            if d:
                                info.direct.append(
                                    _Acq(d.rank, d.name, sub.lineno)
                                )
                    elif isinstance(sub, ast.Call):
                        cq = self._callee_qual(
                            sub, relpath, cls, module_funcs, attr_cls,
                            class_files,
                        )
                        if cq:
                            info.calls.append(cq)
                funcs[info.qualname] = info

        # pass 2: transitive may-acquire closure
        closure: dict[str, set[tuple[int, str]]] = {
            q: {(a.rank, a.lock) for a in i.direct} for q, i in funcs.items()
        }
        changed = True
        while changed:
            changed = False
            for q, info in funcs.items():
                for cq in info.calls:
                    extra = closure.get(cq, set()) - closure[q]
                    if extra:
                        closure[q] |= extra
                        changed = True

        # pass 3: audit every held scope
        findings: list[Finding] = []
        for relpath in index.package_files():
            tree = index.ast(relpath)
            if tree is None:
                continue
            module_funcs = {
                n.name for n in tree.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            }
            for i, node, cls in _walk_with_class(tree):
                if not isinstance(node, ast.With):
                    continue
                held = [
                    (lock_of(it.context_expr, relpath, cls), it)
                    for it in node.items
                ]
                fn = self._enclosing_function(node)
                where = qual(relpath, cls, fn) if fn else relpath
                for d, _item in held:
                    if d is None:
                        continue
                    for sub in _subtree(tree, i):
                        if isinstance(sub, ast.With):
                            for item in sub.items:
                                inner = lock_of(
                                    item.context_expr, relpath, cls
                                )
                                if inner and inner.rank <= d.rank:
                                    findings.append(
                                        Finding(
                                            PASS_ID, relpath, sub.lineno,
                                            f"nest:{d.name}<-{inner.name}"
                                            f"@{where}",
                                            f"acquires {inner.name!r} (rank "
                                            f"{inner.rank}) while holding "
                                            f"{d.name!r} (rank {d.rank}) — "
                                            "rank must strictly increase",
                                        )
                                    )
                        elif isinstance(sub, ast.Call):
                            cq = self._callee_qual(
                                sub, relpath, cls, module_funcs, attr_cls,
                                class_files,
                            )
                            if not cq:
                                continue
                            for rank, lname in sorted(closure.get(cq, ())):
                                if rank <= d.rank and lname != d.name:
                                    findings.append(
                                        Finding(
                                            PASS_ID, relpath, sub.lineno,
                                            f"call-nest:{d.name}<-{lname}"
                                            f"@{where}->{cq}",
                                            f"call into {cq} may acquire "
                                            f"{lname!r} (rank {rank}) while "
                                            f"holding {d.name!r} (rank "
                                            f"{d.rank})",
                                        )
                                    )
        return findings

    @staticmethod
    def _enclosing_function(node: ast.AST) -> str | None:
        cur = getattr(node, "_lint_parent", None)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur.name
            cur = getattr(cur, "_lint_parent", None)
        return None

    @staticmethod
    def _callee_qual(
        call: ast.Call,
        relpath: str,
        cls: str | None,
        module_funcs: set[str],
        attr_cls: dict[str, str | None],
        class_files: dict[str, str],
    ) -> str | None:
        f = call.func
        if isinstance(f, ast.Name) and f.id in module_funcs:
            return f"{relpath}::{f.id}"
        if isinstance(f, ast.Attribute):
            base = f.value
            if isinstance(base, ast.Name) and base.id == "self" and cls:
                return f"{relpath}::{cls}.{f.attr}"
            if (
                isinstance(base, ast.Attribute)
                and isinstance(base.value, ast.Name)
                and base.value.id == "self"
            ):
                target_cls = attr_cls.get(base.attr)
                if target_cls and target_cls in class_files:
                    return f"{class_files[target_cls]}::{target_cls}.{f.attr}"
        return None


def rank_map(index: RepoIndex) -> dict[str, int]:
    """name -> rank, for --write-lock-table and the JSON report."""
    defs, _ = extract_lock_defs(index)
    return {d.name: d.rank for d in defs}


def render_table(index: RepoIndex) -> str:
    """The rank table the marker block holds, from the extracted map."""
    defs, _ = extract_lock_defs(index)
    rows = ["| rank | lock | constructed at |", "| --- | --- | --- |"]
    for d in sorted(defs, key=lambda d: d.rank):
        rows.append(f"| {d.rank} | `{d.name}` | `{d.path}:{d.line}` |")
    return "\n".join(rows)
