"""Donation-safety pass for the port (counterpart of
`llm_mcp_tpu/analysis/donation.py`, same pass id): the torch shapes of
JAX's two dispatch-discipline bugs.

1. **Import-time device work** — the counterpart of import-time `jnp`. At
   module level (code that runs on import: module and class bodies), any
   `torch.cuda.*` call (`Stream`, `Event`, `synchronize`, ...), `.cuda()`,
   `.to("cuda...")` / `.to(device="cuda...")`, and a `torch.*` tensor
   factory given a `device=` argument are findings: each initialises CUDA
   on import, which breaks the CPU tests and the rule that entry points
   touch the card only when asked to.
2. **A graph's static output read after the next replay** — the
   counterpart of a donated read. `RoundGraphs.run(key, fn, inputs)`
   (executor/graphs.py) returns the captured graph's static output, which
   the next replay of that graph overwrites in place, so the caller copies
   it out first. A name bound to such a result is a finding when
   - it is read after a later replay in the same function (a `.run(` of
     a graphs object, or a call of a function that returns a static
     output), with no rebinding in between — conservative: the pass does
     not tell a graph's keys apart, and each key has its own output; or
   - it escapes without a copy: stored on `self` (or any attribute or
     item), put in a tuple/list/set/dict display or `.append`-ed, or
     returned from a public function or yielded. What escapes is the name
     itself or a view of it (indexing, `.view`, `.reshape`, `.t()`,
     `.to(...)`, `.contiguous()`, ...: they alias the buffer).
   The copy idiom the engine uses — `dst.copy_(out, non_blocking=True)`
   into a pinned host buffer, queued behind the round — takes the output
   as an argument and stores `dst`, so it passes. A private function
   (leading underscore) that returns the output unchanged hands it to its
   callers in the module (`_round_call` to `_dispatch_round`), and the
   pass follows it there; a public one's callers may be anywhere, so its
   return is an escape.

Scope and honesty: graphs objects are recognised where an attribute or
local is assigned an expression that constructs `RoundGraphs` (the
engine's `self._graphs = RoundGraphs(...) if ... else None`); a graphs
object reached any other way (a parameter, a container) is invisible. A
value passed into a call (a constructor included: `_DispatchedRound(out=
out)`) is not followed into the callee; a static output stored that way
is the runtime's problem, as dispatch through stored callables is in
JAX's pass. The ordering check is lineno-based within the function: exact
for straight-line code, approximate around loops.
"""

from __future__ import annotations

import ast
from .core import Finding, RepoIndex, all_nodes, walk_skipping_functions

PASS_ID = "donation"

GRAPH_CLASS = "RoundGraphs"
# methods that return a view of (or the very) tensor they are called on
VIEW_METHODS = frozenset({
    "view", "view_as", "reshape", "reshape_as", "t", "transpose", "permute",
    "narrow", "expand", "expand_as", "squeeze", "unsqueeze", "flatten",
    "unflatten", "detach", "as_strided", "contiguous", "to", "type_as",
    "select", "unbind", "split", "chunk", "movedim", "swapaxes", "diagonal",
})
VIEW_ATTRS = frozenset({"T", "mT", "H", "mH", "data", "real"})
CONTAINER_METHODS = frozenset({
    "append", "extend", "insert", "add", "put", "put_nowait", "setdefault",
    "update", "appendleft",
})
TENSOR_FACTORIES = frozenset({
    "tensor", "as_tensor", "zeros", "ones", "empty", "full", "arange",
    "linspace", "logspace", "eye", "rand", "randn", "randint", "randperm",
    "zeros_like", "ones_like", "empty_like", "full_like", "rand_like",
    "randn_like", "empty_strided", "from_numpy", "tril_indices",
    "triu_indices",
})


def _aliases(expr: ast.AST | None, names: set[str]) -> str | None:
    """The static name `expr` is (or is a view of, or holds in a display),
    else None."""
    if expr is None:
        return None
    if isinstance(expr, ast.Name):
        return expr.id if expr.id in names else None
    if isinstance(expr, (ast.Subscript, ast.Starred)):
        return _aliases(expr.value, names)
    if isinstance(expr, ast.Attribute) and expr.attr in VIEW_ATTRS:
        return _aliases(expr.value, names)
    if (
        isinstance(expr, ast.Call)
        and isinstance(expr.func, ast.Attribute)
        and expr.func.attr in VIEW_METHODS
    ):
        return _aliases(expr.func.value, names)
    if isinstance(expr, ast.IfExp):
        return _aliases(expr.body, names) or _aliases(expr.orelse, names)
    if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
        return next((n for e in expr.elts if (n := _aliases(e, names))), None)
    if isinstance(expr, ast.Dict):
        return next((n for v in expr.values if (n := _aliases(v, names))),
                    None)
    return None


class DonationSafetyPass:
    pass_id = PASS_ID

    def run(self, index: RepoIndex) -> list[Finding]:
        findings: list[Finding] = []
        files = list(index.package_files())
        for extra in index.config.get("import_extra_roots", ()):
            files.extend(index.files_under(extra))
        for relpath in files:
            tree = index.ast(relpath)
            if tree is None:
                continue
            findings.extend(self._import_time_cuda(relpath, tree))
        for relpath in index.package_files():
            tree = index.ast(relpath)
            if tree is not None:
                findings.extend(self._static_outputs(relpath, tree))
        return findings

    # -- import-time device work ---------------------------------------------

    def _import_time_cuda(
        self, relpath: str, tree: ast.Module
    ) -> list[Finding]:
        findings: list[Finding] = []
        for node in walk_skipping_functions(tree):
            if not isinstance(node, ast.Call):
                continue
            callee = ast.unparse(node.func)
            why = None
            if callee.startswith("torch.cuda."):
                why = "initialises CUDA"
            elif isinstance(node.func, ast.Attribute) and node.func.attr == "cuda":
                why = "moves a tensor to the card"
            elif isinstance(node.func, ast.Attribute) and node.func.attr == "to":
                dev = [a for a in node.args[:1]] + [
                    k.value for k in node.keywords if k.arg == "device"]
                if any(_names_cuda(d) for d in dev):
                    why = "moves a tensor to the card"
            elif (
                callee.startswith("torch.")
                and callee.rsplit(".", 1)[-1] in TENSOR_FACTORIES
                and any(k.arg == "device" for k in node.keywords)
            ):
                why = "allocates on a device"
            if why:
                findings.append(
                    Finding(
                        PASS_ID, relpath, node.lineno,
                        f"import-time-cuda:{relpath}:{callee}",
                        f"{callee}(...) runs at module import time and {why} "
                        "— the CPU tests import every module, and entry "
                        "points use the card only when asked; do it "
                        "lazily inside the function that needs it",
                    )
                )
        return findings

    # -- static graph outputs ------------------------------------------------

    def _static_outputs(
        self, relpath: str, tree: ast.Module
    ) -> list[Finding]:
        receivers = _graph_receivers(tree)
        if not receivers:
            return []
        funcs = [
            n for n in all_nodes(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        # functions that return a static output unchanged: their calls are
        # replays too (fixpoint: a chain of private forwarders)
        sources: set[str] = set()
        while True:
            more = set()
            for f in funcs:
                if f.name in sources:
                    continue
                rets = [r for r in _own_nodes(f) if isinstance(r, ast.Return)]
                if not rets:
                    continue
                names = set(self._bindings(f, receivers, sources))
                if any(_aliases(r.value, names)
                       or self._replay_of(r.value, receivers, sources)
                       for r in rets):
                    more.add(f.name)
            if not more:
                break
            sources |= more
        findings: list[Finding] = []
        for f in funcs:
            findings.extend(self._audit(relpath, f, receivers, sources))
        return findings

    @staticmethod
    def _replay_of(expr, receivers: set[str], sources: set[str]) -> str | None:
        """What `expr` replays: `<graphs>.run(...)` -> the receiver, or a
        call of a static-returning function -> its name."""
        if not isinstance(expr, ast.Call):
            return None
        f = expr.func
        if isinstance(f, ast.Attribute):
            recv = ast.unparse(f.value)
            if f.attr == "run" and recv in receivers:
                return recv
            if (
                f.attr in sources
                and isinstance(f.value, ast.Name)
                and f.value.id in ("self", "cls")
            ):
                return f.attr
        if isinstance(f, ast.Name) and f.id in sources:
            return f.id
        return None

    def _bindings(self, func, receivers, sources) -> dict[str, int]:
        """{name: line} of each local bound to a replay's result."""
        out: dict[str, int] = {}
        for n in _own_nodes(func):
            if isinstance(n, ast.Assign) and self._replay_of(n.value, receivers, sources):
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        out[t.id] = n.lineno
        return out

    def _audit(self, relpath, func, receivers, sources) -> list[Finding]:
        binds = self._bindings(func, receivers, sources)
        if not binds:
            return []
        where = func.name
        own = list(_own_nodes(func))
        # plain local aliases (`m = out`, `m = out[0]`) are static too
        for n in own:
            if (
                isinstance(n, ast.Assign)
                and len(n.targets) == 1
                and isinstance(n.targets[0], ast.Name)
                and _aliases(n.value, set(binds))
                and n.targets[0].id not in binds
            ):
                binds[n.targets[0].id] = n.lineno
        names = set(binds)
        findings: list[Finding] = []
        replays = sorted(
            n.lineno for n in own
            if isinstance(n, ast.Call) and self._replay_of(n, receivers, sources)
        )
        stores: dict[str, list[int]] = {}
        for n in own:
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
                stores.setdefault(n.id, []).append(n.lineno)
        # 1. read after a later replay
        for name, bound in sorted(binds.items()):
            later = [ln for ln in replays if ln > bound]
            if not later:
                continue
            nxt = later[0]
            rebinds = [ln for ln in stores.get(name, ()) if ln > bound]
            for n in own:
                if (
                    isinstance(n, ast.Name) and n.id == name
                    and isinstance(n.ctx, ast.Load) and n.lineno > nxt
                    and not any(bound < ln <= n.lineno for ln in rebinds)
                ):
                    findings.append(Finding(
                        PASS_ID, relpath, n.lineno,
                        f"static-read-after-replay:{name}@{where}",
                        f"{name!r} is a graph's static output (line "
                        f"{bound}) read after the replay at line {nxt}, "
                        "which overwrote it — copy it out before the next "
                        "replay",
                    ))
                    break
        # 2. escapes without a copy
        public = not func.name.startswith("_")
        for n in own:
            hit = None
            how = ""
            if isinstance(n, ast.Assign):
                a = _aliases(n.value, names)
                if a and any(not isinstance(t, ast.Name) for t in n.targets):
                    hit, how = a, "stored on an object or item"
                elif a and isinstance(n.value, (ast.Tuple, ast.List, ast.Set,
                                                ast.Dict)):
                    hit, how = a, "put in a container"
            elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
                a = _aliases(n.value, names)
                if a and not isinstance(n.target, ast.Name):
                    hit, how = a, "stored on an object or item"
            elif (
                isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr in CONTAINER_METHODS
            ):
                a = next((x for arg in n.args if (x := _aliases(arg, names))),
                         None)
                if a:
                    hit, how = a, f"put in a container (.{n.func.attr})"
            elif isinstance(n, ast.Return) and public:
                a = _aliases(n.value, names)
                if a:
                    hit, how = a, "returned from a public function"
            elif isinstance(n, (ast.Yield, ast.YieldFrom)):
                a = _aliases(n.value, names)
                if a:
                    hit, how = a, "yielded"
            if hit:
                findings.append(Finding(
                    PASS_ID, relpath, n.lineno,
                    f"static-escape:{hit}@{where}",
                    f"{hit!r} is a graph's static output (line "
                    f"{binds[hit]}) {how} without a copy — the next "
                    "replay overwrites it; copy it out first "
                    "(`dst.copy_(out, non_blocking=True)`)",
                ))
        return findings


def _names_cuda(expr: ast.AST) -> bool:
    """A device expression naming CUDA: "cuda", "cuda:0",
    torch.device("cuda")."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return expr.value.startswith("cuda")
    if isinstance(expr, ast.Call) and ast.unparse(expr.func).endswith("device"):
        return any(_names_cuda(a) for a in expr.args)
    return False


def _own_nodes(func) -> list[ast.AST]:
    """Nodes of `func` outside its nested functions (they audit
    themselves), computed once a function."""
    cached = getattr(func, "_lint_own", None)
    if cached is None:
        cached = []
        stack = list(ast.iter_child_nodes(func))
        while stack:
            n = stack.pop()
            cached.append(n)
            if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                stack.extend(ast.iter_child_nodes(n))
        func._lint_own = cached
    return cached


def _graph_receivers(tree: ast.Module) -> set[str]:
    """Expressions (`self._graphs`, a local `g`) assigned a value that
    constructs the graph class."""
    out: set[str] = set()
    for node in all_nodes(tree):
        if not isinstance(node, ast.Assign):
            continue
        if any(
            isinstance(c, ast.Call)
            and isinstance(c.func, ast.Name)
            and c.func.id == GRAPH_CLASS
            for c in ast.walk(node.value)
        ):
            out.update(ast.unparse(t) for t in node.targets)
    return out
