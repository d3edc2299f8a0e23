"""Dispatch-surface pass (counterpart of
`llm_mcp_tpu/analysis/dispatch_surface.py`): the dispatch plane's "no
mirror code" invariant, enforced statically over the port.

One scheduling loop owns policy, and the only multi-rank seam is the
`DispatchBackend` protocol (`executor/dispatch.py`) carrying a serialized
(op, host-payload) step program. That shape survives only if nothing grows
around it; the pass fails when backend-specific command handling appears
outside the protocol:

1. **Vocabulary reconciliation, both ways.** `DISPATCH_OPS` (the published
   step vocabulary in the dispatch module) against the engine's
   `_dx("op", ...)` call sites and the `ops["op"] = ...` registrations in
   `_build_ops`. An op dispatched but not published (followers would
   KeyError), published but never dispatched (a dead vocabulary row), or
   dispatched without a registration is each its own finding; so is a
   `_dx` call whose op is not a string literal.
2. **No private command channels.** `CmdLeader`/`CmdFollower` are built
   only inside the dispatch module: an engine (or any other module of the
   package) opening its own wire is per-feature mirror code.
   Re-exports and imports are fine; instantiation is the finding.
3. **One funnel.** Inside the engine module, `*._backend.emit(...)` is
   called only from `_dx` and `*._backend.run_follower(...)` only from
   `run_follower`: emitting a step outside the funnel puts the leader's
   and the followers' op orders out of step.

AST only, like every pass here: the engine and dispatch modules are never
imported. The paths are `RepoIndex.config`'s `dispatch_module` and
`engine_module`.
"""

from __future__ import annotations

import ast

from .core import Finding, RepoIndex, string_tuple

PASS_ID = "dispatch-surface"

# channel primitives built nowhere but in the dispatch module (check 2)
_CHANNEL_CLASSES = ("CmdLeader", "CmdFollower")

# _backend.<method> -> the one engine function allowed to call it (check 3)
_FUNNELS = {"emit": "_dx", "run_follower": "run_follower"}


def _enclosing_function(node: ast.AST) -> str:
    """Name of the nearest enclosing FunctionDef, "" at module level."""
    cur = getattr(node, "_lint_parent", None)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur.name
        cur = getattr(cur, "_lint_parent", None)
    return ""


def _dx_call_ops(tree: ast.Module) -> dict[str, int]:
    """op name -> first line of every `<something>._dx("op", ...)` call with
    a string-literal op. Non-literal first args are reported separately."""
    out: dict[str, int] = {}
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "_dx"
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            out.setdefault(node.args[0].value, node.lineno)
    return out


def _dx_nonliteral_calls(tree: ast.Module) -> list[int]:
    lines: list[int] = []
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "_dx"
            and node.args
            and not (
                isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
            )
        ):
            lines.append(node.lineno)
    return lines


def _registered_ops(tree: ast.Module) -> dict[str, int]:
    """op name -> line of every `ops["name"] = ...` subscript assignment
    (the `_build_ops` registry convention)."""
    out: dict[str, int] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        for tgt in node.targets:
            if (
                isinstance(tgt, ast.Subscript)
                and isinstance(tgt.value, ast.Name)
                and tgt.value.id == "ops"
                and isinstance(tgt.slice, ast.Constant)
                and isinstance(tgt.slice.value, str)
            ):
                out.setdefault(tgt.slice.value, node.lineno)
    return out


class DispatchSurfacePass:
    pass_id = PASS_ID

    def run(self, index: RepoIndex) -> list[Finding]:
        findings: list[Finding] = []
        findings.extend(self._vocabulary(index))
        findings.extend(self._channel_construction(index))
        findings.extend(self._funnel(index))
        return findings

    # -- 1. vocabulary reconciliation ---------------------------------------

    def _vocabulary(self, index: RepoIndex) -> list[Finding]:
        disp_rel = index.config["dispatch_module"]
        eng_rel = index.config["engine_module"]
        dtree = index.ast(disp_rel)
        etree = index.ast(eng_rel)
        if dtree is None or etree is None:
            missing = disp_rel if dtree is None else eng_rel
            return [
                Finding(
                    PASS_ID, missing, 0, "dispatch-file-missing",
                    f"{missing} not found: the dispatch-surface census cannot "
                    "run",
                )
            ]
        published = string_tuple(dtree, "DISPATCH_OPS")
        if published is None:
            return [
                Finding(
                    PASS_ID, disp_rel, 0, "ops-registry-missing",
                    f"no DISPATCH_OPS string-tuple literal in {disp_rel}: "
                    "the step vocabulary must stay statically extractable",
                )
            ]
        dispatched = _dx_call_ops(etree)
        registered = _registered_ops(etree)
        findings: list[Finding] = []
        for line in _dx_nonliteral_calls(etree):
            findings.append(
                Finding(
                    PASS_ID, eng_rel, line, "dx-nonliteral-op",
                    "_dx called with a non-literal op name: the vocabulary "
                    "census cannot see it; dispatch ops must be string "
                    "literals",
                )
            )
        for op in sorted(set(dispatched) - set(published)):
            findings.append(
                Finding(
                    PASS_ID, eng_rel, dispatched[op],
                    f"op-unpublished:{op}",
                    f"engine dispatches op {op!r} that is not in "
                    f"DISPATCH_OPS ({disp_rel}): followers have no "
                    "contract for it",
                )
            )
        for op in sorted(set(published) - set(dispatched)):
            findings.append(
                Finding(
                    PASS_ID, disp_rel, 0, f"op-undispatched:{op}",
                    f"DISPATCH_OPS entry {op!r} is never dispatched via "
                    "_dx in the engine: a dead vocabulary row",
                )
            )
        for op in sorted(set(dispatched) - set(registered)):
            findings.append(
                Finding(
                    PASS_ID, eng_rel, dispatched[op],
                    f"op-unimplemented:{op}",
                    f"engine dispatches op {op!r} with no ops[{op!r}] "
                    "registration in _build_ops: the dispatch would "
                    "KeyError on every backend",
                )
            )
        for op in sorted(set(registered) - set(published)):
            findings.append(
                Finding(
                    PASS_ID, eng_rel, registered[op],
                    f"op-unregistered:{op}",
                    f"_build_ops registers op {op!r} missing from "
                    f"DISPATCH_OPS ({disp_rel}): publish it or delete it",
                )
            )
        return findings

    # -- 2. channel construction outside the protocol -----------------------

    def _channel_construction(self, index: RepoIndex) -> list[Finding]:
        disp_rel = index.config["dispatch_module"]
        findings: list[Finding] = []
        for rel in index.package_files():
            if rel == disp_rel:
                continue
            tree = index.ast(rel)
            if tree is None:
                continue
            for node in ast.walk(tree):
                if (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id in _CHANNEL_CLASSES
                ):
                    findings.append(
                        Finding(
                            PASS_ID, rel, node.lineno,
                            f"mirror-channel:{node.func.id}:{rel}",
                            f"{node.func.id} constructed outside {disp_rel}: "
                            "a private command channel is per-feature "
                            "mirror code; route the step through the "
                            "DispatchBackend protocol",
                        )
                    )
        return findings

    # -- 3. the one funnel --------------------------------------------------

    def _funnel(self, index: RepoIndex) -> list[Finding]:
        eng_rel = index.config["engine_module"]
        etree = index.ast(eng_rel)
        if etree is None:
            return []
        findings: list[Finding] = []
        for node in ast.walk(etree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _FUNNELS
                and isinstance(node.func.value, ast.Attribute)
                and node.func.value.attr == "_backend"
            ):
                continue
            fn = _enclosing_function(node)
            allowed = _FUNNELS[node.func.attr]
            if fn != allowed:
                findings.append(
                    Finding(
                        PASS_ID, eng_rel, node.lineno,
                        f"emit-outside-funnel:{node.func.attr}:{fn or '<module>'}",
                        f"_backend.{node.func.attr} called from "
                        f"{fn or '<module level>'}: only {allowed!r} may "
                        "touch it; anything else puts the leader's and the "
                        "followers' step orders out of step",
                    )
                )
        return findings
