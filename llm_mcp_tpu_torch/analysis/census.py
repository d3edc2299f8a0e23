"""Registry-census pass for the port (counterpart of
`llm_mcp_tpu/analysis/census.py`): the cross-module string registries,
reconciled.

1. **kernels** — four sets must be equal: the `extern "C"` entry points in
   `kernels/csrc/*.cu`, the keys of PORT_PARITY
   (tests/test_torch_port_parity.py), the keys of `_SIGNATURES`
   (kernels/attention.py: the ctypes bindings) and the entries that
   chip_smoke.py's row maps name (SOURCES, FAMILY_ROWS, HD64_ROWS: the
   last element of each row). PORT_PARITY is the registry the others are
   held to, so one unregistered entry is one finding. Each binding names
   the library its entry is compiled into, and each row the source. Every
   `def _*_kernel` Pallas body of the JAX package's attention module
   (read as a file, never imported) is named by at least one entry, and
   every CPU and card test an entry names exists in its file.
   `chip_smoke.py --lint` holds this census against the libraries built
   on the card: each entry resolves there, and no library exports an
   entry the census lacks.
2. **dispatch phases** — every phase the port's engine passes to
   `_compile_obs`, `_first_use` (which calls both `_note_exec_shape` and
   `_compile_obs`, engine.py) or `_note_exec_shape` must be registered in
   DISPATCH_PHASES or AUX_COMPILE_PHASES (telemetry/perf.py); every
   DISPATCH_PHASES phase must reach the ledger, be sampled, and have a
   PHASE_COSTS cost model.
3. **flight etypes** — every `.event(etype)` the port emits must appear in
   the recorder module docstring's census, and JAX's required etypes must
   stay listed there.

A phase or etype passed through a variable is read from its
phase-choosing expression: the string literals of the variable's
assignments in the enclosing function (`phase = "decode" if g is None
else ("fused" if g.bucket else "fused_rag")`), of the loop it iterates
(`for phase in ("a", "b")`), or of the matching element of the tuples a
same-class method returns (`phase, key = self._group_key(group)`). What
none of these reads is an `*-unreadable` finding, never a silent skip.

AST and text only: nothing is imported, so the census runs in
milliseconds with neither torch nor a card.
"""

from __future__ import annotations

import ast
import re

from .core import (
    OPAQUE,
    Finding,
    RepoIndex,
    Unresolved,
    all_nodes,
    dict_string_keys,
    enclosing_function,
    string_constants,
    string_tuple,
)

PASS_ID = "registry-census"

_IDENT_RE = re.compile(r"[a-z_][a-z0-9_]*")
# an entry point: `extern "C" int name(`, attributes allowed before `int`
EXTERN_RE = re.compile(
    r'extern\s+"C"\s+(?:__attribute__\s*\(\(.*?\)\)\s*)*int\s+(\w+)\s*\('
)
# the engine's ledger calls; `_first_use` is both of the others
_LEDGER = ("_compile_obs", "_first_use")
_SAMPLE = ("_note_exec_shape", "_first_use")
ROW_MAPS = ("SOURCES", "FAMILY_ROWS", "HD64_ROWS")


def csrc_entries(index: RepoIndex) -> dict[str, list[str]]:
    """{entry point: [the csrc .cu files declaring it]}."""
    out: dict[str, list[str]] = {}
    for rel in index.files_under(index.config["csrc_dir"], ".cu"):
        for name in EXTERN_RE.findall(index.text(rel) or ""):
            out.setdefault(name, []).append(rel)
    return out


def exported_entries(nm_text: str) -> set[str]:
    """The C entry points a built library exports, from the output of
    `nm -D --defined-only`: global text symbols (`T`) with a C name. C++
    names are mangled (`_Z...`) and the loader's and nvcc's own symbols
    (`_init`, `_fini`, `__cuda...`) start with an underscore too."""
    out: set[str] = set()
    for line in nm_text.splitlines():
        parts = line.split()
        if len(parts) == 3 and parts[1] == "T" and not parts[2].startswith("_"):
            out.add(parts[2])
    return out


def kernel_census(index: RepoIndex) -> dict[str, str]:
    """{entry point: the library (csrc stem) it is built into}, from the
    sources: what `chip_smoke.py --lint` resolves in the built libraries."""
    return {
        e: files[0].rsplit("/", 1)[-1][: -len(".cu")]
        for e, files in csrc_entries(index).items()
    }


def _function_names(tree: ast.Module) -> set[str]:
    return {
        n.name
        for n in all_nodes(tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    }


def _registry(index: RepoIndex, rel: str, name: str):
    """(dict, None) for a module-level dict registry, or (None, Finding)
    when it is missing or not statically computable."""
    env = index.env(rel)
    if env is None:
        return None, Finding(
            PASS_ID, rel, 0, f"registry-file-missing:{rel}",
            f"{rel} not found — the kernel census reads {name} there",
        )
    value = env.get(name)
    if isinstance(value, dict):
        return value, None
    why = (f"its keys cannot be computed ({value})"
           if isinstance(value, Unresolved) else "no dict literal binds it")
    return None, Finding(
        PASS_ID, rel, 0, f"registry-unreadable:{rel}:{name}",
        f"{rel}: {name} is not statically readable — {why}",
    )


def _tests_of(value) -> tuple[tuple, tuple]:
    """(cpu tests as (file, name) pairs, card test names) of a
    PORT_PARITY value `(bodies, cpu, card)`."""
    _, cpu, card = value
    cpu = (cpu,) if cpu and isinstance(cpu[0], str) else cpu
    card = (card,) if isinstance(card, str) else card
    return tuple(cpu), tuple(card)


class RegistryCensusPass:
    pass_id = PASS_ID

    def run(self, index: RepoIndex) -> list[Finding]:
        findings: list[Finding] = []
        findings.extend(self._kernels(index))
        findings.extend(self._dispatch_phases(index))
        findings.extend(self._flight_etypes(index))
        return findings

    # -- 1. kernels ------------------------------------------------------------

    def _kernels(self, index: RepoIndex) -> list[Finding]:
        cfg = index.config
        reg_rel, kmod_rel = cfg["parity_registry"], cfg["kernel_module"]
        smoke_rel, pallas_rel = cfg["smoke_module"], cfg["pallas_module"]
        findings: list[Finding] = []
        parity, bad = _registry(index, reg_rel, "PORT_PARITY")
        sigs, bad2 = _registry(index, kmod_rel, "_SIGNATURES")
        findings.extend(f for f in (bad, bad2) if f)
        rows: dict[str, tuple] = {}
        for name in ROW_MAPS:
            got, bad = _registry(index, smoke_rel, name)
            if bad:
                findings.append(bad)
            else:
                rows.update(got)
        pallas = index.ast(pallas_rel)
        if pallas is None:
            findings.append(Finding(
                PASS_ID, pallas_rel, 0, "parity-file-missing",
                f"{pallas_rel} not found — the Pallas bodies cannot be "
                "listed",
            ))
        if parity is None or findings:
            return findings
        csrc_dir = cfg["csrc_dir"]
        externs = csrc_entries(index)
        lib_of = {e: files[0] for e, files in externs.items()}
        for e, files in sorted(externs.items()):
            if len(files) > 1:
                findings.append(Finding(
                    PASS_ID, files[1], 0, f"entry-duplicate:{e}",
                    f"entry point {e} is declared in {', '.join(files)} — "
                    "a symbol belongs to one library",
                ))
        for e in sorted(set(externs) - set(parity)):
            findings.append(Finding(
                PASS_ID, lib_of[e], 0, f"entry-unregistered:{e}",
                f'extern "C" {e} ({lib_of[e]}) has no PORT_PARITY entry — '
                f"register its Pallas bodies and tests in {reg_rel}",
            ))
        for e in sorted(set(parity) - set(externs)):
            findings.append(Finding(
                PASS_ID, reg_rel, 0, f"entry-stale:{e}",
                f"PORT_PARITY entry {e} names no extern \"C\" in {csrc_dir}",
            ))
        # the bindings: same keys, each in the library its entry is built in
        for e in sorted(set(parity) - set(sigs)):
            findings.append(Finding(
                PASS_ID, kmod_rel, 0, f"signature-missing:{e}",
                f"PORT_PARITY entry {e} has no _SIGNATURES binding in "
                f"{kmod_rel}",
            ))
        for e in sorted(set(sigs) - set(parity)):
            findings.append(Finding(
                PASS_ID, kmod_rel, 0, f"signature-stale:{e}",
                f"_SIGNATURES binds {e}, which PORT_PARITY does not list",
            ))
        for e in sorted(set(sigs) & set(lib_of)):
            lib = sigs[e][0] if isinstance(sigs[e], tuple) else OPAQUE
            want = lib_of[e].rsplit("/", 1)[-1][: -len(".cu")]
            if lib != want:
                findings.append(Finding(
                    PASS_ID, kmod_rel, 0, f"signature-library:{e}",
                    f"_SIGNATURES loads {e} from library {lib!r}, but "
                    f"{lib_of[e]} declares it",
                ))
        # the card script's rows: (source, replaces, ..., entry)
        named: set[str] = set()
        for row, value in sorted(rows.items()):
            if not (isinstance(value, tuple) and isinstance(value[-1], str)):
                findings.append(Finding(
                    PASS_ID, smoke_rel, 0, f"row-unreadable:{row}",
                    f"{smoke_rel} row {row} does not end in its entry point",
                ))
                continue
            entry = value[-1]
            named.add(entry)
            if entry not in parity:
                findings.append(Finding(
                    PASS_ID, smoke_rel, 0, f"row-stale:{row}->{entry}",
                    f"{smoke_rel} row {row} names entry {entry}, which "
                    "PORT_PARITY does not list",
                ))
            elif entry in lib_of and value[0] != lib_of[entry]:
                findings.append(Finding(
                    PASS_ID, smoke_rel, 0, f"row-source:{row}",
                    f"{smoke_rel} row {row} says {value[0]}, but its entry "
                    f"{entry} is in {lib_of[entry]}",
                ))
        for e in sorted(set(parity) - named):
            findings.append(Finding(
                PASS_ID, smoke_rel, 0, f"row-missing:{e}",
                f"no row of {smoke_rel}'s {', '.join(ROW_MAPS)} holds entry "
                f"{e} against its plain version on the card",
            ))
        findings.extend(self._bodies_and_tests(index, parity, pallas))
        return findings

    def _bodies_and_tests(self, index, parity: dict, pallas) -> list[Finding]:
        cfg = index.config
        reg_rel, pallas_rel = cfg["parity_registry"], cfg["pallas_module"]
        findings: list[Finding] = []
        bodies = {
            n for n in _function_names(pallas)
            if n.startswith("_") and n.endswith("_kernel")
        }
        if not bodies:
            findings.append(Finding(
                PASS_ID, pallas_rel, 0, "no-kernels-found",
                f"found no `_*_kernel` functions in {pallas_rel} — did the "
                "naming convention change?",
            ))
        named = {b for v in parity.values() for b in v[0]}
        for b in sorted(bodies - named):
            findings.append(Finding(
                PASS_ID, pallas_rel, 0, f"kernel-unregistered:{b}",
                f"Pallas body {b} is named by no PORT_PARITY entry — port it "
                f"and register the entry point in {reg_rel}",
            ))
        for b in sorted(named - bodies):
            findings.append(Finding(
                PASS_ID, reg_rel, 0, f"kernel-stale:{b}",
                f"PORT_PARITY names Pallas body {b}, which {pallas_rel} no "
                "longer has",
            ))
        card_rel = index.env(reg_rel).get("CARD")
        tests: dict[str, set[str] | None] = {}

        def has(rel: str, name: str) -> bool:
            if rel not in tests:
                tree = index.ast(rel)
                tests[rel] = None if tree is None else _function_names(tree)
            return bool(tests[rel]) and name in tests[rel]

        for e, value in sorted(parity.items()):
            cpu, card = _tests_of(value)
            for rel, name in cpu:
                if not has(rel, name):
                    findings.append(Finding(
                        PASS_ID, reg_rel, 0, f"parity-test-missing:{e}:{name}",
                        f"{e}: registered CPU test {rel}::{name} does not "
                        "exist",
                    ))
            for name in card:
                if not (isinstance(card_rel, str) and has(card_rel, name)):
                    findings.append(Finding(
                        PASS_ID, reg_rel, 0, f"card-test-missing:{e}:{name}",
                        f"{e}: registered card test {card_rel}::{name} does "
                        "not exist",
                    ))
        return findings

    # -- 2. dispatch phases ------------------------------------------------------

    def _dispatch_phases(self, index: RepoIndex) -> list[Finding]:
        perf_rel = index.config["perf_module"]
        eng_rel = index.config["engine_module"]
        ptree = index.ast(perf_rel)
        etree = index.ast(eng_rel)
        if ptree is None or etree is None:
            missing = perf_rel if ptree is None else eng_rel
            return [
                Finding(
                    PASS_ID, missing, 0, "phase-file-missing",
                    f"{missing} not found — dispatch-phase census cannot "
                    "run",
                )
            ]
        dispatch = string_tuple(ptree, "DISPATCH_PHASES")
        aux = string_tuple(ptree, "AUX_COMPILE_PHASES")
        costs = dict_string_keys(ptree, "PHASE_COSTS")
        if dispatch is None or aux is None or costs is None:
            gone = [
                n for n, v in (
                    ("DISPATCH_PHASES", dispatch),
                    ("AUX_COMPILE_PHASES", aux),
                    ("PHASE_COSTS", costs),
                )
                if v is None
            ]
            return [
                Finding(
                    PASS_ID, perf_rel, 0, "phase-registry-missing",
                    f"{perf_rel} no longer defines {', '.join(gone)} as "
                    "literals — the phase registry must stay statically "
                    "extractable",
                )
            ]
        got, findings = _string_args(
            etree, eng_rel, ("_compile_obs", "_first_use", "_note_exec_shape"),
            "phase",
        )
        ledgered = set().union(*(got[n] for n in _LEDGER))
        sampled = set().union(*(got[n] for n in _SAMPLE))
        registered = set(dispatch) | set(aux)
        for phase in sorted((ledgered | sampled) - registered):
            findings.append(
                Finding(
                    PASS_ID, eng_rel, 0, f"phase-unregistered:{phase}",
                    f"engine ledgers or samples phase {phase!r}, which is in "
                    "neither DISPATCH_PHASES nor AUX_COMPILE_PHASES — the "
                    "observatory will never report it",
                )
            )
        for phase in sorted(set(dispatch) - ledgered):
            findings.append(
                Finding(
                    PASS_ID, perf_rel, 0, f"phase-unledgered:{phase}",
                    f"DISPATCH_PHASES entry {phase!r} never reaches "
                    "_compile_obs or _first_use in the engine",
                )
            )
        for phase in sorted(set(dispatch) - set(costs)):
            findings.append(
                Finding(
                    PASS_ID, perf_rel, 0, f"phase-uncosted:{phase}",
                    f"dispatch phase {phase!r} has no PHASE_COSTS entry — "
                    "rooflines will misattribute its time",
                )
            )
        for phase in sorted(set(dispatch) - sampled):
            findings.append(
                Finding(
                    PASS_ID, eng_rel, 0, f"phase-unsampled:{phase}",
                    f"dispatch phase {phase!r} is never passed to "
                    "_note_exec_shape or _first_use",
                )
            )
        return findings

    # -- 3. flight etypes --------------------------------------------------------

    def _flight_etypes(self, index: RepoIndex) -> list[Finding]:
        rec_rel = index.config["recorder_module"]
        rtree = index.ast(rec_rel)
        if rtree is None:
            return [
                Finding(
                    PASS_ID, rec_rel, 0, "etype-file-missing",
                    f"{rec_rel} not found — etype census cannot run",
                )
            ]
        census = set(_IDENT_RE.findall(ast.get_docstring(rtree) or ""))
        findings: list[Finding] = []
        for mod_rel in index.package_files():
            mtree = index.ast(mod_rel)
            if mtree is None or ".event(" not in (index.text(mod_rel) or ""):
                continue
            got, unreadable = _string_args(mtree, mod_rel, ("event",),
                                           "etype")
            findings.extend(unreadable)
            for etype in sorted(got["event"] - census):
                findings.append(
                    Finding(
                        PASS_ID, mod_rel, 0, f"etype-uncensused:{etype}",
                        f"{mod_rel} emits flight etype {etype!r} absent from "
                        f"the {rec_rel} docstring census — add it there",
                    )
                )
        for etype in sorted(
            set(index.config["required_etypes"]) - census
        ):
            findings.append(
                Finding(
                    PASS_ID, rec_rel, 0, f"etype-required-missing:{etype}",
                    f"required flight etype {etype!r} dropped from the "
                    f"{rec_rel} docstring census",
                )
            )
        return findings


# -- phase-choosing expressions ---------------------------------------------


def _string_args(
    tree: ast.Module, relpath: str, attr_names: tuple[str, ...], what: str,
) -> tuple[dict[str, set[str]], list[Finding]]:
    """First-argument strings of every `<x>.name(...)` call, per name, with
    variables read from their phase-choosing expressions. A call inside
    one of `attr_names` itself that forwards its own parameter is the
    registry's plumbing and is skipped."""
    out: dict[str, set[str]] = {a: set() for a in attr_names}
    findings: list[Finding] = []
    nodes = all_nodes(tree)
    methods = {
        n.name: n for n in nodes
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    }
    for node in nodes:
        if not (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in out
            and node.args
        ):
            continue
        arg = node.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            out[node.func.attr].add(arg.value)
            continue
        func = enclosing_function(node)
        if (
            isinstance(arg, ast.Name)
            and func is not None
            and func.name in attr_names
            and arg.id in {a.arg for a in func.args.args}
        ):
            continue
        values = _choices(arg, func, methods)
        if values:
            out[node.func.attr].update(values)
        else:
            where = f"{func.name}:" if func is not None else ""
            findings.append(Finding(
                PASS_ID, relpath, node.lineno,
                f"{what}-unreadable:{relpath}::{where}{ast.unparse(arg)}",
                f"the {what} passed to .{node.func.attr}() is "
                f"{ast.unparse(arg)!r}, which no literal in reach names — "
                f"make the {what}s this site may choose literal",
            ))
    return out, findings


def _choices(arg: ast.expr, func, methods: dict) -> set[str]:
    """The strings a Name argument may hold, from the enclosing function's
    assignments to it; empty when none is readable."""
    if not isinstance(arg, ast.Name) or func is None:
        return set()
    out: set[str] = set()
    for node in ast.walk(func):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                out |= _bound_strings(tgt, arg.id, node.value, methods)
        elif isinstance(node, (ast.For, ast.comprehension)):
            if isinstance(node.target, ast.Name) and node.target.id == arg.id:
                out |= string_constants(node.iter)
    return out


def _bound_strings(tgt, name: str, value, methods: dict) -> set[str]:
    if isinstance(tgt, ast.Name):
        return string_constants(value) if tgt.id == name else set()
    if not isinstance(tgt, ast.Tuple):
        return set()
    pos = [i for i, e in enumerate(tgt.elts)
           if isinstance(e, ast.Name) and e.id == name]
    if not pos:
        return set()
    i = pos[0]
    if isinstance(value, ast.Tuple) and len(value.elts) == len(tgt.elts):
        return string_constants(value.elts[i])
    # `a, b = self.method(...)`: element i of each tuple the method returns
    if (
        isinstance(value, ast.Call)
        and isinstance(value.func, ast.Attribute)
        and isinstance(value.func.value, ast.Name)
        and value.func.value.id == "self"
        and value.func.attr in methods
    ):
        out: set[str] = set()
        for ret in ast.walk(methods[value.func.attr]):
            if (
                isinstance(ret, ast.Return)
                and isinstance(ret.value, ast.Tuple)
                and len(ret.value.elts) == len(tgt.elts)
            ):
                out |= string_constants(ret.value.elts[i])
        return out
    return set()
