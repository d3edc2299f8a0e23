"""Import-purity pass for the port (counterpart of
`llm_mcp_tpu/analysis/imports_lint.py`): the pinned modules, and the
no-jax rule over the whole port.

Two halves:

1. **PURITY_MANIFEST** — JAX's ten pins, each on its port counterpart:
   the flight recorder, tracer, perf observatory and workload capture
   (every layer imports telemetry, so telemetry must weigh nothing), the
   migration wire codec and the host-side KV pool, the n-gram drafter,
   the constraint compiler's automata and masks, and the ranked locks;
   and one of the port's own, the dispatch plane (`executor/dispatch.py`,
   the standard library alone). Consumed twice, as in JAX:

   - **statically** (this pass): module-level imports of each pinned
     module must resolve to stdlib + the entry's `allow` set. Lazy
     imports inside functions are the sanctioned escape hatch.
   - **at runtime** (`run_probe`, one subprocess an entry in
     tests/test_torch_analysis.py): the module is loaded by file path
     with stubbed parent packages, its `exercise` snippet runs, and
     sys.modules must hold nothing of the entry's `forbidden` packages
     (a name matches a package when it equals it or starts with it and a
     dot: `llm_mcp_tpu` does not match `llm_mcp_tpu_torch`).

2. **The package-wide rule** — no import at ANY depth (inside functions
   too, and `importlib.import_module` / `__import__` of a literal) of
   FORBIDDEN_EVERYWHERE, in the port and in `chip_smoke.py`. It is the
   static half of tests/test_torch_engine.py's
   `test_port_imports_without_jax`, which blocks the same list and only
   imports modules: a lazy `import jax` inside a function passes that
   probe and fails this rule.
"""

from __future__ import annotations

import ast
import os
import subprocess
import sys
import textwrap
from dataclasses import dataclass

from .core import Finding, RepoIndex, all_nodes

PASS_ID = "import-purity"

# what the port never imports: JAX and its package, and what the card's
# machine lacks (the port's rpc/ writes gRPC, HTTP/2 and HPACK by hand,
# telemetry writes Prometheus' text format, weights read bf16 without
# ml_dtypes)
FORBIDDEN_EVERYWHERE = (
    "jax", "jaxlib", "llm_mcp_tpu",
    "ml_dtypes", "grpc", "google.protobuf", "h2", "hpack",
    "prometheus_client", "httpx",
)
_NO_JAX = ("jax", "jaxlib", "llm_mcp_tpu")


@dataclass
class PurityEntry:
    key: str
    path: str  # repo-relative module path
    # import-name prefixes allowed beyond stdlib at module level
    allow: tuple[str, ...] = ()
    # packages that must be absent from sys.modules after the probe
    forbidden: tuple[str, ...] = _NO_JAX + ("torch", "numpy")
    # parent packages to stub before loading by file path
    stubs: tuple[str, ...] = ()
    # extra modules to load (by file path, in order) before the module
    deps: tuple[str, ...] = ()
    # runtime snippet exercising the module (it is bound as `mod`);
    # {tmp} substitutes a scratch dir when the test passes one
    exercise: str = ""
    why: str = ""


_TEL = ("llm_mcp_tpu_torch", "llm_mcp_tpu_torch.telemetry")
_TEL_FORBIDDEN = _NO_JAX + (
    "llm_mcp_tpu_torch.executor", "llm_mcp_tpu_torch.api",
    "llm_mcp_tpu_torch.routing", "llm_mcp_tpu_torch.worker",
    "llm_mcp_tpu_torch.rpc", "llm_mcp_tpu_torch.models", "torch", "numpy",
)
_EXE = ("llm_mcp_tpu_torch", "llm_mcp_tpu_torch.utils",
        "llm_mcp_tpu_torch.executor")

PURITY_MANIFEST: tuple[PurityEntry, ...] = (
    PurityEntry(
        key="recorder",
        path="llm_mcp_tpu_torch/telemetry/recorder.py",
        stubs=_TEL,
        forbidden=_TEL_FORBIDDEN,
        exercise=textwrap.dedent(
            """
            import json
            rec = mod.FlightRecorder(capacity=16, dump_dir={tmp!r},
                                     dump_interval_s=0.0)
            rec.event("decode", trace_id="a" * 32, rows=1)
            path = rec.dump("lint", force=True)
            rows = [json.loads(l) for l in open(path)]
            assert rows[0]["kind"] == "flight_dump"
            assert rows[1]["etype"] == "decode"
            """
        ),
        why="journals the hot path from every layer; must weigh nothing",
    ),
    PurityEntry(
        key="tracing",
        path="llm_mcp_tpu_torch/telemetry/tracing.py",
        stubs=_TEL,
        forbidden=_TEL_FORBIDDEN,
        exercise=textwrap.dedent(
            """
            tr = mod.Tracer(max_traces=8)
            with tr.span("api") as sp:
                pass
            assert tr.get_trace(sp.trace_id), "span did not record"
            """
        ),
        why="every request path carries a trace; imported by all layers",
    ),
    PurityEntry(
        key="perf",
        path="llm_mcp_tpu_torch/telemetry/perf.py",
        stubs=_TEL,
        forbidden=_TEL_FORBIDDEN,
        exercise=textwrap.dedent(
            """
            shape = mod.ModelShape(dim=64, n_layers=2, n_heads=4,
                                   n_kv_heads=2, head_dim=16,
                                   param_count=1000)
            obs = mod.PerfObservatory(shape)
            obs.observe_itl(0.1, 2)
            obs.finish_request(10.0, 5.0, 8)
            obs.should_sample("decode")
            obs.observe_phase("decode", 0.001, 0.01, tokens=8, rows=2,
                              ctx_mean=32.0)
            st = obs.stats()
            assert set(st["roofline"]["layouts"]) == set(mod.CACHE_LAYOUTS)
            """
        ),
        why="cost models + rooflines sampled from the engine loop",
    ),
    PurityEntry(
        key="workload",
        path="llm_mcp_tpu_torch/telemetry/workload.py",
        stubs=_TEL,
        forbidden=_TEL_FORBIDDEN,
        exercise=textwrap.dedent(
            """
            import os
            wl = mod.WorkloadTrace(capacity=16, trace_path="",
                                   include_ids=True)
            rec = wl.record(ts=1.0, rid="r1", prompt_tokens=4,
                            chain=[(4, "aa")], max_tokens=2,
                            output_tokens=2, finish="length",
                            ids=[1, 2, 3, 4])
            assert rec is not None and rec["ids"] == [1, 2, 3, 4]
            path = os.path.join({tmp!r}, "wl.jsonl")
            assert wl.dump(path) == 1
            recs, rej = mod.parse_trace(open(path).read().splitlines()
                                        + ["garbage"])
            assert len(recs) == 1 and rej == 1
            assert mod.synth_trace("agent", 4, seed=1) == \\
                mod.synth_trace("agent", 4, seed=1)
            wf = mod.LatencyWaterfall(window=8)
            wf.observe({{"decode": 0.5, "prefill_compute": 0.5}}, 1.0)
            assert wf.stats()["coverage"] == 1.0
            """
        ),
        why="capture ring + waterfall ledger fed from the decode hot path",
    ),
    # the port's codec ships torch tensors (JAX's ships numpy arrays): it
    # imports torch and numpy at module level by design, so both are
    # allowed here; the API, the models and gRPC stay out
    PurityEntry(
        key="migration",
        path="llm_mcp_tpu_torch/executor/migration.py",
        allow=("numpy", "torch", "llm_mcp_tpu_torch.utils.locks",
               "llm_mcp_tpu_torch.executor.memory"),
        stubs=_EXE,
        deps=("llm_mcp_tpu_torch/utils/locks.py",
              "llm_mcp_tpu_torch/executor/memory.py"),
        forbidden=_NO_JAX + ("grpc", "llm_mcp_tpu_torch.api",
                             "llm_mcp_tpu_torch.models"),
        exercise=textwrap.dedent(
            """
            import torch
            h, t = mod.decode_payload(mod.encode_payload(
                {{"x": 1}}, {{"k": torch.ones((1, 1, 1, 2, 1))}}))
            assert h == {{"x": 1}} and tuple(t["k"].shape) == (1, 1, 1, 2, 1)
            """
        ),
        why="the wire codec runs on worker hosts; torch + numpy, no API",
    ),
    # the dispatch plane's step vocabulary and channel: the standard
    # library alone (it reads torch.distributed lazily, for the world size)
    PurityEntry(
        key="dispatch",
        path="llm_mcp_tpu_torch/executor/dispatch.py",
        stubs=_EXE,
        exercise=textwrap.dedent(
            """
            assert len(mod.DISPATCH_OPS) == 19 and not mod.LocalArraysBackend.spmd
            class OnCard:
                is_cuda = True
            try:
                mod.check_host_payload(({{"k": OnCard()}},))
            except TypeError:
                pass
            else:
                raise AssertionError("a CUDA payload passed")
            """
        ),
        why="the follower's replay loop and the payload check weigh nothing",
    ),
    PurityEntry(
        key="memory",
        path="llm_mcp_tpu_torch/executor/memory.py",
        allow=("llm_mcp_tpu_torch.utils.locks",),
        stubs=_EXE,
        deps=("llm_mcp_tpu_torch/utils/locks.py",),
        forbidden=_NO_JAX + ("grpc", "torch", "numpy"),
        exercise=textwrap.dedent(
            """
            pool = mod.KVPool(max_slots=2, max_seq_len=8, bytes_per_slot=64)
            assert pool.admit_ok(0.0) and pool.hbm_bytes() == 128
            """
        ),
        why="host-side HBM bookkeeping imported by the migration codec",
    ),
    PurityEntry(
        key="drafter",
        path="llm_mcp_tpu_torch/executor/drafter.py",
        stubs=("llm_mcp_tpu_torch", "llm_mcp_tpu_torch.executor"),
        exercise=textwrap.dedent(
            """
            assert mod.NGramDrafter(2, 3).draft(4) == []
            """
        ),
        why="runs on the engine host thread",
    ),
    PurityEntry(
        key="cn-grammar",
        path="llm_mcp_tpu_torch/constrain/grammar.py",
        stubs=("llm_mcp_tpu_torch", "llm_mcp_tpu_torch.constrain"),
        exercise=textwrap.dedent(
            """
            rules, start = mod.regex_to_grammar("a(b|c){{2}}")
            a = mod.ByteAutomaton(rules, start)
            s = a.step_bytes(a.start_state, b"abc")
            assert s >= 0 and a.accepting(s)
            assert a.step(a.start_state, ord("z")) == -1
            """
        ),
        why="constraint compilation runs on API + engine host threads",
    ),
    PurityEntry(
        key="cn-masks",
        path="llm_mcp_tpu_torch/constrain/masks.py",
        allow=("numpy", "llm_mcp_tpu_torch.constrain.grammar",
               "llm_mcp_tpu_torch.constrain.schema"),
        stubs=("llm_mcp_tpu_torch", "llm_mcp_tpu_torch.constrain"),
        deps=("llm_mcp_tpu_torch/constrain/grammar.py",
              "llm_mcp_tpu_torch/constrain/schema.py"),
        forbidden=_NO_JAX + ("torch", "llm_mcp_tpu_torch.executor",
                             "llm_mcp_tpu_torch.api"),
        exercise=textwrap.dedent(
            """
            class Tok:
                vocab_size = 259
                pad_id, bos_id, eos_id = 0, 1, 2
                OFFSET = 3
            cc = mod.ConstraintCompiler(Tok(), 259, cache_size=2)
            sa = cc.make({{"type": "choice", "choices": ["ab", "cd"]}})
            legal = [t for t in range(259) if sa.allows(t)]
            assert legal == [3 + ord("a"), 3 + ord("c")], legal
            assert sa.advance(3 + ord("a")) and sa.advance(3 + ord("b"))
            assert sa.accepting and sa.allows(2)
            assert cc.stats()["misses"] == 1
            """
        ),
        why="mask lift is host-only; the device sees packed words alone",
    ),
    PurityEntry(
        key="locks",
        path="llm_mcp_tpu_torch/utils/locks.py",
        stubs=("llm_mcp_tpu_torch", "llm_mcp_tpu_torch.utils"),
        forbidden=_NO_JAX + ("torch", "numpy", "grpc"),
        exercise=textwrap.dedent(
            """
            lo = mod.OrderedLock("a", 1)
            hi = mod.OrderedLock("b", 2)
            with lo:
                with hi:
                    pass
            try:
                with hi:
                    with lo:
                        raise AssertionError("rank check dead")
            except mod.LockOrderError:
                pass
            """
        ),
        why="the rank discipline itself must import nothing",
    ),
)


def manifest_entry(key: str) -> PurityEntry:
    for e in PURITY_MANIFEST:
        if e.key == key:
            return e
    raise KeyError(f"no purity-manifest entry {key!r}")


def in_package(name: str, packages: tuple[str, ...]) -> str | None:
    """The package of `packages` that module `name` belongs to, if any
    (equal, or a dotted child: `jax.numpy` is in `jax`, `jaxlib` is not)."""
    for p in packages:
        if name == p or name.startswith(p + "."):
            return p
    return None


# -- static half -------------------------------------------------------------


def _module_level_imports(tree: ast.Module) -> list[tuple[str, int]]:
    """(absolute-ish import name, line) for imports that execute at module
    import time — module body plus any non-function nesting (if/try)."""
    out: list[tuple[str, int]] = []

    def visit(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(node, ast.Import):
                out.extend((a.name, node.lineno) for a in node.names)
            elif isinstance(node, ast.ImportFrom):
                # the module itself; its names are attributes or allowed
                # submodules of it
                out.append((_import_names(node)[0], node.lineno))
            elif isinstance(node, (ast.If, ast.Try, ast.With)):
                for attr in ("body", "orelse", "finalbody"):
                    visit(getattr(node, attr, []))
                for h in getattr(node, "handlers", []):
                    visit(h.body)
            elif isinstance(node, ast.ClassDef):
                visit(node.body)

    visit(tree.body)
    return out


def _import_names(node: ast.Import | ast.ImportFrom) -> list[str]:
    """The modules an import statement may load: `import a.b` -> a.b;
    `from m import x` -> m, then m.x (x may be a submodule); relative
    names keep their leading dots."""
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    base = "." * node.level + (node.module or "")
    sep = "" if base.endswith(".") or not base else "."
    return [base] + [f"{base}{sep}{a.name}" for a in node.names
                     if a.name != "*"]


def _absolutize(name: str, module_relpath: str) -> str:
    """Resolve a leading-dots relative import against the module's
    package path (llm_mcp_tpu_torch/executor/migration.py + '..utils.locks'
    -> llm_mcp_tpu_torch.utils.locks)."""
    if not name.startswith("."):
        return name
    level = len(name) - len(name.lstrip("."))
    pkg_parts = module_relpath.replace("\\", "/").split("/")[:-1]
    base = pkg_parts[: len(pkg_parts) - (level - 1)]
    tail = name.lstrip(".")
    return ".".join(base + ([tail] if tail else []))


def _stdlib_names() -> frozenset[str]:
    return getattr(sys, "stdlib_module_names", frozenset())


def all_imports(tree: ast.Module, relpath: str) -> list[tuple[str, int]]:
    """Every module an import at any depth may load, absolutized, with
    `importlib.import_module("x")` / `__import__("x")` of a literal."""
    out: list[tuple[str, int]] = []
    for node in all_nodes(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            out.extend((_absolutize(n, relpath), node.lineno)
                       for n in _import_names(node))
        elif (
            isinstance(node, ast.Call)
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
            and (
                (isinstance(node.func, ast.Attribute)
                 and node.func.attr == "import_module")
                or (isinstance(node.func, ast.Name)
                    and node.func.id in ("import_module", "__import__"))
            )
        ):
            out.append((node.args[0].value, node.lineno))
    return out


class ImportPurityPass:
    pass_id = PASS_ID

    def __init__(
        self,
        manifest: tuple[PurityEntry, ...] = PURITY_MANIFEST,
        forbidden: tuple[str, ...] = FORBIDDEN_EVERYWHERE,
    ):
        self.manifest = manifest
        self.forbidden = forbidden

    def run(self, index: RepoIndex) -> list[Finding]:
        return self._pins(index) + self._everywhere(index)

    def _pins(self, index: RepoIndex) -> list[Finding]:
        findings: list[Finding] = []
        stdlib = _stdlib_names()
        for entry in self.manifest:
            tree = index.ast(entry.path)
            if tree is None:
                findings.append(
                    Finding(
                        PASS_ID, entry.path, 0,
                        f"pinned-module-missing:{entry.key}",
                        f"purity-pinned module {entry.path} "
                        f"({entry.key}) does not exist — update "
                        "PURITY_MANIFEST",
                    )
                )
                continue
            for name, line in _module_level_imports(tree):
                absname = _absolutize(name, entry.path)
                top = absname.split(".")[0]
                if top == "__future__" or top in stdlib:
                    continue
                if any(
                    absname == a or absname.startswith(a + ".")
                    or a.startswith(absname + ".")
                    for a in entry.allow
                ):
                    continue
                pinned = ("stdlib-only" if not entry.allow
                          else "to stdlib + " + ", ".join(entry.allow))
                findings.append(
                    Finding(
                        PASS_ID, entry.path, line,
                        f"impure-import:{entry.key}:{absname}",
                        f"{entry.path} is pinned {pinned} ({entry.why}) but "
                        f"imports {absname!r} at module level — make it "
                        "lazy or amend the manifest",
                    )
                )
        return findings

    def _everywhere(self, index: RepoIndex) -> list[Finding]:
        files = list(index.package_files())
        for extra in index.config.get("import_extra_roots", ()):
            files.extend(index.files_under(extra))
        findings: list[Finding] = []
        for relpath in files:
            tree = index.ast(relpath)
            if tree is None:
                continue
            seen: set[str] = set()
            for name, line in all_imports(tree, relpath):
                pkg = in_package(name, self.forbidden)
                if pkg is None or name in seen:
                    continue
                seen.add(name)
                findings.append(
                    Finding(
                        PASS_ID, relpath, line,
                        f"forbidden-import:{relpath}:{name}",
                        f"{relpath} imports {name!r} ({pkg} is never "
                        "imported by the port, at any depth: the card's "
                        "machine has no JAX, and the port keeps its own "
                        "copy of what it needs)",
                    )
                )
        return findings


# -- runtime half (one subprocess an entry in tests) -------------------------

_PROBE_TEMPLATE = """
import importlib.util, sys, types
for pkg in {stubs!r}:
    m = types.ModuleType(pkg)
    m.__path__ = []
    sys.modules[pkg] = m
mod = None
for name, path in {loads!r}:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
{exercise}
forbidden = {forbidden!r}
bad = sorted(m for m in sys.modules
             if any(m == p or m.startswith(p + ".") for p in forbidden))
sys.exit("%s pulled in: %s" % ({key!r}, bad) if bad else 0)
"""


def probe_code(key: str, repo_root: str, tmp: str = "") -> str:
    """The subprocess source for a manifest entry's runtime probe."""
    entry = manifest_entry(key)

    def modname(relpath: str) -> str:
        return relpath[:-3].replace("/", ".")

    loads = [
        (modname(dep), os.path.join(repo_root, dep)) for dep in entry.deps
    ]
    loads.append((modname(entry.path), os.path.join(repo_root, entry.path)))
    return _PROBE_TEMPLATE.format(
        stubs=tuple(entry.stubs),
        loads=loads,
        exercise=entry.exercise.format(tmp=tmp).strip(),
        forbidden=tuple(entry.forbidden),
        key=key,
    )


def run_probe(
    key: str, repo_root: str, tmp: str = "", timeout: float = 120.0
) -> subprocess.CompletedProcess:
    """Run a manifest entry's runtime import probe in a subprocess.

    Returns the CompletedProcess; rc 0 means the module loaded by file
    path, passed its exercise snippet, and pulled in nothing forbidden."""
    return subprocess.run(
        [sys.executable, "-c", probe_code(key, repo_root, tmp)],
        capture_output=True, text=True, timeout=timeout,
    )
