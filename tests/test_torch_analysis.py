"""The port's llmtpu-lint suite (`llm_mcp_tpu_torch/analysis/`): the same
fixtures through JAX's suite and the port's give the same finding keys,
each port-only pass fires exactly once on its known-bad fixture, and the
real tree is clean, with its README tables round-tripping.

Fixtures are tiny tmp-dir repos: every path a pass reads comes from its
config, so each case points both suites at the same files and compares
symbolic `(pass_id, key)` sets, never line numbers. CPU only, no card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import pytest

from llm_mcp_tpu.analysis import core as jcore
from llm_mcp_tpu.analysis.imports_lint import ImportPurityPass as JImportPurity
from llm_mcp_tpu.analysis.imports_lint import PurityEntry as JPurityEntry
from llm_mcp_tpu.analysis.knobs import KnobRegistryPass as JKnobs
from llm_mcp_tpu.analysis.lock_order import LockOrderPass as JLockOrder
from llm_mcp_tpu_torch.analysis import core
from llm_mcp_tpu_torch.analysis.census import RegistryCensusPass, exported_entries
from llm_mcp_tpu_torch.analysis.donation import DonationSafetyPass
from llm_mcp_tpu_torch.analysis.imports_lint import (
    PURITY_MANIFEST,
    ImportPurityPass,
    PurityEntry,
    all_imports,
    run_probe,
)
from llm_mcp_tpu_torch.analysis.knobs import KnobRegistryPass, doc_rows, extract_registry
from llm_mcp_tpu_torch.analysis.lock_order import (
    TABLE_BEGIN,
    TABLE_END,
    LockOrderPass,
    parse_doc_table,
    rank_map,
    render_table,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PASS_IDS = {"lock-order", "donation", "knob-registry", "import-purity", "registry-census",
            "dispatch-surface"}


def _mini_repo(tmp_path, files: dict[str, str]) -> str:
    for rel, body in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(body))
    return str(tmp_path)


def _keys(findings) -> set[tuple[str, str]]:
    return {(f.pass_id, f.key) for f in findings}


# ---------------------------------------------------------------------------
# shared fixtures: JAX's suite and the port's agree key for key
# ---------------------------------------------------------------------------

_LOCK_DOC = {"package": "pkg", "doc_concurrency": "doc.md"}
_KNOB_DOC = {"package": "pkg", "doc_readme": "doc.md", "knob_extra_roots": []}
_PIN = dict(key="fixture", path="pkg/pinned.py", allow=("pkg.sibling",), why="fixture pin")

SHARED = {
    "lock_inversion": (
        {
            "pkg/mod.py": """
                from .locks import OrderedLock

                STATS = OrderedLock("stats", 20)
                POOL = OrderedLock("pool", 10)

                def bad_path():
                    with STATS:
                        with POOL:  # rank 10 under rank 20: inversion
                            pass
            """,
            "doc.md": "| rank | lock |\n| --- | --- |\n| 10 | `pool` |\n| 20 | `stats` |\n",
        },
        lambda: JLockOrder(), lambda: LockOrderPass(), _LOCK_DOC,
        {("lock-order", "nest:stats<-pool@pkg/mod.py::bad_path")},
    ),
    "lock_transitive": (
        {
            "pkg/mod.py": """
                STATS = OrderedLock("stats", 20)
                POOL = OrderedLock("pool", 10)

                def helper():
                    with POOL:
                        pass

                def bad_path():
                    with STATS:
                        helper()
            """,
            "doc.md": "| 10 | `pool` |\n| 20 | `stats` |\n",
        },
        lambda: JLockOrder(), lambda: LockOrderPass(), _LOCK_DOC,
        {("lock-order", "call-nest:stats<-pool@pkg/mod.py::bad_path->pkg/mod.py::helper")},
    ),
    "lock_doc_drift": (
        {"pkg/mod.py": 'L = OrderedLock("only", 10)\n', "doc.md": "| 30 | `only` |\n"},
        lambda: JLockOrder(), lambda: LockOrderPass(), _LOCK_DOC,
        {("lock-order", "doc-rank-drift:only:30!=10")},
    ),
    "knobs_undocumented_and_dead": (
        {
            "pkg/mod.py": """
                import os

                def knobs():
                    return os.environ.get("TPU_FIXTURE_KNOB", "1")
            """,
            "doc.md": """
                | Var | Default | Meaning |
                |---|---|---|
                | `TPU_GHOST_KNOB` | `0` | documented but never read |

                Prose mentioning `TPU_PROSE_ONLY` must not count as a row.
            """,
        },
        lambda: JKnobs(), lambda: KnobRegistryPass(), _KNOB_DOC,
        {("knob-registry", "dead-doc:TPU_GHOST_KNOB"),
         ("knob-registry", "undocumented:TPU_FIXTURE_KNOB")},
    ),
    "non_stdlib_import": (
        {
            "pkg/pinned.py": """
                import os
                import requests  # not stdlib, not allowed

                from .sibling import helper  # resolves inside the allow set
            """,
            "pkg/sibling.py": "def helper():\n    pass\n",
        },
        lambda: JImportPurity(manifest=(JPurityEntry(**_PIN),)),
        lambda: ImportPurityPass(manifest=(PurityEntry(**_PIN),)),
        {"package": "pkg"},
        {("import-purity", "impure-import:fixture:requests")},
    ),
}


@pytest.mark.parametrize("case", sorted(SHARED))
def test_shared_fixture_keys_match_jax(tmp_path, case):
    files, jax_pass, port_pass, config, want = SHARED[case]
    root = _mini_repo(tmp_path, files)
    jax_keys = _keys(jax_pass().run(jcore.RepoIndex(root, config)))
    # the port reads README.md's port section by default; the fixture doc
    # is a whole file, as JAX's
    port_keys = _keys(port_pass().run(core.RepoIndex(root, {**config, "doc_section": ""})))
    assert jax_keys == want
    assert port_keys == jax_keys


_BASELINES = {
    "new": "",
    "baselined": "lock-order nest:b<-a@pkg/mod.py::f  # fixture\n",
    "stale": ("lock-order nest:b<-a@pkg/mod.py::f  # fixture\n"
              "donation read-after-donate:gone@f<-_fn  # paid off\n"),
    "malformed": "garbage\n",
}


@pytest.mark.parametrize("case", sorted(_BASELINES))
def test_baseline_split_matches_jax(tmp_path, case):
    """new / baselined / stale / malformed: the same split, the same ok."""
    root = _mini_repo(tmp_path, {
        "pkg/mod.py": """
            A = OrderedLock("a", 10)
            B = OrderedLock("b", 20)

            def f():
                with B:
                    with A:
                        pass
        """,
        "doc.md": "| 10 | `a` |\n| 20 | `b` |\n",
    })

    def split(mod, pass_):
        res = mod.run_suite(root, passes=[pass_], config={**_LOCK_DOC, "doc_section": ""},
                            baseline_text=_BASELINES[case])
        return (res.ok, _keys(res.new), _keys(res.baselined),
                {(e.pass_id, e.key) for e in res.stale_baseline}, res.baseline_error is None)

    assert split(core, LockOrderPass()) == split(jcore, JLockOrder())
    ok, new, baselined, stale, parsed = split(core, LockOrderPass())
    assert ok == (case != "new" and case != "malformed") and parsed == (case != "malformed")
    assert len(stale) == (case == "stale")


@pytest.mark.parametrize("text", [
    "lock-order nest:a<-b@f\n",
    "# comment\n\nlock-order nest:a<-b@f  # why we accept it\n",
])
def test_baseline_requires_justification_as_jax(text):
    def parse(mod):
        try:
            return [(e.pass_id, e.key, e.justification, e.line) for e in mod.parse_baseline(text)]
        except ValueError as e:
            return "justification" in str(e)

    assert parse(core) == parse(jcore)
    assert parse(core) in (True, [("lock-order", "nest:a<-b@f", "why we accept it", 3)])


# ---------------------------------------------------------------------------
# port-only fixtures: each fires exactly once
# ---------------------------------------------------------------------------

_CENSUS_CONFIG = {
    "package": "pkg",
    "kernel_module": "pkg/kernels/attention.py",
    "csrc_dir": "pkg/kernels/csrc",
    "pallas_module": "ref/attention.py",
    "parity_registry": "tests/test_parity.py",
    "smoke_module": "smoke.py",
    "engine_module": "pkg/engine.py",
    "perf_module": "pkg/perf.py",
    "recorder_module": "pkg/recorder.py",
}
# a clean census: one entry point standing for one Pallas body, bound, on a
# card-script row, with its tests; one dispatch phase; one flight etype
_CENSUS_BASE = {
    "pkg/kernels/csrc/k.cu": 'extern "C" int k_bf16(const void* q, int n, void* stream) {}\n',
    "pkg/kernels/attention.py": """
        _P = object()
        _SIGNATURES = {"k_bf16": ("k", [_P] * 3)}
    """,
    "ref/attention.py": "def _k_kernel(refs):\n    pass\n",
    "tests/test_parity.py": """
        CARD = "tests/test_card.py"
        PORT_PARITY = {
            **{name: (("_k_kernel",), ("tests/test_cpu.py", "test_k"), "test_card_k")
               for name in ("k_bf16",)},
        }
    """,
    "tests/test_cpu.py": "def test_k():\n    pass\n",
    "tests/test_card.py": "def test_card_k():\n    pass\n",
    "smoke.py": """
        _C = "pkg/kernels/csrc/"
        SOURCES = {f"k_row{s}": (_C + "k.cu", "ref/attention.py:1", "k_bf16") for s in ("", "_2")}
        FAMILY_ROWS = {}
        HD64_ROWS = {}
    """,
    "pkg/perf.py": """
        DISPATCH_PHASES = ("decode",)
        AUX_COMPILE_PHASES = ("build",)
        PHASE_COSTS = {"decode": None}
    """,
    "pkg/engine.py": textwrap.dedent("""
        class Engine:
            def step(self, group):
                phase = "decode" if group is None else "decode"
                self._first_use(phase, (1,), print)
                self._flight.event("decode", rows=1)
    """),
    "pkg/recorder.py": (
        '"""etypes: decode / pf_rag / fused_rag / perf / wl / wf / zoo / swap_in / '
        'swap_out / cn_cmp / cnstep / cn_spec."""\n'
    ),
}

PORT_ONLY = {
    "unregistered_extern": (
        lambda: RegistryCensusPass(), _CENSUS_CONFIG,
        {"pkg/kernels/csrc/k.cu": _CENSUS_BASE["pkg/kernels/csrc/k.cu"]
         + 'extern "C" int k_new(const void* q, void* stream) {}\n'},
        "entry-unregistered:k_new"),
    "parity_entry_without_signature": (
        lambda: RegistryCensusPass(), _CENSUS_CONFIG,
        {"pkg/kernels/attention.py": "_SIGNATURES = {}\n"},
        "signature-missing:k_bf16"),
    "pallas_body_no_entry_names": (
        lambda: RegistryCensusPass(), _CENSUS_CONFIG,
        {"ref/attention.py": "def _k_kernel(refs):\n    pass\n\n\ndef _new_kernel(refs):\n"
                             "    pass\n"},
        "kernel-unregistered:_new_kernel"),
    "engine_phase_unregistered": (
        lambda: RegistryCensusPass(), _CENSUS_CONFIG,
        {"pkg/engine.py": _CENSUS_BASE["pkg/engine.py"]
         + "\n    def other(self):\n        self._note_exec_shape('zap', 1)\n"},
        "phase-unregistered:zap"),
    "etype_uncensused": (
        lambda: RegistryCensusPass(), _CENSUS_CONFIG,
        {"pkg/engine.py": _CENSUS_BASE["pkg/engine.py"]
         + "\n    def other(self, ok):\n        kind = 'zip' if ok else 'decode'\n"
           "        self._flight.event(kind)\n"},
        "etype-uncensused:zip"),
    "lazy_jax_import": (
        lambda: ImportPurityPass(manifest=()), {"package": "pkg", "import_extra_roots": []},
        {"pkg/mod.py": """
            import os

            def late():
                import jax.numpy as jnp  # inside a function: still forbidden
                return jnp
         """,
         "pkg/ok.py": "from . import h2  # the port's own module, not the h2 package\n"},
        "forbidden-import:pkg/mod.py:jax.numpy"),
    "module_level_cuda": (
        lambda: DonationSafetyPass(), {"package": "pkg", "import_extra_roots": []},
        {"pkg/mod.py": """
            import torch

            STREAM = torch.cuda.Stream()  # initialises CUDA on import

            def fine(device):
                return torch.zeros(2, device=device).to("cuda")
         """},
        "import-time-cuda:pkg/mod.py:torch.cuda.Stream"),
    "static_output_after_next_replay": (
        lambda: DonationSafetyPass(), {"package": "pkg", "import_extra_roots": []},
        {"pkg/engine.py": """
            class Engine:
                def __init__(self, dev):
                    self._graphs = RoundGraphs(dev, None) if dev else None

                def bad(self, f, x, y):
                    a = self._graphs.run((1,), f, (x,))
                    b = self._graphs.run((1,), f, (y,))
                    return a + b  # a was overwritten by the second replay

                def good(self, f, x, host):
                    out = self._round(f, x)
                    host.copy_(out, non_blocking=True)
                    return host

                def _round(self, f, x):
                    out = self._graphs.run((1,), f, (x,))
                    return out  # private: its caller copies it out
         """},
        "static-read-after-replay:a@bad"),
}


@pytest.mark.parametrize("case", sorted(PORT_ONLY))
def test_port_pass_fires_once(tmp_path, case):
    make, config, files, key = PORT_ONLY[case]
    base = _CENSUS_BASE if config is _CENSUS_CONFIG else {}
    clean = make().run(core.RepoIndex(_mini_repo(tmp_path / "clean", base), config))
    assert clean == []
    root = _mini_repo(tmp_path / "bad", {**base, **files})
    assert [f.key for f in make().run(core.RepoIndex(root, config))] == [key]


def test_static_output_escapes_are_findings(tmp_path):
    """Stored on self, put in a container, returned from a public function,
    as a view: each is a finding; a copy and a private return are not."""
    root = _mini_repo(tmp_path, {"pkg/engine.py": """
        class Engine:
            def __init__(self, dev):
                self._graphs = RoundGraphs(dev, None)

            def keep(self, f, x):
                out = self._graphs.run((1,), f, (x,))
                self.last = out[0]

            def pile(self, f, x, acc):
                out = self._graphs.run((1,), f, (x,))
                acc.append(out.view(-1))

            def public(self, f, x):
                out = self._graphs.run((1,), f, (x,))
                return out

            def copied(self, f, x):
                out = self._graphs.run((1,), f, (x,))
                self.last = out.clone()
                return out + 1
    """})
    keys = sorted(f.key for f in DonationSafetyPass().run(core.RepoIndex(root, {
        "package": "pkg", "import_extra_roots": []})))
    assert keys == ["static-escape:out@keep", "static-escape:out@pile",
                    "static-escape:out@public"]


def test_exported_entries_reads_nm():
    nm = textwrap.dedent("""
        0000000000003a10 T append_kv_bf16
        0000000000003b20 T _Z17append_kv_kernelPv
        0000000000001000 T _init
        0000000000004000 T __cudaRegisterLinkedBinary_x
        0000000000005000 B q8_arrivals
        0000000000006000 W _ZN4cuda3stdE
        0000000000007000 T decode_attend_q8
    """)
    assert exported_entries(nm) == {"append_kv_bf16", "decode_attend_q8"}


# ---------------------------------------------------------------------------
# the real tree
# ---------------------------------------------------------------------------


def test_suite_clean_on_real_tree():
    res = core.run_suite(REPO)
    assert res.ok, "\n".join(
        f"{f.pass_id} {f.path}:{f.line} {f.key}: {f.message}" for f in res.new
    ) or res.baseline_error
    assert not res.stale_baseline, [e.fingerprint for e in res.stale_baseline]
    assert {r.pass_id for r in res.results} == PASS_IDS
    assert all(e.justification for e in core.parse_baseline(
        open(os.path.join(REPO, core.BASELINE_PATH)).read()))
    assert res.seconds < 30.0


# the CLI as a user runs it, with torch, numpy, JAX and the JAX package
# unimportable: the suite needs the standard library alone
_CLI = textwrap.dedent("""
    import runpy, sys
    for name in ("torch", "numpy", "jax", "jaxlib", "llm_mcp_tpu"):
        sys.modules[name] = None
    sys.argv = ["analysis"] + sys.argv[1:]
    try:
        runpy.run_module("llm_mcp_tpu_torch.analysis", run_name="__main__")
    except SystemExit as e:
        port = sorted(m for m in sys.modules if m.startswith("llm_mcp_tpu_torch.")
                      and not m.startswith("llm_mcp_tpu_torch.analysis"))
        print("LOADED", port, file=sys.stderr)
        raise
""")


def test_cli_json_carries_jax_v1_keys():
    proc = subprocess.run([sys.executable, "-c", _CLI, "--json"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr or proc.stdout
    assert "LOADED []" in proc.stderr, proc.stderr
    doc = json.loads(proc.stdout)
    jax_keys = set(jcore.SuiteResult([]).to_dict()) | {"knob_registry", "lock_ranks"}
    assert set(doc) == jax_keys
    assert doc["version"] == 1 and doc["ok"] is True
    assert {p["pass"] for p in doc["passes"]} == PASS_IDS
    assert len(doc["knob_registry"]) == 68  # TPU_MESH_SHAPE, TPU_SLICE_CMD_ADDR joined
    assert doc["lock_ranks"] == {"migration": 5, "engine.stats": 10, "kvpool": 20, "paging": 30}
    bad = subprocess.run([sys.executable, "-c", _CLI, "--bogus"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert bad.returncode == 2


# ---------------------------------------------------------------------------
# the dispatch-surface pass: clean on the port, and JAX's findings on a
# planted copy of the port's engine and dispatch module, key for key
# ---------------------------------------------------------------------------

_ENGINE = "llm_mcp_tpu_torch/executor/engine.py"
_DISPATCH = "llm_mcp_tpu_torch/executor/dispatch.py"
_DX_CONFIG = {"package": "llm_mcp_tpu_torch", "engine_module": _ENGINE,
              "dispatch_module": _DISPATCH}
_APPENDED = "\n\n    def _planted(self, op):\n        {}\n"
DX_PLANTS = {
    # DISPATCH_OPS loses "cow": dispatched unpublished, registered unpublished
    "op_missing_from_dispatch_ops": (
        {_DISPATCH: lambda s: s.replace('    "cow",      #', '    #', 1)},
        {"op-unpublished:cow", "op-unregistered:cow"}),
    # "cow" still registered and published, but its only site bypasses _dx
    "op_registered_never_dispatched": (
        {_ENGINE: lambda s: s.replace('self._dx("cow", ', 'self._ops["cow"](', 1)},
        {"op-undispatched:cow"}),
    "non_literal_dx": (
        {_ENGINE: lambda s: s + _APPENDED.format("return self._dx(op)")},
        {"dx-nonliteral-op"}),
    "cmdleader_outside_dispatch": (
        {"llm_mcp_tpu_torch/executor/rogue.py": lambda s: (
            "from .dispatch import CmdLeader\n\nLEAD = CmdLeader('127.0.0.1:0', 1)\n")},
        {"mirror-channel:CmdLeader:llm_mcp_tpu_torch/executor/rogue.py"}),
    "emit_outside_dx": (
        {_ENGINE: lambda s: s + _APPENDED.format("self._backend.emit(op, ())")},
        {"emit-outside-funnel:emit:_planted"}),
}


def _dx_tree(tmp_path, edits: dict) -> str:
    files = {}
    for rel in (_ENGINE, _DISPATCH):
        files[rel] = open(os.path.join(REPO, rel)).read()
    for rel, edit in edits.items():
        files[rel] = edit(files.get(rel, ""))
    for rel, body in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(body)
    return str(tmp_path)


@pytest.mark.parametrize("case", sorted(DX_PLANTS))
def test_dispatch_surface_finds_jax_findings_on_a_planted_engine(tmp_path, case):
    from llm_mcp_tpu.analysis.dispatch_surface import DispatchSurfacePass as JDispatch
    from llm_mcp_tpu_torch.analysis.dispatch_surface import DispatchSurfacePass

    clean = _dx_tree(tmp_path / "clean", {})
    assert DispatchSurfacePass().run(core.RepoIndex(clean, _DX_CONFIG)) == []
    edits, want = DX_PLANTS[case]
    root = _dx_tree(tmp_path / "bad", edits)
    got = {f.key for f in DispatchSurfacePass().run(core.RepoIndex(root, _DX_CONFIG))}
    jax_got = {f.key for f in JDispatch().run(jcore.RepoIndex(root, _DX_CONFIG))}
    assert got == jax_got == want


def test_dispatch_surface_clean_on_the_port(real_index):
    from llm_mcp_tpu_torch.analysis.dispatch_surface import DispatchSurfacePass

    assert DispatchSurfacePass().run(real_index) == []
    assert real_index.config["dispatch_module"] == _DISPATCH


@pytest.fixture(scope="module")
def real_index():
    return core.RepoIndex(REPO)


def test_readme_knob_table_roundtrips(real_index):
    """Every knob the port or chip_smoke.py reads has a row in README.md's
    port section and every row is read; rows outside the section are not
    the port's."""
    index = real_index
    registry = extract_registry(index)
    rows = doc_rows(index.doc_text("doc_readme"), ("TPU_", "LLM_MCP_TPU_"))
    assert set(rows) == set(registry)
    for name in ("TPU_PEAK_TFLOPS", "TPU_PEAK_HBM_GBPS", "TPU_KV_BLOCK_TOKENS", "TPU_SPEC"):
        assert name in rows, name


def test_readme_lock_table_roundtrips(real_index):
    index = real_index
    text = index.doc_text("doc_concurrency")
    assert parse_doc_table(text) == rank_map(index) == {
        "migration": 5, "engine.stats": 10, "kvpool": 20, "paging": 30}
    block = text[text.index(TABLE_BEGIN):text.index(TABLE_END)]
    assert block.split("\n", 1)[1].strip() == render_table(index)


def test_analysis_imports_only_the_standard_library(real_index):
    """Every import in the suite's own modules, at any depth, is the
    standard library's or the suite's own (the CLI test runs it with torch,
    numpy and JAX unimportable)."""
    stdlib = sys.stdlib_module_names
    files = real_index.files_under("llm_mcp_tpu_torch/analysis")
    assert len(files) == 9, files  # dispatch_surface.py joined the eight
    for rel in files:
        for name, line in all_imports(real_index.ast(rel), rel):
            assert (name.split(".")[0] in stdlib
                    or name.startswith("llm_mcp_tpu_torch.analysis")), (rel, line, name)


@pytest.mark.parametrize("key", [e.key for e in PURITY_MANIFEST])
def test_purity_manifest_runtime_probes(key, tmp_path):
    proc = run_probe(key, REPO, str(tmp_path))
    assert proc.returncode == 0, proc.stderr or proc.stdout
