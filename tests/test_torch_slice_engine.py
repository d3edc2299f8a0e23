"""`SliceEngine`, the multi-rank serving engine of the port (counterpart of
the JAX package's `tests/test_slice_engine.py`), on the CPU.

JAX's cases run one process over a dp=4 x tp=2 virtual mesh; the port's
ranks are processes (or, here, threads with process groups of their own)
and dp is not ported yet, so the one-process cases run a one-rank mesh
and the others two tp ranks over `gloo`: greedy determinism and slot
churn beyond capacity, int8 weights (made, and from a checkpoint), the
strict quant-with-checkpoint error, capacity headroom near the end of the
cache, a dead loop failing its requests, stop strings and EOS. The last
case boots two processes of `python -m llm_mcp_tpu_torch.api` on one
mesh (JAX's process triplet, `TPU_MESH_SHAPE=tp=2`,
`TPU_SLICE_CMD_ADDR`): rank 0 serves `/v1/chat/completions` over SSE
through the core server, rank 1 replays and never binds HTTP, and both
exit 0 after SIGTERM to the leader.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import pytest
import torch

from llm_mcp_tpu_torch.executor import SliceEngine
from llm_mcp_tpu_torch.models.configs import get_config
from llm_mcp_tpu_torch.models.llama import init_llama_params
from llm_mcp_tpu_torch.models.weights import llama_to_hf_tensors, write_checkpoint_dir
from llm_mcp_tpu_torch.parallel.mesh import make_mesh
from test_torch_parallel import jax_tree, tp_engines

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _one(**kw) -> SliceEngine:
    """A leader with no follower: a one-rank mesh."""
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_seq_len", 128)
    return SliceEngine("tiny-llm", mesh=make_mesh("", device="cpu"), cmd_addr="127.0.0.1:0",
                       dtype=torch.float32, decode_chunk=4, device="cpu", **kw)


def test_slice_engine_single_process():
    """A leader with no follower is a working engine: greedy determinism,
    slot churn beyond capacity, usage accounting."""
    eng = _one(max_slots=8).start()
    try:
        assert eng.is_leader and eng.process_count == 1 and eng._spmd
        out = eng.generate("slice engine smoke", max_tokens=8, temperature=0.0)
        out2 = eng.generate("slice engine smoke", max_tokens=8, temperature=0.0)
        assert out["text"] == out2["text"]
        assert out["usage"]["completion_tokens"] == 8
        assert out["finish_reason"] == "length"
        results: list[dict] = []
        lock = threading.Lock()

        def run(i: int) -> None:
            r = eng.generate(f"concurrent request {i}", max_tokens=5, temperature=0.0)
            with lock:
                results.append(r)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        assert len(results) == 12
        assert all(r["usage"]["completion_tokens"] >= 1 for r in results)
        assert eng.total_errors == 0
        assert eng.slots_in_use() == 0
    finally:
        eng.shutdown()


def test_slice_engine_int8_weights():
    """quant="int8": one rank keeps the single-device fused layout; two tp
    ranks hold their unfused int8 slices (JAX's rule under a mesh), the
    row-split ones with the whole tree's scales."""
    eng = _one(quant="int8").start()
    try:
        out = eng.generate("int8 slice", max_tokens=6, temperature=0.0)
        assert out["usage"]["completion_tokens"] == 6
        assert out == eng.generate("int8 slice", max_tokens=6, temperature=0.0)
        assert isinstance(eng.params["layers"]["wqkv"], dict)
    finally:
        eng.shutdown()
    _, tree = jax_tree(True)
    with tp_engines("tiny-llm", tree, engine_cls=SliceEngine, dtype=torch.float32,
                    max_slots=4, max_seq_len=128, quant="int8") as (lead, fol):
        wq, wo = lead.params["layers"]["wq"], fol.params["layers"]["wo"]
        assert wq["q"].dtype == torch.int8 and wq["q"].shape[-1] == tree["layers"]["wq"]["q"].shape[-1] // 2
        assert wo["q"].shape[-2] == tree["layers"]["wo"]["q"].shape[-2] // 2
        assert torch.equal(wo["s"], tree["layers"]["wo"]["s"])
        out = lead.generate("int8 slice", max_tokens=6, temperature=0.0)
        assert out["usage"]["completion_tokens"] == 6


def _checkpoint(tmp_path) -> str:
    cfg = get_config("tiny-llm")
    tree = init_llama_params(cfg, torch.Generator().manual_seed(3), torch.float32)
    write_checkpoint_dir(str(tmp_path), llama_to_hf_tensors(cfg, tree), shards=1, config={
        "model_type": "llama", "vocab_size": 512, "hidden_size": 128, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2, "intermediate_size": 256,
        "rope_theta": 10000.0, "tie_word_embeddings": True})
    return str(tmp_path)


def test_slice_engine_int8_from_checkpoint(tmp_path):
    eng = _one(quant="int8", weights_dir=_checkpoint(tmp_path)).start()
    try:
        assert eng.params["layers"]["wqkv"]["q"].dtype == torch.int8
        out = eng.generate("int8 checkpoint slice", max_tokens=6, temperature=0.0)
        assert out["usage"]["completion_tokens"] == 6
        assert out == eng.generate("int8 checkpoint slice", max_tokens=6, temperature=0.0)
    finally:
        eng.shutdown()


def test_slice_engine_unknown_quant_with_checkpoint_fails_loud(tmp_path):
    with pytest.raises(NotImplementedError, match="quant"):
        _one(quant="int4", weights_dir=_checkpoint(tmp_path))


def test_slice_engine_capacity_headroom():
    """Near the cache's end the engine finishes with "length" before a
    round would write past it; an over-long prompt keeps its tail."""
    K = 8
    _, tree = jax_tree(False)
    with tp_engines("tiny-llm", tree, engine_cls=SliceEngine, dtype=torch.float32,
                    max_slots=4, max_seq_len=64, decode_chunk=K) as (lead, _):
        prompt = "z" * 300  # the byte tokenizer: far past the 64-token cache
        out = lead.generate(prompt, max_tokens=500, temperature=0.0)
        assert out["finish_reason"] == "length"
        assert out["usage"]["prompt_tokens"] == 64 - K
        assert out["usage"]["prompt_tokens"] + out["usage"]["completion_tokens"] <= 64
        assert out["usage"]["completion_tokens"] >= 1
        assert len(lead.tokenizer.encode(prompt)) > 64


def test_slice_engine_dead_loop_fails_requests():
    """A failed dispatch kills the engine: the queued request and every
    later one fail instead of hanging, and the followers get stop."""
    eng = _one(max_seq_len=64).start()
    try:
        def boom(*a, **k):
            raise RuntimeError("injected dispatch failure")

        eng._ops["admit"] = boom
        with pytest.raises(RuntimeError, match="injected|engine dead"):
            eng.generate("kill it", max_tokens=4)
        deadline = time.time() + 10
        while not eng.dead and time.time() < deadline:
            time.sleep(0.05)
        assert eng.dead
        with pytest.raises(RuntimeError, match="engine dead"):
            eng.generate("after death", max_tokens=4)
        assert eng.total_errors >= 1
    finally:
        eng.shutdown()


def test_slice_engine_stop_strings_and_eos():
    _, tree = jax_tree(False)
    with tp_engines("tiny-llm", tree, engine_cls=SliceEngine, dtype=torch.float32,
                    max_slots=4, max_seq_len=128) as (lead, _):
        events = list(lead.generate_stream("abc", max_tokens=6, temperature=0.0))
        assert events[-1]["type"] == "done"
        toks = [e for e in events if e["type"] == "token"]
        assert events[-1]["usage"]["completion_tokens"] <= 6
        if toks:  # stop on the first emitted character
            first_char = toks[0]["text"][0]
            out = lead.generate("abc", max_tokens=6, temperature=0.0, stop=[first_char])
            assert out["finish_reason"] == "stop"
            assert first_char not in out["text"]


# the API's boot with the slice metadata source pointed at a closed local
# port (a core's discovery would otherwise ask metadata.google.internal)
_BOOT = """
import sys
from llm_mcp_tpu_torch.discovery import slices
slices.METADATA_BASE = "http://127.0.0.1:9/computeMetadata/v1"
from llm_mcp_tpu_torch.api.__main__ import main
main(sys.argv[1:])
print("RANK EXIT OK", flush=True)
"""


def test_two_process_slice_serves_sse_through_core(tmp_path):
    coord, cmd, http = _free_port(), _free_port(), _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=REPO, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{coord}",
                   JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(rank), TPU_MESH_SHAPE="tp=2",
                   TPU_SLICE_CMD_ADDR=f"127.0.0.1:{cmd}", CORE_GRPC_ADDR="127.0.0.1:0",
                   CORE_HTTP_ADDR=f"127.0.0.1:{http}", DB_PATH=str(tmp_path / f"c{rank}.db"),
                   DISCOVERY_INTERVAL="100000", TPU_WARMUP="0")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _BOOT, "--device", "cpu", "--model", "tiny-llm",
             "--embed-model", "tiny-embed", "--max-seq-len", "128", "--max-slots", "4"],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    base = f"http://127.0.0.1:{http}"
    try:
        deadline, health = time.time() + 120, None
        while time.time() < deadline and procs[0].poll() is None:
            try:
                with urllib.request.urlopen(base + "/health", timeout=5) as r:
                    health = json.loads(r.read())
                break
            except OSError:
                time.sleep(0.2)
        assert health is not None, "the leader never answered /health"
        assert "tiny-llm" in health["engines"]
        req = urllib.request.Request(base + "/v1/chat/completions", json.dumps({
            "model": "tiny-llm", "stream": True, "max_tokens": 8,
            "messages": [{"role": "user", "content": "slice hello"}]}).encode(),
            {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            body = r.read().decode()
        assert "data: [DONE]" in body, body[-500:]
        deltas = [json.loads(line[6:]) for line in body.splitlines()
                  if line.startswith("data: ") and line != "data: [DONE]"]
        finishes = [d["choices"][0].get("finish_reason") for d in deltas]
        assert "length" in finishes or "stop" in finishes, finishes
    finally:
        procs[0].send_signal(signal.SIGTERM)
        outs = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
            outs.append(out or "")
    assert procs[0].returncode == 0, outs[0][-3000:]
    assert procs[1].returncode == 0, outs[1][-3000:]
    assert "replaying the leader's steps" in outs[1] and "core server on" not in outs[1]
    assert "RANK EXIT OK" in outs[1]
