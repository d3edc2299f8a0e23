"""The port's dispatch plane (`executor/dispatch.py` and the engine's `_dx`
funnel) against the JAX package's, on the CPU.

  - `DISPATCH_OPS` equals JAX's tuple, name for name and in order, and the
    engine's op registry holds exactly those names;
  - the channel, as JAX's `test_dispatch.py` and `test_slice_engine.py`
    check it: in-order replay through `GSPMDBackend.run_follower`, an
    unknown frame refused, a silent leader presumed dead, pings keeping a
    follower alive;
  - the payload discipline: `GSPMDBackend.emit` refuses a CUDA tensor
    anywhere in a payload (a stand-in with `is_cuda`, there is no card
    here), host values pass; the local backend emits nothing, and an
    engine over a recording local backend dispatches only published ops,
    every one of them through `_dx`, with the default engine's tokens;
  - a follower's death leaves the leader dead and fails its requests.
"""

from __future__ import annotations

import socket
import threading
import time

import numpy as np
import pytest
import torch

from llm_mcp_tpu.executor import dispatch as jdispatch
from llm_mcp_tpu_torch.executor import GenerationEngine
from llm_mcp_tpu_torch.executor import dispatch as D
from test_torch_parallel import ENGINE_KW, TRAFFIC, jax_tree, tp_engines


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_dispatch_ops_equal_jax_and_the_registry():
    assert D.DISPATCH_OPS == jdispatch.DISPATCH_OPS
    assert isinstance(D.DISPATCH_OPS, tuple)
    assert all(isinstance(op, str) and op for op in D.DISPATCH_OPS)
    assert len(set(D.DISPATCH_OPS)) == len(D.DISPATCH_OPS) == 19
    eng = GenerationEngine("tiny-llm", device="cpu", max_seq_len=64, dtype=torch.float32)
    try:
        assert tuple(eng._ops) == D.DISPATCH_OPS
        assert isinstance(eng._backend, D.LocalArraysBackend) and not eng._spmd
    finally:
        eng.shutdown()


# -- the channel (JAX's cases) ----------------------------------------------------------


def test_follower_replays_steps_in_order():
    addr = f"127.0.0.1:{_free_port()}"
    backend = D.GSPMDBackend(addr, connect_timeout_s=30.0, world_size=2)
    assert backend._n_followers == 1
    executed: list[tuple] = []
    table = {
        "alpha": lambda *a: executed.append(("alpha", a)),
        "beta": lambda *a: executed.append(("beta", a)),
    }
    fol = D.GSPMDBackend(addr, connect_timeout_s=30.0, world_size=2)
    t = threading.Thread(target=fol.run_follower, args=(table,), daemon=True)
    t.start()
    backend.start()  # a blocking accept of the one follower
    try:
        payload = np.arange(6, dtype=np.int32).reshape(2, 3)
        host = torch.arange(4, dtype=torch.float32)
        backend.emit("alpha", (1, "x"))
        backend.emit("beta", (payload, {"t": host}))
        backend.emit("alpha", (2.5,))
        backend.idle()  # a ping is transparent to the replay
        backend.stop()
        t.join(timeout=30)
        assert not t.is_alive(), "the follower did not exit on stop"
    finally:
        backend.close()
    assert [(op, a if op == "alpha" else ()) for op, a in executed] == [
        ("alpha", (1, "x")), ("beta", ()), ("alpha", (2.5,))]
    np.testing.assert_array_equal(executed[1][1][0], payload)
    assert torch.equal(executed[1][1][1]["t"], host)
    assert backend.counts == fol.counts == {"alpha": 2, "beta": 1}


def test_follower_rejects_unknown_frame():
    addr = f"127.0.0.1:{_free_port()}"
    backend = D.GSPMDBackend(addr, connect_timeout_s=30.0, world_size=2)
    errs: list[str] = []

    def run():
        try:
            backend.run_follower({})
        except ValueError as e:
            errs.append(str(e))

    t = threading.Thread(target=run, daemon=True)
    t.start()
    leader = D.CmdLeader(addr, 1, timeout_s=30.0)
    try:
        leader.send(("ping",))  # a liveness beacon: the follower keeps waiting
        leader.send(("frobnicate", 7))  # not part of the protocol
        t.join(timeout=30)
        assert not t.is_alive()
    finally:
        leader.close()
    assert errs and "frobnicate" in errs[0]


def test_cmd_follower_presumes_dead_leader():
    srv = socket.create_server(("127.0.0.1", 0))
    port = srv.getsockname()[1]
    try:
        fol = D.CmdFollower(f"127.0.0.1:{port}", timeout_s=5.0, idle_timeout_s=1.0)
        conn, _ = srv.accept()  # connected, then the "leader" goes silent
        try:
            with pytest.raises(ConnectionError, match="presumed dead"):
                fol.recv()
        finally:
            conn.close()
        fol.close()
    finally:
        srv.close()


def test_cmd_leader_ping_keeps_follower_alive():
    port = _free_port()
    box: list = []
    t = threading.Thread(target=lambda: box.append(
        D.CmdFollower(f"127.0.0.1:{port}", timeout_s=10.0, idle_timeout_s=2.0)))
    t.start()
    leader = D.CmdLeader(f"127.0.0.1:{port}", n_followers=1, timeout_s=10.0)
    t.join(timeout=10)
    fol = box[0]
    try:
        leader.ping_if_idle(interval_s=0.0)
        assert fol.recv() == ("ping",)
        leader.send(("stop",))  # a command still round-trips after pings
        assert fol.recv() == ("stop",)
    finally:
        fol.close()
        leader.close()


# -- the payload discipline and the local backend ---------------------------------------


class _OnCard:
    """Stands in for a CUDA tensor: the check reads `is_cuda` only."""

    is_cuda = True


def test_emit_refuses_a_device_tensor_anywhere_in_the_payload():
    backend = D.GSPMDBackend("127.0.0.1:0", world_size=1)
    for args in ((_OnCard(),), (1, [np.zeros(2), _OnCard()]), ({"k": {"q": _OnCard()}},)):
        with pytest.raises(TypeError, match="CUDA tensor"):
            backend.emit("insrows", args)
    # host values pass (no follower: nothing is sent)
    backend.emit("insrows", (np.zeros(3), torch.zeros(2), {"q": torch.zeros(1)}, "s", b"b", 1.5))
    assert backend.counts == {}
    # the local backend is a no-op: no check, no channel, no count
    local = D.LocalArraysBackend()
    assert local.emit("admit", (_OnCard(),)) is None and not local.spmd
    with pytest.raises(RuntimeError, match="no follower role"):
        local.run_follower({})


class _Recording(D.LocalArraysBackend):
    def __init__(self):
        self.ops: list[str] = []

    def emit(self, op, args):
        D.check_host_payload(args, op)
        self.ops.append(op)


def test_every_dx_is_published_and_local_tokens_are_unchanged(monkeypatch):
    """An engine over a recording local backend: every step it dispatches
    is a published op with a host payload, and its greedy tokens equal the
    default engine's over the same traffic (the funnel changes nothing on
    one rank)."""
    monkeypatch.delenv("TPU_SPEC", raising=False)
    _, tree = jax_tree(True)
    kw = dict(ENGINE_KW, quant="int8", kv_quant="int8", dtype=torch.float32, device="cpu")
    outs = []
    rec = _Recording()
    for backend in (None, rec):
        eng = GenerationEngine("tiny-llm", params=tree, backend=backend, **kw).start()
        try:
            outs.append([eng.generate(p, max_tokens=n, temperature=0.0) for p, n in TRAFFIC[:4]])
        finally:
            eng.shutdown()
    assert outs[0] == outs[1]
    assert set(rec.ops) <= set(D.DISPATCH_OPS)
    for op in ("admit", "ragged", "bsample", "decode", "verify", "pput"):
        assert op in rec.ops, op


def test_follower_death_kills_the_leader_and_fails_its_requests():
    """The follower's replay raises in the middle of a stream: the leader's
    next collective fails (its peer left; at the latest the mesh timeout),
    the leader goes dead, and the open request ends with an error."""
    _, tree = jax_tree(False)
    with tp_engines("tiny-llm", tree, dtype=torch.float32, timeout_s=5.0, **ENGINE_KW) as (
            lead, fol):
        assert lead.generate("warm", max_tokens=4, temperature=0.0)["usage"]["completion_tokens"]
        n = {"calls": 0}
        decode = fol._ops["decode"]

        def dies(*a):
            n["calls"] += 1
            if n["calls"] > 2:
                raise RuntimeError("follower lost")
            return decode(*a)

        fol._ops["decode"] = dies
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="engine dead"):
            lead.generate("this stream loses its follower", max_tokens=64, temperature=0.0)
        assert lead.dead and time.monotonic() - t0 < 5.0 + 10.0
        with pytest.raises(RuntimeError, match="engine dead"):
            lead.generate("after death", max_tokens=4)
