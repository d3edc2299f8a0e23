"""Dispatch plane: one scheduling loop, two backends (counterpart of
`llm_mcp_tpu/executor/dispatch.py`).

`GenerationEngine` (executor/engine.py) owns every policy: admission,
token budgets, speculation, preemption, paging, the prefix tier. Every
mutation of device state goes through one choke point
(`GenerationEngine._dx(op, *args)`), and a `DispatchBackend` decides what
a dispatch means:

  - **LocalArraysBackend**: the single-process path. `emit` does nothing;
    `_dx` runs the op closure on the engine's own tensors, exactly as the
    engine ran before the funnel existed.
  - **GSPMDBackend** (JAX's name, kept so that a reader finds it): the
    leader/follower path over `torch.distributed` ranks. The leader sends
    each dispatch as a `("step", op, args)` frame over the command channel
    before it runs it; every follower rank replays the same op closure on
    its own shard of the weights, the cache and the pool. The op closures
    run the model's collectives (`parallel/mesh.py`), so every rank enters
    them in the same order and the tokens cannot part.

The step program is the whole protocol. A follower's loop is four lines:
ping: go on, stop: return, step: `exec_table[op](*args)`. No command is
handled per feature anywhere, and the dispatch-surface pass
(`analysis/dispatch_surface.py`) keeps it so: every op the engine
registers or dispatches must appear in `DISPATCH_OPS` below, and the
channel classes are built nowhere but here.

Payload discipline: op arguments carry host values only (numpy arrays,
CPU tensors, ints, floats, strings, bytes, and tuples, lists and dicts of
them). Device state (the weights, the KV cache, the physical pool, the
sampling rows) lives on `self` inside the op closures. `GSPMDBackend.emit`
raises on a CUDA tensor. What the leader reads back (sampled tokens,
snapshot rows, prefix exports) every rank computes alike or gathers to
full heads, so the leader's copy is whole.

This module needs the standard library only; `torch.distributed` is read
lazily for the world size.
"""

from __future__ import annotations

import logging
import os
import pickle
import socket
import struct
import threading
import time
from typing import Any, Callable, Mapping

__all__ = [
    "DISPATCH_OPS",
    "PING_INTERVAL_S",
    "CmdLeader",
    "CmdFollower",
    "DispatchBackend",
    "LocalArraysBackend",
    "GSPMDBackend",
    "check_host_payload",
]

log = logging.getLogger("executor.dispatch")

# ---------------------------------------------------------------------------
# The op vocabulary: the complete device-mutation surface of the engine.
# The dispatch-surface pass reconciles this tuple with the `ops[...] = ...`
# registry and every `_dx("...")` call site in engine.py, both ways.
# ---------------------------------------------------------------------------

DISPATCH_OPS = (
    "admit",    # fused admit: prefill + inserts + sampling rows + token0
    "insert",   # bulk row insert from a device prefix entry (hit, restore)
    "insrows",  # bulk row insert from host KV rows (restore, migrate-in)
    "insat",    # exact-length host-row insert at an offset (paged restore)
    "chunk",    # bucketed chunked-prefill group (logits park by gid)
    "ragged",   # ragged chunked-prefill group (logits park by gid)
    "bsample",  # boundary sample off a parked group's logits + row writes
    "decode",   # decode round (plain / fused-chunk / fused-ragged)
    "verify",   # speculative verify round
    "cnstep",   # grammar-constrained single-step decode (masked sample)
    "samprow",  # set one slot's sampling row (temp/top-k/top-p/last)
    "snap",     # replicate+fetch KV rows (preempt snapshot, migration)
    "pfxput",   # slice live rows into the device prefix cache
    "pfxdrop",  # release a device prefix entry
    "pfximp",   # materialize host bytes as a device prefix entry
    "pfxexp",   # replicate+fetch a prefix entry (fleet export)
    "poolexp",  # physical pool: replicate+fetch pool rows (fleet export)
    "cow",      # physical pool: copy-on-write one block
    "pput",     # physical pool: publish one block (arena/pool/host)
)


def check_host_payload(obj: Any, where: str = "payload") -> None:
    """Raise TypeError when `obj` holds a tensor on a device: a step's
    arguments must be host values, or a follower would need the leader's
    device. Walks tuples, lists and dicts; reads `is_cuda` without
    importing torch."""
    if isinstance(obj, (tuple, list)):
        for i, x in enumerate(obj):
            check_host_payload(x, f"{where}[{i}]")
    elif isinstance(obj, dict):
        for k, x in obj.items():
            check_host_payload(x, f"{where}[{k!r}]")
    elif getattr(obj, "is_cuda", False) is True:
        raise TypeError(f"dispatch {where} is a CUDA tensor: op payloads carry host values only")


# ---------------------------------------------------------------------------
# Command channel: leader -> followers, length-prefixed pickles over TCP
# ---------------------------------------------------------------------------


PING_INTERVAL_S = 5.0  # leader liveness beacon cadence while the queue is idle


class CmdLeader:
    """Leader side: accept one connection per follower, broadcast commands."""

    def __init__(self, bind_addr: str, n_followers: int, timeout_s: float = 60.0):
        host, _, port = bind_addr.rpartition(":")
        self._srv = socket.create_server((host or "0.0.0.0", int(port)))
        self._srv.settimeout(timeout_s)
        self.conns: list[socket.socket] = []
        # send() is called from the engine loop and from shutdown()'s thread
        # (the "stop" frame); interleaved sendall() would corrupt the stream
        self._send_lock = threading.Lock()
        self.last_send_t = time.monotonic()
        for _ in range(n_followers):
            c, _addr = self._srv.accept()
            c.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self.conns.append(c)

    def send(self, obj: Any) -> None:
        blob = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        frame = struct.pack("<I", len(blob)) + blob
        with self._send_lock:
            for c in self.conns:
                c.sendall(frame)
            self.last_send_t = time.monotonic()

    def ping_if_idle(self, interval_s: float = PING_INTERVAL_S) -> None:
        """Beacon so followers can tell a quiet leader from a dead one."""
        if time.monotonic() - self.last_send_t >= interval_s:
            self.send(("ping",))

    def close(self) -> None:
        for c in self.conns:
            try:
                c.close()
            except OSError:
                pass
        self._srv.close()


class CmdFollower:
    """Follower side: connect (with retry: the leader may boot later) and
    wait on recv with a liveness bound. The leader beacons ("ping") every
    PING_INTERVAL_S while idle, so a follower that sees no bytes for
    `idle_timeout_s` concludes the leader process is dead (not merely
    quiet) and raises instead of blocking forever on a half-open socket."""

    def __init__(self, addr: str, timeout_s: float = 60.0, idle_timeout_s: float = 600.0):
        host, _, port = addr.rpartition(":")
        deadline = time.time() + timeout_s
        while True:
            try:
                self._c = socket.create_connection((host, int(port)), timeout=5.0)
                break
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(0.2)
        self._c.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # finite, so recv wakes to check the liveness deadline; generous,
        # because the leader stops beaconing while one of its dispatches
        # blocks (a first kernel build can take minutes)
        self.idle_timeout_s = max(idle_timeout_s, 1.0)
        self._c.settimeout(min(PING_INTERVAL_S, self.idle_timeout_s))

    def recv(self) -> Any:
        hdr = self._recv_exact(4)
        (n,) = struct.unpack("<I", hdr)
        return pickle.loads(self._recv_exact(n))

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        deadline = time.monotonic() + self.idle_timeout_s
        while len(buf) < n:
            try:
                chunk = self._c.recv(n - len(buf))
            except TimeoutError:
                if time.monotonic() > deadline:
                    raise ConnectionError(
                        f"leader sent nothing for {self.idle_timeout_s:.0f}s "
                        "(no command or ping): presumed dead"
                    ) from None
                continue
            if not chunk:
                raise ConnectionError("command channel closed")
            buf += chunk
            deadline = time.monotonic() + self.idle_timeout_s
        return buf

    def close(self) -> None:
        self._c.close()


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------


class DispatchBackend:
    """What a dispatch means. The engine calls `emit(op, args)` before it
    runs each op closure, `idle()` from quiet loop iterations,
    `stop()`/`close()` at shutdown, and hands its op registry to
    `run_follower(exec_table)` on the ranks that do not lead."""

    #: True when the engine's tensors are one rank's shard of a mesh: a
    #: failed step cannot be recovered locally and kills the engine.
    spmd: bool = False

    def start(self) -> None:  # leader-side channel setup (blocking accept)
        pass

    def emit(self, op: str, args: tuple) -> None:  # broadcast one step
        pass

    def idle(self) -> None:  # liveness beacon hook
        pass

    def run_follower(self, exec_table: Mapping[str, Callable]) -> None:
        raise RuntimeError("this backend has no follower role")

    def stop(self) -> None:  # release followers
        pass

    def close(self) -> None:
        pass


class LocalArraysBackend(DispatchBackend):
    """Single-process tensors (the classic `GenerationEngine` path). Every
    hook does nothing: `_dx` is a direct call."""

    spmd = False


class GSPMDBackend(DispatchBackend):
    """Leader/follower execution over `torch.distributed` ranks (JAX's
    multi-controller GSPMD backend, under its name).

    Rank 0 leads: it serializes the step program over the command channel
    and every other rank replays it through the same op registry on its
    own shard. No scheduling state crosses the wire, only op names and
    host payloads. `_n_followers` is the world size less one (the default
    process group's, or `world_size` when given: ranks built on a process
    group of their own, as the tests' threads are). `counts` holds the ops
    emitted (leader) or replayed (follower) by name."""

    spmd = True

    def __init__(
        self,
        cmd_addr: str,
        *,
        connect_timeout_s: float = 60.0,
        idle_timeout_s: float = 600.0,
        world_size: int | None = None,
    ):
        self.cmd_addr = cmd_addr
        self.connect_timeout_s = connect_timeout_s
        self.idle_timeout_s = idle_timeout_s
        self._leader: CmdLeader | None = None
        if world_size is None:
            import torch.distributed as dist  # deferred: stdlib at module level

            world_size = dist.get_world_size() if dist.is_initialized() else 1
        self._n_followers = max(int(world_size) - 1, 0)
        self.counts: dict[str, int] = {}

    def _count(self, op: str) -> None:
        self.counts[op] = self.counts.get(op, 0) + 1

    # -- leader side --------------------------------------------------------

    def start(self) -> None:
        if self._leader is None:
            self._leader = CmdLeader(
                self.cmd_addr, self._n_followers, timeout_s=self.connect_timeout_s
            )

    def emit(self, op: str, args: tuple) -> None:
        check_host_payload(args, op)
        if self._leader is not None and self._leader.conns:
            self._leader.send(("step", op, args))
            self._count(op)

    def idle(self) -> None:
        if self._leader is not None and self._leader.conns:
            self._leader.ping_if_idle()

    def stop(self) -> None:
        if self._leader is not None and self._leader.conns:
            try:
                self._leader.send(("stop",))
            except OSError:
                pass

    def close(self) -> None:
        if self._leader is not None:
            self._leader.close()
            self._leader = None

    # -- follower side ------------------------------------------------------

    def run_follower(self, exec_table: Mapping[str, Callable]) -> None:
        """Replay the leader's step program. This loop is the entire
        follower: there is no per-op branching here; an op the registry
        does not know is a protocol error, not a feature."""
        fol = CmdFollower(
            self.cmd_addr,
            timeout_s=self.connect_timeout_s,
            idle_timeout_s=self.idle_timeout_s,
        )
        try:
            while True:
                cmd = fol.recv()
                tag = cmd[0]
                if tag == "ping":
                    continue
                if tag == "stop":
                    return
                if tag != "step":
                    raise ValueError(f"unknown dispatch frame {tag!r}")
                exec_table[cmd[1]](*cmd[2])
                self._count(cmd[1])
        finally:
            fol.close()


# ---------------------------------------------------------------------------
# Two-process demo: one engine, the leader/follower backend, greedy tokens
# across the process boundary. Run it in two shells (or two processes):
#   JAX_COORDINATOR_ADDRESS=127.0.0.1:29511 JAX_NUM_PROCESSES=2 JAX_PROCESS_ID=<0|1> \
#   SLICE_CMD_ADDR=127.0.0.1:29512 python -m llm_mcp_tpu_torch.executor.dispatch
# ---------------------------------------------------------------------------


def _demo_main() -> int:
    import torch

    from ..parallel import distributed

    multi = distributed.initialize(
        device="cpu" if os.environ.get("SLICE_DEMO_CPU", "1") != "0" else "cuda")
    spec = os.environ.get("SLICE_MESH", "tp=2")
    mesh = distributed.make_global_mesh(spec)

    from .engine import GenerationEngine

    eng = GenerationEngine(
        os.environ.get("SLICE_MODEL", "tiny-llm"),
        mesh=mesh,
        backend=GSPMDBackend(os.environ["SLICE_CMD_ADDR"]),
        max_slots=int(os.environ.get("SLICE_SLOTS", "8")),
        max_seq_len=int(os.environ.get("SLICE_SEQ", "128")),
        dtype=torch.float32 if mesh.device.type == "cpu" else torch.bfloat16,
        decode_chunk=4,
        device=mesh.device,
    )
    if mesh.rank == 0:
        eng.start()
        out = eng.generate("dispatch dryrun", max_tokens=6, temperature=0.0)
        n_tok = out["usage"]["completion_tokens"]
        eng.shutdown()
        print(f"DISPATCH DEMO OK: {mesh.world} processes, mesh {spec}, {n_tok} tokens",
              flush=True)
    else:
        eng.run_follower()
        print("DISPATCH FOLLOWER OK", flush=True)
    return 0 if multi or mesh.world == 1 else 1


if __name__ == "__main__":
    raise SystemExit(_demo_main())
