"""Multi-process bootstrap (counterpart of
`llm_mcp_tpu/parallel/distributed.py`).

The JAX package starts `jax.distributed` and builds one mesh over every
process's devices. Here each rank is a process: `initialize()` starts
`torch.distributed` from the same environment triplet the JAX package
reads (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID), so
the manifests under `k8s/` drive both packages, and `make_global_mesh`
builds this rank's `Mesh` over the world.

    from llm_mcp_tpu_torch.parallel import distributed
    distributed.initialize()                 # once a process
    mesh = distributed.make_global_mesh("tp=2")

Nothing on a card machine announces a cluster: the coordinator address
is always given (`tcp://host:port`, any free port), with the world size
and the rank. The collective backend is explicit: `gloo` for CPU ranks
and for CUDA ranks that share a device (staged through host memory; NCCL
refuses two ranks on one device). NCCL for ranks on their own cards is
not in this slice (ROADMAP.md queue 1 item 11). Single-process runs skip
cleanly, so the same entry point serves one rank or many.
"""

from __future__ import annotations

import datetime
import logging
import os

import torch

from .mesh import AXES, BACKEND, DEFAULT_TIMEOUT_S, Mesh, make_mesh, mesh_axis_sizes

log = logging.getLogger("distributed")

__all__ = ["AXES", "env_process_info", "initialize", "dcn_axis", "make_global_mesh",
           "host_local_batch", "mesh_axis_sizes"]

_state: dict = {"device": None}


def env_process_info() -> tuple[str, int, int] | None:
    """(coordinator, num_processes, process_id) from the environment, or
    None (JAX's triplet)."""
    addr = os.environ.get("JAX_COORDINATOR_ADDRESS", "")
    if not addr:
        return None
    try:
        n = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
        pid = int(os.environ.get("JAX_PROCESS_ID", "0"))
    except ValueError:
        return None
    return addr, n, pid


def initialize(force: bool = False, *, device: str | None = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Idempotent `torch.distributed.init_process_group` from the triplet
    (or, with none, a no-op that returns False). The backend is `gloo`:
    CPU ranks (`device="cpu"`) and CUDA ranks sharing one device. This
    rank's device is `device`, else `cuda:{rank % device_count}`; with no
    CUDA device and no `device="cpu"` it raises (there is no CPU fallback).
    Returns True when the world has more than one rank."""
    import torch.distributed as dist

    if dist.is_initialized() and not force:
        return dist.get_world_size() > 1
    info = env_process_info()
    if info is None:
        log.debug("single-process run; torch.distributed not initialized")
        return False
    addr, n, pid = info
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("distributed.initialize: no CUDA device; pass device='cpu' "
                               "for CPU ranks")
        device = f"cuda:{pid % torch.cuda.device_count()}"
    dev = torch.device(device)
    init = addr if "://" in addr else f"tcp://{addr}"
    dist.init_process_group(BACKEND, init_method=init, world_size=n, rank=pid,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _state.update(device=dev)
    log.info("torch.distributed up: rank %d/%d on %s, backend %s (explicit%s)", pid, n, dev,
             BACKEND, ", host-staged CUDA tensors" if dev.type == "cuda" else "")
    return n > 1


def dcn_axis(sizes: dict[str, int]) -> str:
    """Which mesh axis should span hosts: the first of dp/pp of more than
    one rank (their traffic is off the per-token critical path); tp and sp
    stay inside a host."""
    for a in ("dp", "pp"):
        if sizes.get(a, 1) > 1:
            return a
    return ""


def make_global_mesh(spec: str = "", timeout_s: float = DEFAULT_TIMEOUT_S,
                     device: str | torch.device | None = None) -> Mesh:
    """This rank's mesh over the whole world (`initialize` first), on
    `device`, else the one `initialize` chose, else `cuda:{rank %
    device_count}` (`make_mesh` raises without CUDA). One host: the ranks'
    order is the mesh's, tp fastest. The port has no multi-slice topology
    to lay out, so the DCN axis is reported (`dcn_axis`) and not placed."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    sizes = mesh_axis_sizes(spec, world)
    dev = device if device is not None else _state["device"]
    mesh = make_mesh(spec, device=dev, timeout_s=timeout_s)
    if dcn_axis(sizes):
        log.info("mesh %s: axis %s would span hosts", sizes, dcn_axis(sizes))
    return mesh


def host_local_batch(global_batch: int) -> int:
    """Slots this process feeds when the dp axis spans processes."""
    import torch.distributed as dist

    n = dist.get_world_size() if dist.is_initialized() else 1
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} processes")
    return global_batch // n
