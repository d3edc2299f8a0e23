"""Device mesh and its collectives (counterpart of
`llm_mcp_tpu/parallel/mesh.py`).

The JAX package builds a `jax.sharding.Mesh` with axes

  dp - data parallel (independent batch slots)
  pp - pipeline parallel (layer stages)
  ep - expert parallel (MoE expert shards)
  sp - sequence parallel (long-context prefill)
  tp - tensor parallel (attention heads and FFN hidden split)

and lets XLA insert the collectives its shardings imply. In torch every
rank is a process (or, in the tests, a thread with a process group of its
own) holding plain local tensors, so the mesh here is a small object: the
axis sizes in JAX's order (tp innermost), this rank's coordinates, its
device, and one process group per axis of more than one rank. The model
calls the collectives explicitly through it (`all_reduce`, `all_gather`),
at the points where GSPMD would insert them (`models/llama.py`,
`models/quant.py`).

The collective backend is `gloo`, the one this slice has (CPU ranks, and
CUDA ranks that share one device, which NCCL refuses); it is never chosen
by trying one and falling back. A CUDA tensor is staged through host
memory (and a 16-bit float through float32, which `gloo` does not
reduce). Every call
waits at most the mesh's timeout (the process group's `timeout=`, 120 s
by default) and counts into `stats` (calls and seconds per kind), which
the chip check reads per decode step.

`tp_scope(mesh)` makes a mesh the current thread's tensor-parallel
context: the model's row-parallel products, its vocab-parallel embedding
and its logits read it (`current_tp()`), and outside a scope (one rank)
they are the plain single-device code.
"""

from __future__ import annotations

import contextlib
import datetime
import threading
import time
from typing import Any, Iterator

import numpy as np
import torch

AXES = ("dp", "pp", "ep", "sp", "tp")

BACKEND = "gloo"

DEFAULT_TIMEOUT_S = 120.0


def mesh_axis_sizes(spec: str, n_devices: int) -> dict[str, int]:
    """Parse "dp=2,tp=4" -> {'dp': 2, 'pp': 1, 'ep': 1, 'sp': 1, 'tp': 4};
    the default is all tp (a copy of JAX's, with its errors).

    tp is the default because decode is bound by memory bandwidth: sharding
    the weights over every device divides the bytes each one reads a
    step."""
    sizes = {a: 1 for a in AXES}
    spec = (spec or "").strip()
    if spec:
        for part in spec.split(","):
            k, _, v = part.partition("=")
            k = k.strip()
            if k in sizes and v.strip():
                sizes[k] = int(v)
        got = 1
        for a in AXES:
            got *= sizes[a]
        if got != n_devices:
            raise ValueError(f"mesh spec {spec!r} = {got} devices, have {n_devices}")
    else:
        sizes["tp"] = n_devices
    return sizes


class Mesh:
    """One rank's view of the mesh: `shape` (axis -> size, JAX's order),
    `rank` and `world`, `coords` (axis -> this rank's index on it, the
    rank unravelled over AXES with tp fastest), `device`, `groups` (axis ->
    process group; None for an axis of one rank), `backend` (always
    `gloo`) and the per-call `timeout`."""

    axis_names = AXES

    def __init__(self, sizes: dict[str, int], rank: int, device: torch.device,
                 groups: dict[str, Any], timeout_s: float = DEFAULT_TIMEOUT_S):
        self.shape = {a: int(sizes.get(a, 1)) for a in AXES}
        self.world = int(np.prod([self.shape[a] for a in AXES]))
        self.rank = int(rank)
        idx = np.unravel_index(self.rank, [self.shape[a] for a in AXES])
        self.coords = {a: int(i) for a, i in zip(AXES, idx)}
        self.device = torch.device(device)
        self.groups = dict(groups)
        self.backend = BACKEND
        self.timeout = datetime.timedelta(seconds=float(timeout_s))
        # collectives made by this rank: count and wall by kind
        self.stats: dict[str, float] = {"all_reduce": 0, "all_gather": 0, "seconds": 0.0}

    @property
    def size(self) -> int:
        return self.world

    @property
    def tp(self) -> int:
        return self.shape["tp"]

    @property
    def tp_rank(self) -> int:
        return self.coords["tp"]

    def reset_stats(self) -> None:
        self.stats = {"all_reduce": 0, "all_gather": 0, "seconds": 0.0}

    def __repr__(self) -> str:
        axes = ",".join(f"{a}={n}" for a, n in self.shape.items() if n > 1) or "1"
        return f"Mesh({axes}, rank {self.rank}/{self.world}, {self.device}, {self.backend})"

    # -- collectives ---------------------------------------------------------------

    def _stage(self, x: torch.Tensor) -> torch.Tensor:
        """The tensor gloo reduces: a host copy, 16-bit floats widened to
        float32."""
        wire = torch.float32 if x.dtype in (torch.bfloat16, torch.float16) else x.dtype
        if x.device.type != "cpu" or wire != x.dtype:
            return x.detach().to("cpu", wire).contiguous()
        return x.contiguous()

    def _wait(self, work, kind: str, t0: float) -> None:
        work.wait(self.timeout)
        self.stats[kind] += 1
        self.stats["seconds"] += time.perf_counter() - t0

    def all_reduce(self, x: torch.Tensor, op: str = "sum", axis: str = "tp") -> torch.Tensor:
        """Elementwise sum or max of `x` over the axis' ranks; a new tensor
        of x's dtype on x's device (x itself when nothing was staged)."""
        import torch.distributed as dist

        g = self.groups.get(axis)
        if g is None:
            return x
        t0 = time.perf_counter()
        h = self._stage(x)
        red = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
        self._wait(dist.all_reduce(h, op=red, group=g, async_op=True), "all_reduce", t0)
        return h if h is x else h.to(x.device, x.dtype)

    def all_gather(self, x: torch.Tensor, dim: int = -1, axis: str = "tp") -> torch.Tensor:
        """The axis' ranks' `x` concatenated along `dim`, in rank order."""
        import torch.distributed as dist

        g = self.groups.get(axis)
        if g is None:
            return x
        t0 = time.perf_counter()
        h = self._stage(x)
        outs = [torch.empty_like(h) for _ in range(self.shape[axis])]
        self._wait(dist.all_gather(outs, h, group=g, async_op=True), "all_gather", t0)
        out = torch.cat(outs, dim=dim)
        return out if out.device == x.device and out.dtype == x.dtype else out.to(x.device, x.dtype)


def _axis_ranks(sizes: dict[str, int], axis: str) -> list[list[int]]:
    """Every group of ranks along `axis` (the ranks that share all other
    coordinates), in a fixed order: every rank builds them alike."""
    dims = [sizes[a] for a in AXES]
    grid = np.arange(int(np.prod(dims))).reshape(dims)
    moved = np.moveaxis(grid, AXES.index(axis), -1).reshape(-1, sizes[axis])
    return [list(map(int, row)) for row in moved]


def make_mesh(spec: str = "", *, device: str | torch.device | None = None, group: Any = None,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """This rank's mesh over `spec` (JAX's syntax; default all tp over the
    world). The world is `group` when given (a process group built by the
    caller, e.g. a `ProcessGroupGloo` a thread owns), else the default
    process group (`torch.distributed.init_process_group`), else this one
    process. An axis spanning the whole world uses the world group; any
    other axis of more than one rank gets groups from
    `torch.distributed.new_group` (every rank builds every group, in one
    order). `device` defaults to `cuda:{rank % device_count}`; there is no
    CPU fallback when no GPU is found."""
    import torch.distributed as dist

    if group is not None:
        rank, world = group.rank(), group.size()
    elif dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank, world = 0, 1
    sizes = mesh_axis_sizes(spec, world)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass device='cpu' for CPU ranks")
        device = f"cuda:{rank % torch.cuda.device_count()}"
    groups: dict[str, Any] = {}
    for ax in AXES:
        if sizes[ax] == 1:
            groups[ax] = None
        elif sizes[ax] == world:
            groups[ax] = group
        else:
            mine = None
            for ranks in _axis_ranks(sizes, ax):
                g = dist.new_group(ranks, backend=BACKEND,
                                   timeout=datetime.timedelta(seconds=timeout_s))
                if rank in ranks:
                    mine = g
            groups[ax] = mine
    return Mesh(sizes, rank, torch.device(device), groups, timeout_s)


# -- the thread's tensor-parallel context ----------------------------------------

_LOCAL = threading.local()


def current_tp() -> Mesh | None:
    """The mesh of this thread's `tp_scope` when its tp axis has more than
    one rank, else None (the single-device code runs)."""
    m = getattr(_LOCAL, "mesh", None)
    return m if m is not None and m.tp > 1 else None


@contextlib.contextmanager
def tp_scope(mesh: Mesh | None) -> Iterator[None]:
    """Run the body with `mesh` as this thread's tensor-parallel context."""
    prev = getattr(_LOCAL, "mesh", None)
    _LOCAL.mesh = mesh
    try:
        yield
    finally:
        _LOCAL.mesh = prev
