"""The decode round as one CUDA graph: the port's counterpart of the JAX
engine's one jitted executable a round (`decode_chunk_fn`,
`llm_mcp_tpu/executor/engine.py`).

`RoundGraphs.run(key, fn, inputs)` runs `fn(*inputs)` as a graph captured
on the key's first use, as JAX traces a new static shape on its first
call. The first call of a key runs `fn` eagerly on a side stream, on the
key's static input buffers: that is the key's real first round, and it
also does the lazy work that must not happen under capture (the kernels'
build and `dlopen`, their first `cudaFuncSetAttribute`, cuBLAS's
workspace). Then `fn` is captured on the same stream, and every later call
copies its inputs into the static buffers on the current stream and
replays. The static output is overwritten by the next replay of the key,
so the caller copies it out on the stream before then.

- **One memory pool** for every graph of an engine: the replays run one at
  a time on one stream, so their workspaces may share memory; each
  graph's output stays allocated.
- **The sampler's generator** is registered with every graph, so a replay
  advances its Philox offset as the eager round would and draws the same
  numbers.
- **Launch counts.** `kernels.attention.LAUNCHES` is counted on the host
  when a wrapper launches. A capture launches nothing: its counts are
  taken back out and kept as the graph's tally, which every replay adds.
- **No fallback.** A capture that fails raises; nothing goes eager
  quietly.
- **Release.** `release()` (the engine's shutdown) drops the graphs and
  their buffers, so nothing of them stays on the card.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import torch

from ..kernels import attention as K


@dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    inputs: tuple  # static input buffers (None where the call had None)
    out: torch.Tensor  # static output
    launches: dict[str, int]  # kernel launches of one replay


class RoundGraphs:
    """CUDA graphs of a round function, one per static key, for one engine."""

    def __init__(self, device: torch.device, generator: torch.Generator):
        self.device = device
        self._gen = generator
        self._pool = torch.cuda.graph_pool_handle()
        self._stream = torch.cuda.Stream(device)
        self._graphs: dict[tuple, _Graph] = {}
        self.replays = 0
        self.first_call_s: dict[tuple, float] = {}  # eager round + capture, per key

    def keys(self) -> list[tuple]:
        return list(self._graphs)

    def release(self) -> None:
        """Drop every graph with its static buffers (the engine's shutdown):
        the private pool's blocks return to the allocator once no graph
        that used them is alive. The counters stay readable."""
        self._graphs.clear()

    def tally(self, key: tuple) -> dict[str, int]:
        """Kernel launches one replay of `key` makes."""
        return dict(self._graphs[key].launches)

    def run(self, key: tuple, fn: Callable[..., torch.Tensor], inputs: tuple) -> torch.Tensor:
        g = self._graphs.get(key)
        if g is None:
            return self._first(key, fn, inputs)
        for dst, src in zip(g.inputs, inputs):
            if dst is not None:
                dst.copy_(src, non_blocking=True)
        g.graph.replay()
        for name, n in g.launches.items():
            K.LAUNCHES[name] += n
        self.replays += 1
        return g.out

    def _first(self, key: tuple, fn, inputs: tuple) -> torch.Tensor:
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self.device)
        static = tuple(None if x is None else x.clone() for x in inputs)
        side = self._stream
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = fn(*static)  # the key's first round, eager
        cur.wait_stream(side)
        out.record_stream(cur)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self._gen)
        before = dict(K.LAUNCHES)
        try:
            # thread_local: the HTTP threads may touch CUDA meanwhile
            with torch.cuda.graph(graph, pool=self._pool, stream=side,
                                  capture_error_mode="thread_local"):
                g_out = fn(*static)
        finally:
            launches = {n: K.LAUNCHES[n] - before[n] for n in before if K.LAUNCHES[n] != before[n]}
            K.LAUNCHES.update(before)
        self._graphs[key] = _Graph(graph=graph, inputs=static, out=g_out, launches=launches)
        self.first_call_s[key] = time.perf_counter() - t0
        return out
