"""Multi-device serving (counterpart of `llm_mcp_tpu/parallel/`): the mesh
and its collectives, the tensor-parallel sharding specs, and the
multi-process bootstrap. This slice ports tp; the dp, pp, sp and ep axes
(`pipeline.py`, `ring.py`) are refused by the engine until they are
ported (ROADMAP.md queue 1 item 11)."""

from .mesh import AXES, Mesh, current_tp, make_mesh, mesh_axis_sizes, tp_scope
from .sharding import (
    kv_cache_specs,
    kv_pool_specs,
    llama_param_specs,
    shard_params,
    shard_tree_for,
    supports_ragged_prefill,
)
from .distributed import (
    dcn_axis,
    env_process_info,
    host_local_batch,
    initialize,
    make_global_mesh,
)

__all__ = [
    "AXES",
    "Mesh",
    "current_tp",
    "make_mesh",
    "mesh_axis_sizes",
    "tp_scope",
    "llama_param_specs",
    "kv_cache_specs",
    "kv_pool_specs",
    "shard_params",
    "shard_tree_for",
    "supports_ragged_prefill",
    "env_process_info",
    "initialize",
    "dcn_axis",
    "make_global_mesh",
    "host_local_batch",
]
