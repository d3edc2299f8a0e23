"""Parameter and KV-cache sharding specs for tensor parallelism
(counterpart of `llm_mcp_tpu/parallel/sharding.py`).

The Megatron mapping, as JAX's PartitionSpecs, here tuples of axis names
(None: the dimension is whole on every rank):

  wq/wk/wv [L, D, H*hd]: output (head) columns on tp -> each rank's heads
  wo       [L, H*hd, D]: input rows on tp -> summed over tp after the product
  w1/w3    [L, D, F]:    F on tp
  w2       [L, F, D]:    F on tp -> summed over tp after the product
  embed    [V, D]:       vocab on tp (vocab-parallel lookup, summed)
  lm_head  [D, V]:       vocab on tp (logits gathered to [B, V])
  KV cache [L, B, Hkv, S, hd]: layers on pp, slots on dp, KV heads on tp

JAX lets GSPMD insert the collectives these specs imply; the port's ranks
hold plain local tensors (`shard_params` cuts each rank's slice) and the
model calls the collectives itself (`parallel/mesh.py`).

The int8 KV cache is the one deliberate difference. JAX replicates the
fused int8 cache over tp (`kv_cache_specs` below, copied as it is) because
its fused head axis (K heads | V heads | the packed-scale pseudo-head)
cannot be split under GSPMD. A port rank holds its own heads in the same
fused layout, built at its local head count, so that reason does not
arise; `fused_heads_local` and `fused_heads_full` convert host rows
between the full layout (what the leader ships and reads back) and a
rank's own.
"""

from __future__ import annotations

from typing import Any

import torch

from ..models.configs import ModelConfig
from .mesh import Mesh

Spec = tuple  # one axis name or None per dimension


def llama_param_specs(cfg: ModelConfig) -> dict[str, Any]:
    """JAX's `llama_param_specs`, as tuples of axis names."""
    if cfg.kv_lora_rank:
        attn: dict[str, Any] = {
            "attn_norm": ("pp", None),
            "wq_mla": ("pp", None, "tp"),
            "w_dkv": ("pp", None, None),
            "kv_norm": ("pp", None),
            "w_ukv": ("pp", None, "tp"),
            "wo_mla": ("pp", "tp", None),
            "ffn_norm": ("pp", None),
        }
        dense_ffn = {"w1": ("pp", None, "tp"), "w3": ("pp", None, "tp"),
                     "w2": ("pp", "tp", None)}
        if cfg.n_experts:
            ffn: dict[str, Any] = {
                "router": ("pp", None, None),
                "w1e": ("pp", "ep", None, "tp"),
                "w3e": ("pp", "ep", None, "tp"),
                "w2e": ("pp", "ep", "tp", None),
            }
            if cfg.n_shared_experts:
                ffn.update({"w1s": ("pp", None, "tp"), "w3s": ("pp", None, "tp"),
                            "w2s": ("pp", "tp", None)})
        else:
            ffn = dense_ffn
        specs: dict[str, Any] = {"embed": ("tp", None), "layers": {**attn, **ffn},
                                 "final_norm": (None,)}
        if cfg.n_experts and cfg.first_dense_layers:
            specs["dense_layers"] = {**attn, **dense_ffn}
        if not cfg.tie_embeddings:
            specs["lm_head"] = (None, "tp")
        return specs
    layers: dict[str, Any] = {
        "attn_norm": ("pp", None),
        "wq": ("pp", None, "tp"),
        "wk": ("pp", None, "tp"),
        "wv": ("pp", None, "tp"),
        "wo": ("pp", "tp", None),
        "ffn_norm": ("pp", None),
    }
    if cfg.qkv_bias:
        # biases follow their projection's output columns
        layers.update({"bq": ("pp", "tp"), "bk": ("pp", "tp"), "bv": ("pp", "tp")})
    if cfg.qk_norm:
        # the per-head norms [L, hd] apply alike on every rank's heads
        layers.update({"q_norm": ("pp", None), "k_norm": ("pp", None)})
    if cfg.post_norms:
        layers.update({"post_attn_norm": ("pp", None), "post_ffn_norm": ("pp", None)})
    if cfg.n_experts:
        layers.update({
            "router": ("pp", None, None),
            "w1e": ("pp", "ep", None, "tp"),
            "w3e": ("pp", "ep", None, "tp"),
            "w2e": ("pp", "ep", "tp", None),
        })
        if cfg.n_shared_experts:
            layers.update({"w1s": ("pp", None, "tp"), "w3s": ("pp", None, "tp"),
                           "w2s": ("pp", "tp", None)})
    else:
        layers.update({"w1": ("pp", None, "tp"), "w3": ("pp", None, "tp"),
                       "w2": ("pp", "tp", None)})
    specs = {"embed": ("tp", None), "layers": layers, "final_norm": (None,)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = (None, "tp")
    return specs


def kv_cache_specs(quantized: bool = False, latent: bool = False) -> dict[str, Any]:
    """JAX's `kv_cache_specs`: [L, B, Hkv, S, hd] with layers on pp, slots
    on dp and KV heads on tp; the fused int8 cache and the MLA latents
    replicate over tp there (the engine holds the int8 cache per rank
    instead: see the module docstring)."""
    if latent:
        row = ("pp", "dp", None, None, None)
        if quantized:
            entry = {"q": row, "s": ("pp", "dp", None, None)}
            return {"k": entry, "v": entry}
        return {"k": row, "v": row}
    row = ("pp", "dp", "tp", None, None)
    if quantized:
        return {"k": {"q": ("pp", "dp", None, None, None), "s": ("pp", "dp", None, None)},
                "v": {}}
    return {"k": row, "v": row}


def kv_pool_specs(quantized: bool = False, latent: bool = False) -> dict[str, Any]:
    """JAX's `kv_pool_specs`: the cache specs with the pool-row axis
    replicated instead of on dp (pool rows are shared prefix blocks any
    slot may read through its table)."""
    def drop_dp(spec: Any) -> Any:
        if isinstance(spec, dict):
            return {k: drop_dp(v) for k, v in spec.items()}
        return tuple(None if ax == "dp" else ax for ax in spec)

    return drop_dp(kv_cache_specs(quantized=quantized, latent=latent))


def supports_ragged_prefill(mesh: Mesh | None) -> bool:
    """Whether the ragged packed prefill may run under `mesh`: not with dp,
    sp or ep above 1 (rows bound for different slot shards interleave in
    one packed buffer); pure pp x tp meshes are fine."""
    if mesh is None or mesh.size == 1:
        return True
    return all(mesh.shape.get(ax, 1) == 1 for ax in ("dp", "sp", "ep"))


def _cut(x: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of `x` under `spec`: every named axis of more than
    one rank splits its dimension into equal blocks, taken at the rank's
    coordinate; a copy, so the whole tensor can be freed."""
    if len(spec) != x.dim():
        raise ValueError(f"spec {spec} for a tensor of shape {tuple(x.shape)}")
    out = x
    for d, ax in enumerate(spec):
        n = mesh.shape.get(ax, 1) if ax else 1
        if n == 1:
            continue
        if x.shape[d] % n:
            raise ValueError(f"dimension {d} of {tuple(x.shape)} does not split over {ax}={n}")
        w = x.shape[d] // n
        out = out.narrow(d, mesh.coords[ax] * w, w)
    return out.clone() if out is not x else out


def shard_params(tree: Any, specs: Any, mesh: Mesh) -> Any:
    """This rank's slice of every leaf of `tree` (the counterpart of JAX's
    `shard_pytree`: the addressable shard of each leaf on this rank's
    device). `specs` mirrors `tree`; a quantized leaf `{"q", "s"}` takes
    `quantized_specs`' pair. Leaves stay on their device."""
    if isinstance(tree, dict):
        missing = set(tree) - set(specs)
        if missing:
            raise KeyError(f"no sharding spec for {sorted(missing)}")
        return {k: shard_params(v, specs[k], mesh) for k, v in tree.items()}
    return _cut(tree, specs, mesh)


def shard_tree_for(cfg: ModelConfig, tree: dict, mesh: Mesh) -> dict:
    """A whole Llama-family tree (float or int8) to this rank's slice, by
    `llama_param_specs` (through `quantized_specs` for int8 leaves; a
    fused `wqkv`/`w13` tree cannot be split over tp and is refused)."""
    from ..models.quant import is_quantized, quantized_specs

    for stack in ("layers", "dense_layers"):
        if any(k in tree.get(stack, {}) for k in ("wqkv", "w13")):
            raise ValueError("a fused wqkv/w13 tree interleaves head groups and cannot be "
                             "split over tp; shard the unfused tree")
    specs = llama_param_specs(cfg)
    if is_quantized(tree["embed"]):
        specs = quantized_specs(specs)
    return shard_params(tree, specs, mesh)


# -- the fused int8 cache's heads, full layout <-> a rank's own -------------------


def _fused_parts(q: torch.Tensor, s: torch.Tensor, hkv: int):
    return q[:, :, :hkv], q[:, :, hkv: 2 * hkv], s[:, :, :hkv], s[:, :, hkv: 2 * hkv]


def _fused(kq, vq, ks, vs, hd: int) -> dict:
    # models.quant imports this package (the tp products): imported here
    from ..models.quant import pack_scales, scale_pack_width

    s = torch.cat([ks, vs], dim=2)
    pay = torch.cat([kq, vq], dim=2)
    if scale_pack_width(kq.shape[2], hd, s.dtype):
        pay = torch.cat([pay, pack_scales(s, hd)], dim=2)
    return {"q": pay.contiguous(), "s": s.contiguous()}


def fused_heads_local(tree: Any, n_kv_heads: int, mesh: Mesh) -> Any:
    """Host KV rows in the full layout to this rank's heads. A bf16 side
    [L, B, Hkv, T, hd] keeps its head block; a fused int8 side
    {"q": [L, B, 2*Hkv + p, T, hd], "s": [L, B, 2*Hkv, T]} keeps its K and
    V head blocks and repacks the pseudo-head for the local count. `{}`
    (the fused cache's V side) stays `{}`."""
    tp, r = mesh.tp, mesh.tp_rank
    if tp == 1:
        return tree
    hl = n_kv_heads // tp
    sl = slice(r * hl, (r + 1) * hl)
    if isinstance(tree, dict):
        if not tree:
            return {}
        kq, vq, ks, vs = _fused_parts(tree["q"], tree["s"], n_kv_heads)
        return _fused(kq[:, :, sl], vq[:, :, sl], ks[:, :, sl], vs[:, :, sl], tree["q"].shape[-1])
    return tree[:, :, sl].contiguous()


def fused_heads_full(tree: Any, mesh: Mesh) -> Any:
    """This rank's rows gathered over tp to the full layout (every rank
    gets the whole; the leader reads it): the inverse of
    `fused_heads_local`."""
    if mesh.tp == 1:
        return tree
    if isinstance(tree, dict):
        if not tree:
            return {}
        hl = tree["s"].shape[2] // 2
        kq, vq, ks, vs = (mesh.all_gather(t.contiguous(), dim=2)
                          for t in _fused_parts(tree["q"], tree["s"], hl))
        return _fused(kq, vq, ks, vs, tree["q"].shape[-1])
    return mesh.all_gather(tree.contiguous(), dim=2)
