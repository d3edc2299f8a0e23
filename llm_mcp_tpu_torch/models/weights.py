"""Checkpoints and parameter trees into the port's tensors (counterpart of
`llm_mcp_tpu/models/weights.py`).

`params_from_numpy` takes a parameter tree in the JAX package's layout as
numpy arrays (for example `jax.tree.map(np.asarray, params)`) and returns
the same tree as tensors on `device`. It is how the two implementations
are made to compute from the same weights. The tree may be the JAX
package's int8 form (`quantize_params`, `init_llama_params_quantized`):
a quantized leaf is `{"q": int8, "s": scales}`, its payload copied exactly
and its scales converted to `dtype`; and it may carry the single-device
fused keys `wqkv`/`w13` (`fuse_layer_weights`). MLA and DeepSeek MoE
trees (`models/mla.py`) carry their dense prologue in `dense_layers` and
the routed expert banks as [L, E, D, F] tensors.

Hugging Face checkpoints: `read_safetensors` / `write_safetensors` handle
the format (an 8-byte little-endian header length, a JSON header, raw
tensor bytes) with numpy and torch alone. BF16 is read and written as raw
16-bit words reinterpreted by torch (`.view(torch.bfloat16)`), so neither
`ml_dtypes` nor the `safetensors` package is needed. `hf_to_llama_params`
re-lays an HF tree out into the stacked tree of every decoder family
(HF linears are [out, in], the tree's [in, out]; Gemma-2's norm names;
Qwen2's biases; Qwen3's q/k norms; Mixtral's expert banks; DeepSeek-V2's
MLA factorization with its interleaved rope columns); `load_llama_checkpoint`
does the same into device tensors layer by layer, so host memory holds one
layer's converted tensors at a time beside the file's pages.
`llama_to_hf_tensors` is the inverse, for writing checkpoints.

Encoder checkpoints (the embedders of `models/embedder.py`):
`hf_to_embedder_params` reads classic BERT naming (separate q/k/v, an
optional `bert.` prefix) and nomic_bert's (a fused `Wqkv`, post-LN
`norm1`/`norm2`, the gated MLP's `fc11`/`fc12`), `encoder_to_hf_tensors`
writes either, and `load_embedder_checkpoint` loads a directory onto the
device. Qwen3-Embedding checkpoints are decoders and load through
`load_llama_checkpoint`. Native checkpoints (`save_native`/`load_native`)
are not ported yet (ROADMAP queue 1 item 10).
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Any, Callable, Iterator

import numpy as np
import torch

from .configs import ModelConfig
from .llama import param_shapes

# safetensors dtype tag -> (numpy dtype of the raw words, torch dtype)
_ST_DTYPES: dict[str, tuple[np.dtype, torch.dtype]] = {
    "F64": (np.dtype("<f8"), torch.float64),
    "F32": (np.dtype("<f4"), torch.float32),
    "F16": (np.dtype("<f2"), torch.float16),
    "BF16": (np.dtype("<u2"), torch.bfloat16),  # raw 16-bit words, viewed by torch
    "I64": (np.dtype("<i8"), torch.int64),
    "I32": (np.dtype("<i4"), torch.int32),
    "I16": (np.dtype("<i2"), torch.int16),
    "I8": (np.dtype("i1"), torch.int8),
    "U8": (np.dtype("u1"), torch.uint8),
    "BOOL": (np.dtype("?"), torch.bool),
}
_TORCH_TAGS = {t: tag for tag, (_, t) in _ST_DTYPES.items()}


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of one .safetensors file, as CPU tensors over a private
    (copy-on-write) map of the file: nothing is read until used."""
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen).decode("utf-8"))
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    base = 8 + hlen
    out: dict[str, torch.Tensor] = {}
    for name, spec in header.items():
        if name == "__metadata__":
            continue
        if spec["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name} has unsupported dtype {spec['dtype']}")
        words, tdt = _ST_DTYPES[spec["dtype"]]
        b, e = spec["data_offsets"]
        arr = np.frombuffer(mm, dtype=words, count=(e - b) // words.itemsize, offset=base + b)
        out[name] = torch.from_numpy(arr).view(tdt).reshape(spec["shape"])
    return out


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


def write_safetensors(path: str, tensors: dict[str, Any]) -> None:
    """Write tensors (torch tensors or numpy arrays) to one .safetensors
    file; bf16 tensors as their raw 16-bit words."""
    header: dict[str, Any] = {}
    offset = 0
    blobs: list[bytes] = []
    for name, x in tensors.items():
        t = _as_tensor(x).detach().cpu().contiguous()
        if t.dtype not in _TORCH_TAGS:
            raise ValueError(f"unsupported dtype for safetensors: {t.dtype}")
        tag = _TORCH_TAGS[t.dtype]
        blob = t.view(torch.uint16 if tag == "BF16" else t.dtype).numpy().tobytes()
        header[name] = {"dtype": tag, "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        offset += len(blob)
        blobs.append(blob)
    hjson = json.dumps(header, separators=(",", ":")).encode("utf-8")
    hjson += b" " * ((8 - len(hjson) % 8) % 8)  # 8-byte aligned data (the spec allows spaces)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for blob in blobs:
            f.write(blob)


def has_safetensors(ckpt_dir: str) -> bool:
    return bool(ckpt_dir) and os.path.isdir(ckpt_dir) and any(
        f.endswith(".safetensors") for f in os.listdir(ckpt_dir))


def read_checkpoint_dir(ckpt_dir: str) -> dict[str, torch.Tensor]:
    """Every tensor of every *.safetensors shard in a directory (the HF
    multi-shard layout; the index file is not needed)."""
    files = sorted(os.path.join(ckpt_dir, f) for f in os.listdir(ckpt_dir)
                   if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {ckpt_dir}")
    tensors: dict[str, torch.Tensor] = {}
    for f in files:
        tensors.update(read_safetensors(f))
    return tensors


# ---------------------------------------------------------------------------
# HF names -> the stacked tree
# ---------------------------------------------------------------------------

# (tree key, HF suffix, transpose?) of a Llama-family layer; HF linears are [out, in]
_LLAMA_LAYER_MAP = [
    ("attn_norm", "input_layernorm.weight", False),
    ("wq", "self_attn.q_proj.weight", True),
    ("wk", "self_attn.k_proj.weight", True),
    ("wv", "self_attn.v_proj.weight", True),
    ("wo", "self_attn.o_proj.weight", True),
    ("ffn_norm", "post_attention_layernorm.weight", False),
    ("w1", "mlp.gate_proj.weight", True),
    ("w3", "mlp.up_proj.weight", True),
    ("w2", "mlp.down_proj.weight", True),
]
_MOE_GATE = "block_sparse_moe.gate.weight"  # Mixtral's router


def _moe_suffix(e: int, w: str) -> str:
    return f"block_sparse_moe.experts.{e}.{w}.weight"


def _layer_map(cfg: ModelConfig) -> list[tuple[str, str, bool]]:
    """The family's suffix map. The naming trap, as in JAX: in Llama, Qwen
    and Mistral checkpoints `post_attention_layernorm` is the pre-FFN
    norm; Gemma-2 (post_norms) uses it for the post-attention norm and
    names the pre-FFN norm `pre_feedforward_layernorm`."""
    m = list(_LLAMA_LAYER_MAP)
    if cfg.n_experts:
        m = [e for e in m if e[0] not in ("w1", "w3", "w2")]
    if cfg.post_norms:
        m = [e for e in m if e[0] != "ffn_norm"]
        m += [("ffn_norm", "pre_feedforward_layernorm.weight", False),
              ("post_attn_norm", "post_attention_layernorm.weight", False),
              ("post_ffn_norm", "post_feedforward_layernorm.weight", False)]
    if cfg.qkv_bias:
        m += [("bq", "self_attn.q_proj.bias", False), ("bk", "self_attn.k_proj.bias", False),
              ("bv", "self_attn.v_proj.bias", False)]
    if cfg.qk_norm:
        m += [("q_norm", "self_attn.q_norm.weight", False),
              ("k_norm", "self_attn.k_norm.weight", False)]
    return m


def _rope_perm(dr: int, inverse: bool = False) -> torch.Tensor:
    """DeepSeek-V2 checkpoints store the rope dims interleaved; the port's
    rope is split-half, so the permutation is baked into the columns."""
    perm = torch.cat([torch.arange(0, dr, 2), torch.arange(1, dr, 2)])
    return torch.argsort(perm) if inverse else perm


def _llama_layer(cfg: ModelConfig, get, prefix: str, i: int) -> dict[str, torch.Tensor]:
    base = f"{prefix}layers.{i}."
    out = {ours: get(base + suffix).T if tr else get(base + suffix)
           for ours, suffix, tr in _layer_map(cfg)}
    if cfg.n_experts:
        out["router"] = get(base + _MOE_GATE).T  # [D, E]
        for ours, hf_w in (("w1e", "w1"), ("w2e", "w2"), ("w3e", "w3")):
            out[ours] = torch.stack([get(base + _moe_suffix(e, hf_w)).T
                                     for e in range(cfg.n_experts)])  # [E, in, out]
    return out


def _mla_layer(cfg: ModelConfig, get, prefix: str, i: int) -> dict[str, torch.Tensor]:
    """One DeepSeek-V2 layer: attention, norms and its FFN (dense, or the
    routed and shared experts)."""
    H = cfg.n_heads
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    R = cfg.kv_lora_rank
    perm = _rope_perm(dr)
    base = f"{prefix}layers.{i}."
    q = get(base + "self_attn.q_proj.weight").T.reshape(-1, H, dn + dr)
    q = torch.cat([q[..., :dn], q[..., dn:][..., perm]], dim=-1)
    dkv = get(base + "self_attn.kv_a_proj_with_mqa.weight").T  # [D, R + dr]
    dkv = torch.cat([dkv[..., :R], dkv[..., R:][..., perm]], dim=-1)
    out = {
        "attn_norm": get(base + "input_layernorm.weight"),
        "ffn_norm": get(base + "post_attention_layernorm.weight"),
        "wq_mla": q.reshape(-1, H * (dn + dr)),
        "w_dkv": dkv,
        "kv_norm": get(base + "self_attn.kv_a_layernorm.weight"),
        "w_ukv": get(base + "self_attn.kv_b_proj.weight").T,
        "wo_mla": get(base + "self_attn.o_proj.weight").T,
    }
    mlp = base + "mlp."
    if cfg.n_experts and i >= cfg.first_dense_layers:
        out["router"] = get(mlp + "gate.weight").T
        for ours, hf_w in (("w1e", "gate_proj"), ("w3e", "up_proj"), ("w2e", "down_proj")):
            out[ours] = torch.stack([get(f"{mlp}experts.{e}.{hf_w}.weight").T
                                     for e in range(cfg.n_experts)])
        if cfg.n_shared_experts:
            for ours, hf_w in (("w1s", "gate_proj"), ("w3s", "up_proj"), ("w2s", "down_proj")):
                out[ours] = get(f"{mlp}shared_experts.{hf_w}.weight").T
    else:
        for ours, hf_w in (("w1", "gate_proj"), ("w3", "up_proj"), ("w2", "down_proj")):
            out[ours] = get(f"{mlp}{hf_w}.weight").T
    return out


def _stack_of(cfg: ModelConfig, i: int) -> tuple[str, int]:
    """(stack, index in it) of decoder layer i: DeepSeek's dense prologue
    is the `dense_layers` stack."""
    k = cfg.first_dense_layers if (cfg.kv_lora_rank and cfg.n_experts) else 0
    return ("dense_layers", i) if i < k else ("layers", i - k)


def _hf_leaves(cfg: ModelConfig, tensors: dict, prefix: str) -> Iterator[tuple[tuple, Callable]]:
    """(path, make) of every leaf of the tree: path is ("embed",), or
    (stack, layer index, key) for one layer's slice; make() gives the CPU
    tensor in the tree's orientation. A missing tensor raises KeyError
    naming it."""

    def get(name: str) -> torch.Tensor:
        if name not in tensors:
            raise KeyError(f"checkpoint missing tensor {name!r}")
        return tensors[name]

    yield ("embed",), lambda: get(f"{prefix}embed_tokens.weight")
    yield ("final_norm",), lambda: get(f"{prefix}norm.weight")
    if not cfg.tie_embeddings:  # some exports tie silently: the embedding
        yield ("lm_head",), lambda: tensors.get("lm_head.weight",
                                                get(f"{prefix}embed_tokens.weight")).T
    layer = _mla_layer if cfg.kv_lora_rank else _llama_layer
    for i in range(cfg.n_layers):
        stack, j = _stack_of(cfg, i)
        yield (stack, j), (lambda i=i: layer(cfg, get, prefix, i))


def hf_to_llama_params(cfg: ModelConfig, tensors: dict, *, prefix: str = "model.") -> dict:
    """Re-lay an HF decoder checkpoint's tensors out into the stacked tree,
    as CPU tensors in the file's dtypes."""
    params: dict[str, Any] = {}
    per_stack: dict[str, list] = {}
    for path, make in _hf_leaves(cfg, tensors, prefix):
        if len(path) == 1:
            params[path[0]] = make().contiguous()
        else:
            per_stack.setdefault(path[0], []).append(make())
    for stack, layers in per_stack.items():
        params[stack] = {k: torch.stack([lp[k] for lp in layers]) for k in layers[0]}
    return params


def load_llama_checkpoint(
    cfg: ModelConfig,
    ckpt_dir: str,
    *,
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cpu",
    prefix: str = "model.",
) -> dict:
    """An HF safetensors directory into the device tree in `dtype`: each
    stacked leaf is allocated on the device once and filled one layer at a
    time, so the host holds one layer's converted tensors at a time. Every
    key and shape is checked against `param_shapes(cfg)`; a missing tensor
    raises KeyError naming it."""
    tensors = read_checkpoint_dir(ckpt_dir)
    expected = param_shapes(cfg)
    params: dict[str, Any] = {}

    def put(dst: torch.Tensor | None, src: torch.Tensor, want, what: str) -> torch.Tensor:
        if tuple(src.shape) != tuple(want):
            raise ValueError(f"{what}: shape {tuple(src.shape)}, expected {tuple(want)}")
        if dst is None:
            return src.to(device=device, dtype=dtype).contiguous()
        dst.copy_(src.to(dtype))
        return dst

    for path, make in _hf_leaves(cfg, tensors, prefix):
        if len(path) == 1:
            params[path[0]] = put(None, make(), expected[path[0]], path[0])
            continue
        stack, j = path
        spec = expected[stack]
        out = params.setdefault(stack, {})
        lp = make()
        unknown, missing = sorted(set(lp) - set(spec)), sorted(set(spec) - set(lp))
        if unknown or missing:
            raise KeyError(f"{stack}: unknown keys {unknown}, missing keys {missing}")
        for k, t in lp.items():
            if k not in out:
                out[k] = torch.empty(spec[k], dtype=dtype, device=device)
            put(out[k][j], t, spec[k][1:], f"{stack}/{k}[{j}]")
    return params


def llama_to_hf_tensors(cfg: ModelConfig, params: dict, *, prefix: str = "model.") -> dict:
    """The inverse of `hf_to_llama_params`: HF names and [out, in] linears
    (the rope columns of an MLA tree re-interleaved), as CPU tensors; the
    leaves may be tensors or numpy arrays."""
    t = _as_tensor
    out: dict[str, torch.Tensor] = {
        f"{prefix}embed_tokens.weight": t(params["embed"]),
        f"{prefix}norm.weight": t(params["final_norm"]),
    }
    if not cfg.tie_embeddings and "lm_head" in params:
        out["lm_head.weight"] = t(params["lm_head"]).T
    for i in range(cfg.n_layers):
        stack, j = _stack_of(cfg, i)
        lp = {k: t(v)[j] for k, v in params[stack].items()}
        base = f"{prefix}layers.{i}."
        if cfg.kv_lora_rank:
            out.update(_mla_to_hf_layer(cfg, lp, base))
            continue
        for ours, suffix, tr in _layer_map(cfg):
            out[base + suffix] = lp[ours].T if tr else lp[ours]
        if cfg.n_experts:
            out[base + _MOE_GATE] = lp["router"].T
            for ours, hf_w in (("w1e", "w1"), ("w2e", "w2"), ("w3e", "w3")):
                for e in range(cfg.n_experts):
                    out[base + _moe_suffix(e, hf_w)] = lp[ours][e].T
    return {k: v.contiguous() for k, v in out.items()}


def _mla_to_hf_layer(cfg: ModelConfig, lp: dict, base: str) -> dict[str, torch.Tensor]:
    H = cfg.n_heads
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    R = cfg.kv_lora_rank
    inv = _rope_perm(dr, inverse=True)
    q = lp["wq_mla"].reshape(-1, H, dn + dr)
    q = torch.cat([q[..., :dn], q[..., dn:][..., inv]], dim=-1)
    dkv = torch.cat([lp["w_dkv"][..., :R], lp["w_dkv"][..., R:][..., inv]], dim=-1)
    out = {
        base + "input_layernorm.weight": lp["attn_norm"],
        base + "post_attention_layernorm.weight": lp["ffn_norm"],
        base + "self_attn.q_proj.weight": q.reshape(-1, H * (dn + dr)).T,
        base + "self_attn.kv_a_proj_with_mqa.weight": dkv.T,
        base + "self_attn.kv_a_layernorm.weight": lp["kv_norm"],
        base + "self_attn.kv_b_proj.weight": lp["w_ukv"].T,
        base + "self_attn.o_proj.weight": lp["wo_mla"].T,
    }
    mlp = base + "mlp."
    if "router" in lp:
        out[mlp + "gate.weight"] = lp["router"].T
        for ours, hf_w in (("w1e", "gate_proj"), ("w3e", "up_proj"), ("w2e", "down_proj")):
            for e in range(cfg.n_experts):
                out[f"{mlp}experts.{e}.{hf_w}.weight"] = lp[ours][e].T
        if "w1s" in lp:
            for ours, hf_w in (("w1s", "gate_proj"), ("w3s", "up_proj"), ("w2s", "down_proj")):
                out[f"{mlp}shared_experts.{hf_w}.weight"] = lp[ours].T
    else:
        for ours, hf_w in (("w1", "gate_proj"), ("w3", "up_proj"), ("w2", "down_proj")):
            out[f"{mlp}{hf_w}.weight"] = lp[ours].T
    return out


# ---------------------------------------------------------------------------
# HF encoder checkpoints (BERT, nomic_bert) -> the encoder tree
# ---------------------------------------------------------------------------

# (tree key, HF layer suffix, transpose?) of a classic BERT layer
_BERT_LAYER_MAP = [
    ("wq", "attention.self.query.weight", True),
    ("bq", "attention.self.query.bias", False),
    ("wk", "attention.self.key.weight", True),
    ("bk", "attention.self.key.bias", False),
    ("wv", "attention.self.value.weight", True),
    ("bv", "attention.self.value.bias", False),
    ("wo", "attention.output.dense.weight", True),
    ("bo", "attention.output.dense.bias", False),
    ("attn_norm", "attention.output.LayerNorm.weight", False),
    ("attn_norm_b", "attention.output.LayerNorm.bias", False),
    ("w1", "intermediate.dense.weight", True),
    ("b1", "intermediate.dense.bias", False),
    ("w2", "output.dense.weight", True),
    ("b2", "output.dense.bias", False),
    ("ffn_norm", "output.LayerNorm.weight", False),
    ("ffn_norm_b", "output.LayerNorm.bias", False),
]
_LINEAR_BIASES = ("bq", "bk", "bv", "bo", "b1", "b2")
# nomic's gated MLP is flash-attn's GatedMlp, whose forward splits fc1's
# output into (y, gate) and activates the second: fc12 is the activated
# gate (the tree's w1), fc11 the multiplicative path (w3)
_NOMIC_LAYER_MAP = [
    ("wo", "attn.out_proj.weight", True),
    ("attn_norm", "norm1.weight", False),
    ("attn_norm_b", "norm1.bias", False),
    ("w1", "mlp.fc12.weight", True),
    ("w3", "mlp.fc11.weight", True),
    ("w2", "mlp.fc2.weight", True),
    ("ffn_norm", "norm2.weight", False),
    ("ffn_norm_b", "norm2.bias", False),
]
_NOMIC_BIASES = [("bo", "attn.out_proj.bias"), ("b1", "mlp.fc12.bias"),
                 ("b3", "mlp.fc11.bias"), ("b2", "mlp.fc2.bias")]


def hf_to_embedder_params(cfg: ModelConfig, tensors: dict) -> dict:
    """Re-lay an HF encoder checkpoint (BERT or nomic_bert naming) out into
    the stacked encoder tree, as CPU tensors in the file's dtypes. nomic's
    fused Wqkv is split into wq, wk, wv. A missing tensor raises KeyError
    naming it."""
    prefix = "bert." if any(k.startswith("bert.") for k in tensors) else ""

    def opt(name: str) -> torch.Tensor | None:
        t = tensors.get(prefix + name)
        return None if t is None else _as_tensor(t)

    def get(name: str) -> torch.Tensor:
        t = opt(name)
        if t is None:
            raise KeyError(f"checkpoint missing tensor {prefix + name!r}")
        return t

    nomic = any(".attn.Wqkv." in k for k in tensors)
    layers: dict[str, list[torch.Tensor]] = {}
    for i in range(cfg.n_layers):
        lp: dict[str, torch.Tensor] = {}
        if nomic:
            base = f"encoder.layers.{i}."
            lp["wq"], lp["wk"], lp["wv"] = (t.T for t in
                                            get(base + "attn.Wqkv.weight").chunk(3, dim=0))
            if cfg.enc_bias:
                lp["bq"], lp["bk"], lp["bv"] = get(base + "attn.Wqkv.bias").chunk(3, dim=0)
                lp.update({ours: get(base + suffix) for ours, suffix in _NOMIC_BIASES})
            lp.update({ours: get(base + suffix).T if tr else get(base + suffix)
                       for ours, suffix, tr in _NOMIC_LAYER_MAP})
        else:
            base = f"encoder.layer.{i}."
            for ours, suffix, tr in _BERT_LAYER_MAP:
                if ours in _LINEAR_BIASES and not cfg.enc_bias:
                    continue
                if ours.endswith("norm_b") and cfg.enc_norm != "layer":
                    continue
                lp[ours] = get(base + suffix).T if tr else get(base + suffix)
        for k, t in lp.items():
            layers.setdefault(k, []).append(t)

    params: dict[str, Any] = {
        "embed": get("embeddings.word_embeddings.weight"),
        "layers": {k: torch.stack(v) for k, v in layers.items()},
    }
    if cfg.enc_pos == "learned":
        params["pos_embed"] = get("embeddings.position_embeddings.weight")[: cfg.max_seq_len]
    if cfg.type_vocab_size:
        params["type_embed"] = get("embeddings.token_type_embeddings.weight")
    if cfg.enc_post_ln:
        ln = ("emb_ln.weight", "emb_ln.bias") if nomic else (
            "embeddings.LayerNorm.weight", "embeddings.LayerNorm.bias")
        ew, eb = opt(ln[0]), opt(ln[1])
        if ew is None or eb is None:
            raise KeyError("checkpoint missing embedding LayerNorm tensors")
        params["embed_norm"], params["embed_norm_b"] = ew, eb
    else:
        params["final_norm"] = get("final_norm.weight")
    return params


def encoder_to_hf_tensors(cfg: ModelConfig, params: dict, *, naming: str = "bert") -> dict:
    """The inverse of `hf_to_embedder_params`, as CPU tensors; `naming` is
    "bert" (separate q/k/v) or "nomic" (fused Wqkv, fc11/fc12). The leaves
    may be tensors or numpy arrays."""
    t = _as_tensor
    lt = {k: t(v) for k, v in params["layers"].items()}
    out: dict[str, torch.Tensor] = {"embeddings.word_embeddings.weight": t(params["embed"])}
    if "pos_embed" in params:
        out["embeddings.position_embeddings.weight"] = t(params["pos_embed"])
    if "type_embed" in params:
        out["embeddings.token_type_embeddings.weight"] = t(params["type_embed"])
    if cfg.enc_post_ln:
        ln = ("emb_ln.weight", "emb_ln.bias") if naming == "nomic" else (
            "embeddings.LayerNorm.weight", "embeddings.LayerNorm.bias")
        out[ln[0]], out[ln[1]] = t(params["embed_norm"]), t(params["embed_norm_b"])
    else:
        out["final_norm.weight"] = t(params["final_norm"])
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in lt.items()}
        if naming == "nomic":
            base = f"encoder.layers.{i}."
            out[base + "attn.Wqkv.weight"] = torch.cat([lp["wq"].T, lp["wk"].T, lp["wv"].T])
            if cfg.enc_bias:
                out[base + "attn.Wqkv.bias"] = torch.cat([lp["bq"], lp["bk"], lp["bv"]])
                out.update({base + suffix: lp[ours] for ours, suffix in _NOMIC_BIASES})
            out.update({base + suffix: lp[ours].T if tr else lp[ours]
                        for ours, suffix, tr in _NOMIC_LAYER_MAP})
        else:
            base = f"encoder.layer.{i}."
            out.update({base + suffix: lp[ours].T if tr else lp[ours]
                        for ours, suffix, tr in _BERT_LAYER_MAP if ours in lp})
    return {k: v.contiguous() for k, v in out.items()}


def load_embedder_checkpoint(
    cfg: ModelConfig,
    ckpt_dir: str,
    *,
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cpu",
) -> dict:
    """An HF encoder safetensors directory into the device tree in `dtype`
    (encoder checkpoints are small: the host tree is built whole first).
    Every key and shape is checked against the config."""
    host = hf_to_embedder_params(cfg, read_checkpoint_dir(ckpt_dir))

    def leaf(t: torch.Tensor, want: tuple, path: str) -> torch.Tensor:
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"{path}: shape {tuple(t.shape)}, expected {want}")
        return t.to(device=device, dtype=dtype)

    return _convert_tree(host, param_shapes(cfg), "", leaf)


def _convert_tree(node: dict, spec: dict, path: str, leaf: Callable) -> dict:
    """`leaf(value, shape, path)` over a tree whose keys must be `spec`'s;
    a missing or unknown key raises naming it."""
    unknown, missing = sorted(set(node) - set(spec)), sorted(set(spec) - set(node))
    if unknown or missing:
        raise KeyError(
            f"parameter tree {path or '/'}: unknown keys {unknown}, missing keys {missing}")
    out: dict[str, Any] = {}
    for key, want in spec.items():
        val = node[key]
        if isinstance(want, dict):
            if not isinstance(val, dict):
                raise TypeError(f"{path}{key}: expected a sub-tree")
            out[key] = _convert_tree(val, want, f"{path}{key}/", leaf)
        else:
            out[key] = leaf(val, want, f"{path}{key}")
    return out


def write_checkpoint_dir(ckpt_dir: str, tensors: dict, shards: int = 1,
                         config: dict | None = None) -> None:
    """Write HF-named tensors as `shards` safetensors files (about equal
    bytes) with a `model.safetensors.index.json`, and `config` as
    config.json when given."""
    os.makedirs(ckpt_dir, exist_ok=True)
    names = list(tensors)
    total = sum(_as_tensor(tensors[n]).numel() * _as_tensor(tensors[n]).element_size()
                for n in names)
    per = -(-total // max(1, shards))
    groups: list[list[str]] = [[]]
    acc = 0
    for n in names:
        size = _as_tensor(tensors[n]).numel() * _as_tensor(tensors[n]).element_size()
        if groups[-1] and acc + size > per and len(groups) < shards:
            groups.append([])
            acc = 0
        groups[-1].append(n)
        acc += size
    weight_map = {}
    for k, group in enumerate(groups):
        fname = f"model-{k + 1:05d}-of-{len(groups):05d}.safetensors"
        write_safetensors(os.path.join(ckpt_dir, fname), {n: tensors[n] for n in group})
        weight_map.update({n: fname for n in group})
    with open(os.path.join(ckpt_dir, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f)
    if config is not None:
        with open(os.path.join(ckpt_dir, "config.json"), "w") as f:
            json.dump(config, f)


def params_from_numpy(
    tree: dict[str, Any],
    cfg: ModelConfig,
    device: str | torch.device = "cpu",
    dtype: torch.dtype = torch.bfloat16,
) -> dict[str, Any]:
    """Convert a numpy parameter tree, checking every key and shape against
    `cfg`. Raises on a missing key, an unknown key or a wrong shape."""
    fused = any(k in tree.get(stack, {}) for stack in ("layers", "dense_layers")
                for k in ("wqkv", "w13"))
    expected = param_shapes(cfg, fused=fused)

    def tensor(arr, want, path) -> torch.Tensor:
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(want):
            raise ValueError(f"{path}: shape {arr.shape}, expected {want}")
        return torch.from_numpy(np.array(arr, dtype=np.float32)).to(device=device, dtype=dtype)

    def quantized(val: dict, want: tuple, path: str) -> dict[str, torch.Tensor]:
        if set(val) != {"q", "s"}:
            raise KeyError(f"{path}: a quantized leaf holds exactly 'q' and 's', got {sorted(val)}")
        q = np.asarray(val["q"])
        if q.dtype != np.int8 or tuple(q.shape) != tuple(want):
            raise ValueError(f"{path}/q: {q.dtype} {q.shape}, expected int8 {want}")
        # scales are per output channel: the contraction axis drops (the
        # embedding's scales are per row, its last axis drops)
        cut = -1 if path == "embed" else -2
        s_want = tuple(want[:cut]) + (tuple(want[cut + 1:]) if cut == -2 else ())
        return {"q": torch.from_numpy(q.copy()).to(device),
                "s": tensor(val["s"], s_want, f"{path}/s")}

    def leaf(val, want: tuple, path: str):
        return quantized(val, want, path) if isinstance(val, dict) else tensor(val, want, path)

    return _convert_tree(tree, expected, "", leaf)
