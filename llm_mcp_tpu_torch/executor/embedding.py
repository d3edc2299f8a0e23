"""Embedding engine serving `/v1/embeddings` (counterpart of
`llm_mcp_tpu/executor/embedding.py`).

Two architectures serve embeddings, as in the JAX package:

  - encoders (`arch="encoder"`: nomic_bert, BERT, `tiny-embed`) through
    `models/embedder.py:embed_forward`, mean or cls pooling;
  - decoders (Qwen3-Embedding: a Qwen3 causal LM) through
    `models/llama.py:llama_encode`, last-token pooling; on the card each
    layer's attention is the flash prefill kernel.

`embed` tokenizes its inputs (`prepare_ids`: truncated to `max_seq_len`,
and for an encoder tokenizer the trailing [SEP]), runs them in batches of
`max_batch` padded to a pow-2 bucket of the longest input, with the batch
axis padded to a pow-2 too by rows of length 1 whose vectors are dropped,
and truncates each vector to `dimensions` and re-normalizes it
(Matryoshka). One forward runs at a time (a lock); `total_inputs` and
`total_tokens` count what was served. The engine runs on the card unless
the caller asks for the CPU; without CUDA it raises. Multi-device serving
(the JAX engine's `mesh`) is ROADMAP queue 1 item 11.
"""

from __future__ import annotations

import threading
from typing import Any

import numpy as np
import torch

from ..kernels.attention import FLASH_HEAD_DIMS
from ..models.configs import ModelConfig, resolve_config
from ..models.embedder import embed_forward, init_embedder_params, init_embedder_params_quantized
from ..models.llama import init_llama_params, llama_encode
from ..models.quant import (
    fuse_layer_weights,
    gemm_layout,
    init_llama_params_quantized,
    quantize_params,
)
from ..models.weights import has_safetensors, load_embedder_checkpoint, load_llama_checkpoint
from ..utils.device import resolve_device
from .common import pow2_bucket
from .tokenizer import Tokenizer, load_tokenizer


class EmbeddingEngine:
    def __init__(
        self,
        model: str | ModelConfig = "tiny-embed",
        *,
        params: Any = None,
        tokenizer: Tokenizer | None = None,
        max_batch: int = 64,
        max_seq_len: int = 512,
        dtype: torch.dtype = torch.bfloat16,
        seed: int = 0,
        weights_dir: str = "",
        quant: str = "",
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        # a config.json beside the weights describes them and wins over the
        # catalog; a Qwen3-Embedding checkpoint's resolves to a decoder
        self.cfg = resolve_config(model, weights_dir)
        self.decoder_arch = self.cfg.arch != "encoder"
        if self.cfg.kv_lora_rank:
            raise ValueError(f"{self.cfg.name}: MLA models have no embedding path")
        hd = self.cfg.resolved_head_dim
        if self.decoder_arch and self.device.type == "cuda" and hd not in FLASH_HEAD_DIMS:
            raise ValueError(f"{self.cfg.name}: head_dim {hd} has no arm in the flash prefill "
                             f"kernel (head_dim in {FLASH_HEAD_DIMS})")
        self.max_batch = max_batch
        if not self.decoder_arch and self.cfg.enc_pos == "learned":
            # a learned position table has cfg.max_seq_len rows (BERT: 512)
            max_seq_len = min(max_seq_len, self.cfg.max_seq_len)
        self.max_seq_len = max_seq_len
        self.tokenizer: Tokenizer = tokenizer or load_tokenizer(weights_dir)
        self.quant = quant
        self.params = self._params(params, weights_dir, dtype, seed)
        self._fwd = llama_encode if self.decoder_arch else embed_forward
        self._lock = threading.Lock()
        self.total_inputs = 0
        self.total_tokens = 0

    def _params(self, params, weights_dir: str, dtype: torch.dtype, seed: int):
        """The weights: given, read from `weights_dir`, or random from
        `seed` (directly in int8 with `quant="int8"`); int8 trees are then
        stored K-contiguous for the int8 GEMM, and a decoder's in the fused
        single-device layout, as the generation engine stores them."""
        cfg, dev, q8 = self.cfg, self.device, self.quant == "int8"
        if params is None and has_safetensors(weights_dir):
            load = load_llama_checkpoint if self.decoder_arch else load_embedder_checkpoint
            params = load(cfg, weights_dir, dtype=dtype, device=dev)
        elif params is None:
            g = torch.Generator(device=dev).manual_seed(seed)
            if self.decoder_arch:
                init = init_llama_params_quantized if q8 else init_llama_params
            else:
                init = init_embedder_params_quantized if q8 else init_embedder_params
            params = init(cfg, g, dtype, device=dev)
        if not q8:
            return params
        params = quantize_params(params)  # a no-op on an int8 tree
        return gemm_layout(fuse_layer_weights(params) if self.decoder_arch else params)

    def prepare_ids(self, text: str) -> list[int]:
        """Token ids of one input as `embed` runs them: truncated to
        `max_seq_len`, and for an encoder tokenizer ending in its [SEP]
        (BERT-family encoders were trained on [CLS] ... [SEP] frames; the
        tokenizer adds [CLS] as bos)."""
        ids = self.tokenizer.encode(text)[: self.max_seq_len]
        eos = getattr(self.tokenizer, "eos_id", -1)
        if not self.decoder_arch and eos is not None and eos >= 0:
            if not ids or ids[-1] != eos:
                ids = ids[: self.max_seq_len - 1] + [eos]
        return ids

    def embed(self, texts: list[str], dimensions: int | None = None
              ) -> tuple[list[list[float]], int]:
        """Encode texts into (vectors, total tokens)."""
        if not texts:
            return [], 0
        all_ids = [self.prepare_ids(t) for t in texts]
        total_tokens = sum(len(i) for i in all_ids)
        vectors: list[list[float]] = []
        with self._lock:
            for i in range(0, len(all_ids), self.max_batch):
                chunk = all_ids[i: i + self.max_batch]
                B = len(chunk)
                Bb = pow2_bucket(B, self.max_batch, floor=1)
                bucket = pow2_bucket(max(len(c) for c in chunk), self.max_seq_len)
                tokens = np.zeros((Bb, bucket), dtype=np.int32)
                lengths = np.ones(Bb, dtype=np.int32)
                for j, ids in enumerate(chunk):
                    tokens[j, : len(ids)] = ids
                    lengths[j] = len(ids)
                out = self._fwd(self.cfg, self.params,
                                torch.from_numpy(tokens).to(self.device),
                                torch.from_numpy(lengths).to(self.device))
                out = out.cpu().numpy()[:B]
                if dimensions and 0 < dimensions < out.shape[1]:
                    out = out[:, :dimensions]
                    out = out / np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-9)
                vectors.extend(out.tolist())
            self.total_inputs += len(texts)
            self.total_tokens += total_tokens
        return vectors, total_tokens

    def stats(self) -> dict:
        return {"device": str(self.device), "arch": "decoder" if self.decoder_arch else "encoder",
                "quant": self.quant, "max_batch": self.max_batch,
                "max_seq_len": self.max_seq_len, "total_inputs": self.total_inputs,
                "total_tokens": self.total_tokens}
