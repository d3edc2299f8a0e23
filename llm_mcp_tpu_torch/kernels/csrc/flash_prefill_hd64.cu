// flash_prefill_attention at head_dim 64 (Llama-3.2-1B: 32 query heads over
// 8 KV heads; Qwen2.5-0.5B: 14 over 2): the kernel of flash_prefill.cu on
// the tile built for 64 columns (tile_attention.cuh: one warpgroup, one
// 64-column block, Q.K^T in 4 k-steps and P.V on m64n64k16; about 45 KB of
// shared memory a CTA).
//
// Replaces: llm_mcp_tpu/kernels/attention.py `_flash_prefill_kernel`, which
// JAX runs at head_dim 32 and 64 as well as at multiples of 128
// (`pallas_supported`).
//
// Bound on the H100: operations, as the 128 arm, at prompts of a few
// hundred tokens and more (4*hd flops per attended pair against 2 bytes a
// K/V value); at hd 64 half the flops a pair, so the same prompt is nearer
// the balance point and the softmax's share of a tile's work doubles.

#define TILE_HD 64
#include "flash_prefill.cuh"

extern "C" int flash_prefill_bf16_hd64(const void* q, const void* k, const void* v,
                                       const void* lengths, void* out, int B, int H,
                                       int Hkv, int S, int hd, int window,
                                       float softcap, float scale, void* stream) {
  return launch_flash(q, k, v, lengths, out, B, H, Hkv, S, hd, window, softcap, scale, stream);
}
