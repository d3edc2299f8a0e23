// flash_prefill_attention at head_dim 256 (Gemma-2-9B: 16 query heads over
// 8 KV heads, a 4096-token window on alternate layers, score softcap 50,
// scale 224**-0.5): the kernel of flash_prefill.cu on the tile built for
// 256 columns (tile_attention.cuh: two warpgroups over the same 64 query
// rows, each computing the whole Q.K^T and P.V for its 128 output
// columns; 160 KB of shared memory, one CTA an SM).
//
// Replaces: llm_mcp_tpu/kernels/attention.py `_flash_prefill_kernel`, which
// JAX runs at any head_dim that is a multiple of 128 (`pallas_supported`).
//
// Bound on the H100: operations, as the 128 arm, at prompts of a few
// hundred tokens and more; this first arm repeats the Q.K^T product in
// both warpgroups (a quarter more tensor-core work than the bound counts)
// to keep each thread's accumulators at the 128 arm's size.

#define TILE_HD 256
#include "flash_prefill.cuh"

extern "C" int flash_prefill_bf16_hd256(const void* q, const void* k, const void* v,
                                        const void* lengths, void* out, int B, int H,
                                        int Hkv, int S, int hd, int window,
                                        float softcap, float scale, void* stream) {
  return launch_flash(q, k, v, lengths, out, B, H, Hkv, S, hd, window, softcap, scale, stream);
}
