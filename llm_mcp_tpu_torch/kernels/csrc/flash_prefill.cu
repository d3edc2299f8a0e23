// flash_prefill_attention: causal, length-masked GQA flash attention over
// fresh prompts, with an optional sliding window, score softcap and scale.
//
// Replaces: llm_mcp_tpu/kernels/attention.py `_flash_prefill_kernel`
// (behind `flash_prefill_attention`). The Pallas kernel holds a whole
// [S, hd] K/V row in VMEM per grid cell and walks key blocks with a
// sequential fori_loop; here each CTA streams 64-key tiles through a
// two-stage shared-memory ring and only up to its causal (and length, and
// window) bound.
//
// Bound on the H100: operations at prompt lengths of a few hundred tokens
// and more (4*hd flops per attended (query, key) pair per head against 2
// bytes per K/V value read once: above the ~295 flops/byte balance point).
// So both products run on the bf16 tensor cores (`wgmma`, the tile of
// tile_attention.cuh), with the next key tile's copy in flight while the
// current one is multiplied. One CTA (one warpgroup) per (64-query tile,
// head, batch row); the KV head is h / G, so the G heads of a KV head each
// read its tiles (from L2 after the first). Rows with lengths[b] = 0
// attend nothing and emit 0.
//
// Layouts: q [B, H, S, hd]; k/v [B, Hkv, S, hd]; lengths [B] int32;
// out [B, H, S, hd]. This library is the head_dim-128 arm; the 64 arm
// (Llama-3.2-1B, Qwen2.5-0.5B) is flash_prefill_hd64.cu, the same kernel on
// the 64-column tile, and the 256 arm (Gemma-2) flash_prefill_hd256.cu, a
// kernel of its own (a TMA producer warp, two consumer warpgroups).

#include "flash_prefill.cuh"

extern "C" int flash_prefill_bf16(const void* q, const void* k, const void* v,
                                  const void* lengths, void* out, int B, int H,
                                  int Hkv, int S, int hd, int window,
                                  float softcap, float scale, void* stream) {
  return launch_flash(q, k, v, lengths, out, B, H, Hkv, S, hd, window, softcap, scale, stream);
}
