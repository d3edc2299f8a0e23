// ragged_prefill_attend_bf16 / _q8, identity and block tables, at head_dim
// 64 (Llama-3.2-1B: G = 4 over 8 KV heads; Qwen2.5-0.5B: G = 7 over 2): the
// kernels of ragged_prefill.cu (ragged_prefill.cuh) on the tile built for
// 64 columns (tile_attention.cuh). A CTA keeps its floor(64/G) tokens' G
// query heads as 64 (G = 4) or 63 (G = 7) query rows; an int8 key row is 64
// bytes, four 16-byte copies into the staging ring.
//
// Replaces: llm_mcp_tpu/kernels/attention.py `_ragged_prefill_bf16_kernel`
// and `_ragged_prefill_q8_kernel`, identity and block-table paths, which
// JAX runs at head_dim 64 (`pallas_supported`).
//
// Bound on the H100: operations, as the 128 arm (4*hd flops per attended
// (token, key) pair per query head).

#define TILE_HD 64
#include "ragged_prefill.cuh"

extern "C" int ragged_prefill_bf16_hd64(const void* q, const void* ks, const void* vs,
                                        const void* ck, const void* cv, const void* rowids,
                                        const void* offsets, const void* slots,
                                        const void* starts, void* out, int layer, int T,
                                        int R, int B, int Hkv, int G, int S, int hd,
                                        float scale, void* stream) {
  return launch<false>(q, ks, vs, ck, cv, rowids, offsets, slots, starts, out, layer, T, R,
                       B, Hkv, G, S, hd, scale, PagedKV{}, stream);
}

extern "C" int ragged_prefill_bf16_paged_hd64(const void* q, const void* ks, const void* vs,
                                              const void* ck, const void* cv,
                                              const void* rowids, const void* offsets,
                                              const void* slots, const void* starts,
                                              const void* tbl, const void* pool_k,
                                              const void* pool_v, void* out, int layer, int T,
                                              int R, int B, int Hkv, int G, int S, int hd,
                                              int nbs, int bt, int pxb, float scale,
                                              void* stream) {
  if (nbs <= 0 || bt <= 0 || nbs * bt != S || pxb <= 0) return (int)cudaErrorInvalidValue;
  const PagedKV pg{(const int*)tbl, (const bf16*)pool_k, (const bf16*)pool_v, nbs, bt, pxb};
  return launch<true>(q, ks, vs, ck, cv, rowids, offsets, slots, starts, out, layer, T, R,
                      B, Hkv, G, S, hd, scale, pg, stream);
}

extern "C" int ragged_prefill_q8_hd64(const void* q, const void* ks, const void* vs, const void* cq,
                                      const void* cs, const void* rowids, const void* offsets,
                                      const void* slots, const void* starts, void* out, int layer,
                                      int T, int R, int B, int Hkv, int Hf, int G, int S, int hd,
                                      float scale, void* stream) {
  const FusedQ8 c{(const int8_t*)cq, (const bf16*)cs, nullptr, nullptr, nullptr,
                  B, Hf, 2 * Hkv, S, hd, 0, 0, 0};
  return launch_q8<false>(q, ks, vs, c, rowids, offsets, slots, starts, out, layer, T, R, Hkv,
                          G, hd, scale, stream);
}

extern "C" int ragged_prefill_q8_paged_hd64(const void* q, const void* ks, const void* vs,
                                            const void* cq, const void* cs, const void* rowids,
                                            const void* offsets, const void* slots,
                                            const void* starts, const void* tbl, const void* pool_q,
                                            const void* pool_s, void* out, int layer, int T, int R,
                                            int B, int Hkv, int Hf, int G, int S, int hd, int nbs,
                                            int bt, int pxb, float scale, void* stream) {
  if (nbs <= 0 || bt <= 0 || nbs * bt != S || pxb <= 0) return (int)cudaErrorInvalidValue;
  const FusedQ8 c{(const int8_t*)cq, (const bf16*)cs, (const int*)tbl, (const int8_t*)pool_q,
                  (const bf16*)pool_s, B, Hf, 2 * Hkv, S, hd, nbs, bt, pxb};
  return launch_q8<true>(q, ks, vs, c, rowids, offsets, slots, starts, out, layer, T, R, Hkv, G,
                         hd, scale, stream);
}
