// decode_attend_bf16 / _paged, decode_attend_q8 / _paged (with their fused
// appends) and decode_attention_bf16 at head_dim 64 (Llama-3.2-1B: G = 4
// over 8 KV heads; Qwen2.5-0.5B: G = 7 over 2): the kernels of
// decode_attend.cu (decode_attend.cuh) built with DECODE_HD 64. The bf16
// split kernel reads a row with 8 lanes, a warp four rows at once, in
// 64-key stages; the int8 split kernel keeps a stage's 32 int8 rows in a
// 2 KB slot, two rows a 128-byte swizzle line, and its s8 products run 2
// k-steps; the packed-scale row it appends is 64 bytes (decode_attend.cu
// says how).
//
// Replaces: llm_mcp_tpu/kernels/attention.py `_attend_bf16_kernel`,
// `_attend_bf16_blocked_kernel`, `_attend_bf16_paged_kernel`,
// `_attend_q8_kernel`, `_attend_q8_blocked_kernel`, `_attend_q8_paged_kernel`
// and `_decode_attn_kernel` at head_dim 64, where JAX runs its Pallas
// bodies (`pallas_supported`); the fused appends write what
// `_append_bf16_kernel` / `_append_q8_kernel` would (JAX itself takes its
// XLA scatter below 128 lanes).
//
// Bound on the H100: bytes, as the 128 arm: (w+1)*Hkv*hd K and V values
// read once a row, 4*G flops each.

#define DECODE_HD 64
#include "decode_attend.cuh"

extern "C" int decode_attend_bf16_hd64(const void* q, const void* nk, const void* nv,
                                       const void* ck, const void* cv,
                                       const void* lengths, const void* slot_ids,
                                       void* pm, void* pl, void* pacc, void* out,
                                       int layer, int B, int Ba, int Hkv, int G,
                                       int S, int hd, int chunk, int nsplit,
                                       float scale, int append, void* stream) {
  return launch<false>(q, nk, nv, ck, cv, lengths, slot_ids, pm, pl, pacc, out, layer, B,
                       Ba, Hkv, G, S, hd, chunk, nsplit, scale, PagedKV{}, append != 0, stream);
}

extern "C" int decode_attention_bf16_hd64(const void* q, const void* ck, const void* cv,
                                          const void* lengths, void* pm, void* pl, void* pacc,
                                          void* out, int B, int Hkv, int G, int S, int hd, int chunk,
                                          int nsplit, float scale, void* stream) {
  return launch<false, true>(q, q, q, ck, cv, lengths, nullptr, pm, pl, pacc, out,
                             0, B, B, Hkv, G, S, hd, chunk, nsplit, scale, PagedKV{}, false,
                             stream);
}

extern "C" int decode_attend_bf16_paged_hd64(const void* q, const void* nk, const void* nv,
                                             const void* ck, const void* cv,
                                             const void* lengths, const void* slot_ids,
                                             const void* tbl, const void* pool_k,
                                             const void* pool_v, void* pm, void* pl,
                                             void* pacc, void* out, int layer, int B, int Ba,
                                             int Hkv, int G, int S, int hd, int chunk,
                                             int nsplit, int nbs, int bt, int pxb,
                                             float scale, int append, void* stream) {
  if (nbs <= 0 || bt <= 0 || nbs * bt != S || pxb <= 0) return (int)cudaErrorInvalidValue;
  const PagedKV pg{(const int*)tbl, (const bf16*)pool_k, (const bf16*)pool_v, nbs, bt, pxb};
  return launch<true>(q, nk, nv, ck, cv, lengths, slot_ids, pm, pl, pacc, out, layer, B,
                      Ba, Hkv, G, S, hd, chunk, nsplit, scale, pg, append != 0, stream);
}

// rs: the whole-row arm's workspace, f32 [Ba, Hkv, nsplit, G, 2] (else
// null); append: write this step's K/V row into cq/cs (the fused append)
extern "C" int decode_attend_q8_hd64(const void* q, const void* nk, const void* nv,
                                     void* cq, void* cs, const void* lengths,
                                     const void* slot_ids, void* pm, void* pl, void* pacc,
                                     void* out, int layer, int B, int Ba, int Hkv, int Hf, int G,
                                     int S, int hd, int chunk, int nsplit, int group, float scale,
                                     void* rs, int append, void* stream) {
  const FusedQ8 c{(const int8_t*)cq, (const bf16*)cs, nullptr, nullptr, nullptr,
                  B, Hf, 2 * Hkv, S, hd, 0, 0, 0};
  const Q8Append ap{append ? (int8_t*)cq : nullptr, append ? (bf16*)cs : nullptr};
  return launch_q8<false>(q, nk, nv, c, lengths, slot_ids, pm, pl, pacc, out, layer, Ba, Hkv,
                          G, hd, chunk, nsplit, group, scale, (float*)rs, ap, stream);
}

extern "C" int decode_attend_q8_paged_hd64(const void* q, const void* nk, const void* nv,
                                           void* cq, void* cs, const void* lengths,
                                           const void* slot_ids, const void* tbl,
                                           const void* pool_q, const void* pool_s, void* pm,
                                           void* pl, void* pacc, void* out, int layer, int B,
                                           int Ba, int Hkv, int Hf, int G, int S, int hd,
                                           int chunk, int nsplit, int nbs, int bt, int pxb,
                                           float scale, int append, void* stream) {
  if (nbs <= 0 || bt <= 0 || nbs * bt != S || pxb <= 0) return (int)cudaErrorInvalidValue;
  const FusedQ8 c{(const int8_t*)cq, (const bf16*)cs, (const int*)tbl, (const int8_t*)pool_q,
                  (const bf16*)pool_s, B, Hf, 2 * Hkv, S, hd, nbs, bt, pxb};
  // the append writes the arena row (the slot's own home), as append_kv_q8
  const Q8Append ap{append ? (int8_t*)cq : nullptr, append ? (bf16*)cs : nullptr};
  // the paged arm requantizes per block, as `_attend_q8_paged_kernel`
  return launch_q8<true>(q, nk, nv, c, lengths, slot_ids, pm, pl, pacc, out, layer, Ba, Hkv,
                         G, hd, chunk, nsplit, bt, scale, nullptr, ap, stream);
}
