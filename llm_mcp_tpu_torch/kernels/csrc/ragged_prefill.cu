// ragged_prefill_attend_bf16: packed multi-row chunked prefill attention
// over the bf16 cache (unpaged).
//
// Replaces: llm_mcp_tpu/kernels/attention.py `_ragged_prefill_bf16_kernel`
// (behind `ragged_prefill_attend_bf16`), both its identity-table path
// (`ragged_prefill_bf16`) and its block-table path
// (`ragged_prefill_bf16_paged`). In the Pallas body the cached prefix of
// each row streams block by block, each block's DMA resolved through the
// row's table to an arena home or a prefix-pool row (lines 2801-2834). Here the
// paged arm resolves every key position p of descriptor row r through
// tbl[r * nbs + p / bt] (paged.cuh; the wrapper gathers the engine's
// [B, nbs] table to the R rows, as `_ragged_tables` does). A 64-key tile
// may span two blocks (bt = 32), and a block may live in another slot's
// arena home or in the pool. The self segment needs no table.
//
// A [T]-token buffer carries up to R rows' chunks back to back: row r
// holds packed indices [offsets[r], offsets[r+1]); pad tokens after
// offsets[R] carry rowid R. Each token attends (a) its row's cached prefix
// cache[layer, slots[r], h, 0:starts[r]] and (b) the chunk's own K/V for
// the tokens of its row at packed index <= its own. Both feed one online
// softmax. Pads attend earlier pads, so their output is finite; the engine
// drops it.
//
// Bound on the H100: operations, as for flash prefill: 4*hd flops per
// attended (token, key) pair per query head. So both products run on the
// bf16 tensor cores (`wgmma`, the tile of tile_attention.cuh), key tiles
// streaming through a two-stage `cp.async` ring. One CTA (one warpgroup)
// per (tile of TQ = floor(64/G) packed tokens, KV head): its query rows are
// the G query heads of each token, so all G heads share every K/V tile
// read. Where G does not divide 64 (Qwen2.5-7B: G = 7, 9 tokens and 63
// rows; R1-Distill-Qwen-1.5B: G = 6, 10 tokens and 60 rows) the rows past
// TQ*G are padding: they load zeros, attend nothing and store nothing.
// Each descriptor row's prefix and the chunk's own keys are segments of
// tiles; the keys of a tile are resolved once (through the table, for the
// paged arm) before their copies are issued.
//
// Layouts: q [T, Hkv, G, hd]; k_self/v_self [T, Hkv, hd];
// cache [L, B, Hkv, S, hd]; rowids [T], offsets [R+1], slots/starts [R]
// int32; out like q; paged: tbl [R, nbs] int32, pool [L, PXB, Hkv, bt, hd].
// The int8 kernel (ragged_prefill.cuh, after the bf16 one) reads the fused
// cache of decode_attend.cu.
//
// The kernels live in ragged_prefill.cuh. This library is the head_dim-128
// arm; ragged_prefill_hd64.cu is the same kernels on the tile built for 64
// columns (Llama-3.2-1B at G = 4, Qwen2.5-0.5B at G = 7).

#include "ragged_prefill.cuh"

extern "C" int ragged_prefill_bf16(const void* q, const void* ks, const void* vs,
                                   const void* ck, const void* cv, const void* rowids,
                                   const void* offsets, const void* slots,
                                   const void* starts, void* out, int layer, int T,
                                   int R, int B, int Hkv, int G, int S, int hd,
                                   float scale, void* stream) {
  return launch<false>(q, ks, vs, ck, cv, rowids, offsets, slots, starts, out, layer, T, R,
                       B, Hkv, G, S, hd, scale, PagedKV{}, stream);
}

extern "C" int ragged_prefill_bf16_paged(const void* q, const void* ks, const void* vs,
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

extern "C" int ragged_prefill_q8(const void* q, const void* ks, const void* vs, const void* cq,
                                 const void* cs, const void* rowids, const void* offsets,
                                 const void* slots, const void* starts, void* out, int layer,
                                 int T, int R, int B, int Hkv, int Hf, int G, int S, int hd,
                                 float scale, void* stream) {
  const FusedQ8 c{(const int8_t*)cq, (const bf16*)cs, nullptr, nullptr, nullptr,
                  B, Hf, 2 * Hkv, S, hd, 0, 0, 0};
  return launch_q8<false>(q, ks, vs, c, rowids, offsets, slots, starts, out, layer, T, R, Hkv,
                          G, hd, scale, stream);
}

extern "C" int ragged_prefill_q8_paged(const void* q, const void* ks, const void* vs,
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
