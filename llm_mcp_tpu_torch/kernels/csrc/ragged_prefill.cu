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
// attended (token, key) pair per query head. One CTA per (tile of 64/G
// packed tokens, KV head): its 64 query rows are the G query heads of each
// token, so all G heads share every K/V tile read. Like flash prefill this
// first version computes with f32 FMA register tiles (tile_attention.cuh),
// not tensor cores.
//
// Layouts: q [T, Hkv, G, hd]; k_self/v_self [T, Hkv, hd];
// cache [L, B, Hkv, S, hd]; rowids [T], offsets [R+1], slots/starts [R]
// int32; out like q; paged: tbl [R, nbs] int32, pool [L, PXB, Hkv, bt, hd].
// The int8 kernel (further down) reads the fused cache of decode_attend.cu.

#include "paged.cuh"
#include "tile_attention.cuh"

namespace {

template <bool PAGED>
__global__ void __launch_bounds__(tile::THREADS)
ragged_prefill_kernel(const bf16* __restrict__ q, const bf16* __restrict__ ks,
                      const bf16* __restrict__ vs, const bf16* __restrict__ ck,
                      const bf16* __restrict__ cv, const int* __restrict__ rowids,
                      const int* __restrict__ offsets, const int* __restrict__ slots,
                      const int* __restrict__ starts, bf16* __restrict__ out,
                      int layer, int T, int R, int B, int Hkv, int G, int S,
                      float scale, PagedKV pg) {
  extern __shared__ float sm[];
  const tile::Smem s(sm);
  __shared__ int row_tok[tile::BQ];  // packed token of query row (-1: none)
  __shared__ int row_rid[tile::BQ];  // its descriptor row (R: pad)
  __shared__ int key_rid[tile::BK];  // descriptor row of each self key

  const int TQ = tile::BQ / G;  // tokens per CTA
  const int t0 = blockIdx.x * TQ;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  if (tid < tile::BQ) {
    const int t = t0 + tid / G;
    row_tok[tid] = t < T ? t : -1;
    row_rid[tid] = t < T ? rowids[t] : -1;
  }
  for (int c = tid; c < tile::BQ * (tile::HD / 8); c += tile::THREADS) {
    const int r = c / (tile::HD / 8);
    const int d0 = (c % (tile::HD / 8)) * 8;
    const int t = t0 + r / G;
    const int g = r % G;
    tile::load_q_chunk(
        s, r, d0, t < T ? q + (((size_t)t * Hkv + h) * G + g) * tile::HD : nullptr, scale);
  }
  tile::State st;
  st.init();
  __syncthreads();

  const int t_last = min(t0 + TQ, T) - 1;
  // (a) cached prefix of every row with tokens in this tile
  for (int r = 0; r < R; ++r) {
    const int lo = offsets[r];
    const int hi = offsets[r + 1];
    const int start = min(starts[r], S);
    if (hi <= lo || lo > t_last || hi <= t0 || start <= 0) continue;
    const bf16* kbase = ck + (((size_t)layer * B + slots[r]) * Hkv + h) * (size_t)S * tile::HD;
    const bf16* vbase = cv + (((size_t)layer * B + slots[r]) * Hkv + h) * (size_t)S * tile::HD;
    for (int k0 = 0; k0 < start; k0 += tile::BK) {
      const int nkeys = min(tile::BK, start - k0);
      tile::step(
          s, st, nkeys, 0.f,
          [&](int kk, const bf16*& kp, const bf16*& vp) {
            if constexpr (PAGED) {
              paged_row(pg, ck, cv, layer, B, Hkv, h, S, tile::HD, r, k0 + kk, kp, vp);
            } else {
              kp = kbase + (size_t)(k0 + kk) * tile::HD;
              vp = vbase + (size_t)(k0 + kk) * tile::HD;
            }
          },
          [&](int qr, int kk) { return row_rid[qr] == r; });
    }
  }
  // (b) the chunk's own keys: from the first row's start up to the tile's
  // last token, same row and packed index <= the query's
  const int rid0 = t0 < T ? rowids[t0] : R;
  const int u_lo = offsets[min(max(rid0, 0), R)];
  for (int u0 = u_lo; u0 <= t_last; u0 += tile::BK) {
    const int nkeys = min(tile::BK, t_last + 1 - u0);
    if (tid < tile::BK) key_rid[tid] = tid < nkeys ? rowids[u0 + tid] : -2;
    tile::step(
        s, st, nkeys, 0.f,
        [&](int kk, const bf16*& kp, const bf16*& vp) {
          kp = ks + ((size_t)(u0 + kk) * Hkv + h) * tile::HD;
          vp = vs + ((size_t)(u0 + kk) * Hkv + h) * tile::HD;
        },
        [&](int qr, int kk) {
          return row_tok[qr] >= u0 + kk && key_rid[kk] == row_rid[qr];
        });
  }
  tile::store(st, [&](int r) -> bf16* {
    const int t = row_tok[r];
    return t >= 0 ? out + (((size_t)t * Hkv + h) * G + r % G) * tile::HD : nullptr;
  });
}

template <bool PAGED>
int launch(const void* q, const void* ks, const void* vs, const void* ck, const void* cv,
           const void* rowids, const void* offsets, const void* slots, const void* starts,
           void* out, int layer, int T, int R, int B, int Hkv, int G, int S, int hd,
           float scale, PagedKV pg, void* stream) {
  if (hd != tile::HD || G < 1 || tile::BQ % G != 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(ragged_prefill_kernel<PAGED>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)tile::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const int TQ = tile::BQ / G;
  dim3 grid((T + TQ - 1) / TQ, Hkv);
  ragged_prefill_kernel<PAGED><<<grid, tile::THREADS, tile::SMEM_BYTES, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)ks, (const bf16*)vs, (const bf16*)ck, (const bf16*)cv,
      (const int*)rowids, (const int*)offsets, (const int*)slots, (const int*)starts,
      (bf16*)out, layer, T, R, B, Hkv, G, S, scale, pg);
  return (int)cudaGetLastError();
}


// ragged_prefill_attend_q8 / _q8_paged: the same packed layout over the
// fused int8 cache. Replaces `_ragged_prefill_q8_kernel` (behind
// `ragged_prefill_attend_q8`), its identity-table and block-table paths.
// The past keys arrive as int8 (8 bytes a load, converted on load, no
// requantization); the scores take kss after the dot and the probabilities
// vss before P.V (`tile::step_q8`), the plain scales read from "s" through
// the same table entry as the payload, as the Pallas wrapper pre-gathers
// them (attention.py:3503-3509). The self segment is the exact bf16 step.
template <bool PAGED>
__global__ void __launch_bounds__(tile::THREADS)
ragged_prefill_q8_kernel(const bf16* __restrict__ q, const bf16* __restrict__ ks,
                         const bf16* __restrict__ vs, FusedQ8 c,
                         const int* __restrict__ rowids, const int* __restrict__ offsets,
                         const int* __restrict__ slots, const int* __restrict__ starts,
                         bf16* __restrict__ out, int layer, int T, int R, int Hkv, int G,
                         float scale) {
  extern __shared__ float sm[];
  const tile::Smem s(sm);
  __shared__ int row_tok[tile::BQ];
  __shared__ int row_rid[tile::BQ];
  __shared__ int key_rid[tile::BK];

  const int TQ = tile::BQ / G;
  const int t0 = blockIdx.x * TQ;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  if (tid < tile::BQ) {
    const int t = t0 + tid / G;
    row_tok[tid] = t < T ? t : -1;
    row_rid[tid] = t < T ? rowids[t] : -1;
  }
  for (int i = tid; i < tile::BQ * (tile::HD / 8); i += tile::THREADS) {
    const int r = i / (tile::HD / 8);
    const int d0 = (i % (tile::HD / 8)) * 8;
    const int t = t0 + r / G;
    tile::load_q_chunk(
        s, r, d0, t < T ? q + (((size_t)t * Hkv + h) * G + r % G) * tile::HD : nullptr, scale);
  }
  tile::State st;
  st.init();
  __syncthreads();

  const int t_last = min(t0 + TQ, T) - 1;
  for (int r = 0; r < R; ++r) {
    const int lo = offsets[r];
    const int hi = offsets[r + 1];
    const int start = min(starts[r], c.S);
    if (hi <= lo || lo > t_last || hi <= t0 || start <= 0) continue;
    const int trow = PAGED ? r : slots[r];
    for (int k0 = 0; k0 < start; k0 += tile::BK) {
      tile::step_q8(
          s, st, min(tile::BK, start - k0),
          [&](int kk, const int8_t*& kp, const int8_t*& vp, float& kscale, float& vscale) {
            const KeyHome home = q8_home<PAGED>(c, trow, k0 + kk);
            kp = q8_payload(c, home, layer, h);
            vp = q8_payload(c, home, layer, Hkv + h);
            kscale = q8_scale(c, home, layer, h);
            vscale = q8_scale(c, home, layer, Hkv + h);
          },
          [&](int qr, int kk) { return row_rid[qr] == r; });
    }
  }
  const int rid0 = t0 < T ? rowids[t0] : R;
  const int u_lo = offsets[min(max(rid0, 0), R)];
  for (int u0 = u_lo; u0 <= t_last; u0 += tile::BK) {
    const int nkeys = min(tile::BK, t_last + 1 - u0);
    if (tid < tile::BK) key_rid[tid] = tid < nkeys ? rowids[u0 + tid] : -2;
    tile::step(
        s, st, nkeys, 0.f,
        [&](int kk, const bf16*& kp, const bf16*& vp) {
          kp = ks + ((size_t)(u0 + kk) * Hkv + h) * tile::HD;
          vp = vs + ((size_t)(u0 + kk) * Hkv + h) * tile::HD;
        },
        [&](int qr, int kk) {
          return row_tok[qr] >= u0 + kk && key_rid[kk] == row_rid[qr];
        });
  }
  tile::store(st, [&](int r) -> bf16* {
    const int t = row_tok[r];
    return t >= 0 ? out + (((size_t)t * Hkv + h) * G + r % G) * tile::HD : nullptr;
  });
}

template <bool PAGED>
int launch_q8(const void* q, const void* ks, const void* vs, const FusedQ8& c,
              const void* rowids, const void* offsets, const void* slots, const void* starts,
              void* out, int layer, int T, int R, int Hkv, int G, int hd, float scale,
              void* stream) {
  if (hd != tile::HD || G < 1 || tile::BQ % G != 0 || c.Hs != 2 * Hkv ||
      (c.Hf != c.Hs && c.Hf != c.Hs + 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(ragged_prefill_q8_kernel<PAGED>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)tile::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const int TQ = tile::BQ / G;
  dim3 grid((T + TQ - 1) / TQ, Hkv);
  ragged_prefill_q8_kernel<PAGED><<<grid, tile::THREADS, tile::SMEM_BYTES, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)ks, (const bf16*)vs, c, (const int*)rowids,
      (const int*)offsets, (const int*)slots, (const int*)starts, (bf16*)out, layer, T, R, Hkv,
      G, scale);
  return (int)cudaGetLastError();
}

}  // namespace

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
