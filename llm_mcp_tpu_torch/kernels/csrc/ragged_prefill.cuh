// The ragged prefill kernels (bf16 and int8, identity and block tables)
// over the tile of tile_attention.cuh, for the head_dim the including source
// built the tile for (ragged_prefill.cu: 128, ragged_prefill_hd64.cu: 64).
// See ragged_prefill.cu.

#pragma once

#include "paged.cuh"
#include "tile_attention.cuh"

namespace {

// Per-CTA query rows: packed token (-1: none) and descriptor row (R: pad).
struct Rows {
  int tok[tile::BQ];
  int rid[tile::BQ];
};

// Query rows, Q load and the chunk's own segment, shared by both kernels:
// tokens [u_lo, t_last] in 64-key tiles, same descriptor row and packed
// index <= the query's (the pads attend earlier pads). Rows past TQ*G
// (G not dividing 64) hold no token: tok -1, rid -1, zero queries.
__device__ __forceinline__ int setup_rows(Rows& rows, const tile::Smem& s, const bf16* q,
                                          const int* rowids, int T, int Hkv, int G, int h,
                                          int t0) {
  const int tid = threadIdx.x;
  const int TQ = tile::BQ / G;
  // row r's packed token, or T (none) for a padding row
  auto token = [&](int r) { return r < TQ * G ? t0 + r / G : T; };
  if (tid < tile::BQ) {
    const int t = token(tid);
    rows.tok[tid] = t < T ? t : -1;
    rows.rid[tid] = t < T ? rowids[t] : -1;
  }
  tile::load_q(s, [&](int r) -> const bf16* {
    const int t = token(r);
    return t < T ? q + (((size_t)t * Hkv + h) * G + r % G) * tile::HD : nullptr;
  });
  __syncthreads();
  return min(t0 + TQ, T) - 1;
}

__device__ __forceinline__ void self_segment(const tile::Smem& s, tile::State& st,
                                             const Rows& rows, const bf16* ks, const bf16* vs,
                                             const int* rowids, const int* offsets, int T,
                                             int R, int Hkv, int h, int t0, int t_last,
                                             float scale) {
  const int rid0 = t0 < T ? rowids[t0] : R;
  const int u_lo = offsets[min(max(rid0, 0), R)];
  const int n = t_last + 1 - u_lo;
  tile::run<false>(
      s, st, n > 0 ? (n + tile::BK - 1) / tile::BK : 0, n,
      [&](int i, int kk) {
        const int u = u_lo + i * tile::BK + kk;
        const size_t off = ((size_t)u * Hkv + h) * tile::HD;
        return tile::Key{ks + off, vs + off, 0.f, 0.f, rowids[u]};
      },
      [&](int i, int qr, int kk, int rid) {
        return rows.tok[qr] >= u_lo + i * tile::BK + kk && rid == rows.rid[qr];
      },
      scale, 0.f);
}

__device__ __forceinline__ void store_rows(const tile::State& st, const Rows& rows, bf16* out,
                                           int Hkv, int G, int h) {
  tile::store(st, [&](int r) -> bf16* {
    const int t = rows.tok[r];
    return t >= 0 ? out + (((size_t)t * Hkv + h) * G + r % G) * tile::HD : nullptr;
  });
}

template <bool PAGED>
__global__ void __launch_bounds__(tile::THREADS)
ragged_prefill_kernel(const bf16* __restrict__ q, const bf16* __restrict__ ks,
                      const bf16* __restrict__ vs, const bf16* __restrict__ ck,
                      const bf16* __restrict__ cv, const int* __restrict__ rowids,
                      const int* __restrict__ offsets, const int* __restrict__ slots,
                      const int* __restrict__ starts, bf16* __restrict__ out,
                      int layer, int T, int R, int B, int Hkv, int G, int S,
                      float scale, PagedKV pg) {
  extern __shared__ unsigned char smem_raw[];
  const tile::Smem s(smem_raw, q);
  __shared__ Rows rows;
  const int t0 = blockIdx.x * (tile::BQ / G);
  const int h = blockIdx.y;
  const int t_last = setup_rows(rows, s, q, rowids, T, Hkv, G, h, t0);
  tile::State st;
  st.init();

  // (a) cached prefix of every row with tokens in this tile
  for (int r = 0; r < R; ++r) {
    const int lo = offsets[r];
    const int hi = offsets[r + 1];
    const int start = min(starts[r], S);
    if (hi <= lo || lo > t_last || hi <= t0 || start <= 0) continue;
    const size_t base = (((size_t)layer * B + slots[r]) * Hkv + h) * (size_t)S * tile::HD;
    tile::run<false>(
        s, st, (start + tile::BK - 1) / tile::BK, start,
        [&](int i, int kk) {
          const int pos = i * tile::BK + kk;
          const bf16* kp;
          const bf16* vp;
          if constexpr (PAGED) {
            paged_row(pg, ck, cv, layer, B, Hkv, h, S, tile::HD, r, pos, kp, vp);
          } else {
            kp = ck + base + (size_t)pos * tile::HD;
            vp = cv + base + (size_t)pos * tile::HD;
          }
          return tile::Key{kp, vp, 0.f, 0.f, 0};
        },
        [&](int, int qr, int, int) { return rows.rid[qr] == r; }, scale, 0.f);
  }
  // (b) the chunk's own keys
  self_segment(s, st, rows, ks, vs, rowids, offsets, T, R, Hkv, h, t0, t_last, scale);
  store_rows(st, rows, out, Hkv, G, h);
}

template <bool PAGED>
int launch(const void* q, const void* ks, const void* vs, const void* ck, const void* cv,
           const void* rowids, const void* offsets, const void* slots, const void* starts,
           void* out, int layer, int T, int R, int B, int Hkv, int G, int S, int hd,
           float scale, PagedKV pg, void* stream) {
  if (hd != tile::HD || G < 1 || G > tile::BQ) return (int)cudaErrorInvalidValue;
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
// The past keys are copied as int8 and widened to bf16 in shared memory
// (exact; no requantization of q or p to int8); the scores take kss after
// Q.K^T and the probabilities vss before P.V (the tile's `Q8` step), the
// plain scales read from "s" through the same table entry as the payload,
// as the Pallas wrapper pre-gathers them (attention.py:3503-3509). The
// self segment is the exact bf16 step.
template <bool PAGED>
__global__ void __launch_bounds__(tile::THREADS)
ragged_prefill_q8_kernel(const bf16* __restrict__ q, const bf16* __restrict__ ks,
                         const bf16* __restrict__ vs, FusedQ8 c,
                         const int* __restrict__ rowids, const int* __restrict__ offsets,
                         const int* __restrict__ slots, const int* __restrict__ starts,
                         bf16* __restrict__ out, int layer, int T, int R, int Hkv, int G,
                         float scale) {
  extern __shared__ unsigned char smem_raw[];
  const tile::Smem s(smem_raw, q);
  __shared__ Rows rows;
  const int t0 = blockIdx.x * (tile::BQ / G);
  const int h = blockIdx.y;
  const int t_last = setup_rows(rows, s, q, rowids, T, Hkv, G, h, t0);
  tile::State st;
  st.init();

  for (int r = 0; r < R; ++r) {
    const int lo = offsets[r];
    const int hi = offsets[r + 1];
    const int start = min(starts[r], c.S);
    if (hi <= lo || lo > t_last || hi <= t0 || start <= 0) continue;
    const int trow = PAGED ? r : slots[r];
    tile::run<true>(
        s, st, (start + tile::BK - 1) / tile::BK, start,
        [&](int i, int kk) {
          const KeyHome home = q8_home<PAGED>(c, trow, i * tile::BK + kk);
          return tile::Key{q8_payload(c, home, layer, h), q8_payload(c, home, layer, Hkv + h),
                           q8_scale(c, home, layer, h), q8_scale(c, home, layer, Hkv + h), 0};
        },
        [&](int, int qr, int, int) { return rows.rid[qr] == r; }, scale, 0.f);
  }
  self_segment(s, st, rows, ks, vs, rowids, offsets, T, R, Hkv, h, t0, t_last, scale);
  store_rows(st, rows, out, Hkv, G, h);
}

template <bool PAGED>
int launch_q8(const void* q, const void* ks, const void* vs, const FusedQ8& c,
              const void* rowids, const void* offsets, const void* slots, const void* starts,
              void* out, int layer, int T, int R, int Hkv, int G, int hd, float scale,
              void* stream) {
  if (hd != tile::HD || G < 1 || G > tile::BQ || c.Hs != 2 * Hkv ||
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

