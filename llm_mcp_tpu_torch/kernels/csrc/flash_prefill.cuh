// The flash prefill kernel over the tile of tile_attention.cuh, for the
// head_dim the including source built the tile for (flash_prefill.cu: 128,
// flash_prefill_hd64.cu: 64). See flash_prefill.cu.

#pragma once

#include "tile_attention.cuh"

namespace {

__global__ void __launch_bounds__(tile::THREADS)
flash_prefill_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const int* __restrict__ lengths,
                     bf16* __restrict__ out, int H, int Hkv, int S, int window,
                     float softcap, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const tile::Smem s(smem_raw, q);
  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / Hkv;
  const int q0 = qt * tile::BQ;
  const int len = lengths[b];
  const bf16* qbase = q + ((size_t)b * H + h) * (size_t)S * tile::HD;
  const bf16* kbase = k + ((size_t)b * Hkv + h / G) * (size_t)S * tile::HD;
  const bf16* vbase = v + ((size_t)b * Hkv + h / G) * (size_t)S * tile::HD;

  tile::load_q(s, [&](int r) -> const bf16* {
    return q0 + r < S ? qbase + (size_t)(q0 + r) * tile::HD : nullptr;
  });
  tile::State st;
  st.init();

  // keys this tile can see: [kmin, kmax]
  const int kmax = min(min(q0 + tile::BQ - 1, len - 1), S - 1);
  const int kmin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kstart = (kmin / tile::BK) * tile::BK;
  const int ntiles = kmax >= kstart ? (kmax - kstart) / tile::BK + 1 : 0;
  tile::run<false>(
      s, st, ntiles, S - kstart,
      [&](int i, int kk) {
        const size_t off = (size_t)(kstart + i * tile::BK + kk) * tile::HD;
        return tile::Key{kbase + off, vbase + off, 0.f, 0.f, 0};
      },
      [&](int i, int r, int kk, int) {
        const int qp = q0 + r;
        const int kp = kstart + i * tile::BK + kk;
        return kp <= qp && kp < len && (window <= 0 || qp - kp < window);
      },
      scale, softcap);
  bf16* obase = out + ((size_t)b * H + h) * (size_t)S * tile::HD;
  tile::store(st, [&](int r) -> bf16* {
    return q0 + r < S ? obase + (size_t)(q0 + r) * tile::HD : nullptr;
  });
}

// The launch, for the tile's head_dim (tile::HD) alone.
int launch_flash(const void* q, const void* k, const void* v, const void* lengths, void* out,
                 int B, int H, int Hkv, int S, int hd, int window, float softcap, float scale,
                 void* stream) {
  if (hd != tile::HD || Hkv < 1 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(flash_prefill_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)tile::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + tile::BQ - 1) / tile::BQ, H, B);
  flash_prefill_kernel<<<grid, tile::THREADS, tile::SMEM_BYTES, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)lengths, (bf16*)out,
      H, Hkv, S, window, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

