// flash_prefill_attention: causal, length-masked GQA flash attention over
// fresh prompts, with an optional sliding window, score softcap and scale.
//
// Replaces: llm_mcp_tpu/kernels/attention.py `_flash_prefill_kernel`
// (behind `flash_prefill_attention`). The Pallas kernel holds a whole
// [S, hd] K/V row in VMEM per grid cell and walks key blocks with a
// sequential fori_loop; here each CTA streams 64-key tiles through shared
// memory and only up to its causal (and length, and window) bound.
//
// Bound on the H100: operations. The work is 4*hd flops per attended
// (query, key) pair per head, against 2 bytes per K/V value read once; at
// prompt lengths of a few hundred tokens that is above the H100's ~295
// flops/byte balance point. This first version does the two products with
// f32 FMA register tiles (tile_attention.cuh), not tensor cores, so it
// runs far below the bf16 tensor-core peak; its time stands beside the
// bound in PERF.md. One CTA per (batch row, head, 64-query tile); the KV
// head is h / G. Rows with lengths[b] = 0 attend nothing and emit 0.
//
// Layouts: q [B, H, S, hd]; k/v [B, Hkv, S, hd]; lengths [B] int32;
// out [B, H, S, hd].

#include "tile_attention.cuh"

namespace {

__global__ void __launch_bounds__(tile::THREADS)
flash_prefill_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const int* __restrict__ lengths,
                     bf16* __restrict__ out, int H, int Hkv, int S, int window,
                     float softcap, float scale) {
  extern __shared__ float sm[];
  const tile::Smem s(sm);
  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / Hkv;
  const int q0 = qt * tile::BQ;
  const int len = lengths[b];
  const bf16* qbase = q + ((size_t)b * H + h) * (size_t)S * tile::HD;
  const bf16* kbase = k + ((size_t)b * Hkv + h / G) * (size_t)S * tile::HD;
  const bf16* vbase = v + ((size_t)b * Hkv + h / G) * (size_t)S * tile::HD;

  for (int c = threadIdx.x; c < tile::BQ * (tile::HD / 8); c += tile::THREADS) {
    const int r = c / (tile::HD / 8);
    const int d0 = (c % (tile::HD / 8)) * 8;
    const int qp = q0 + r;
    tile::load_q_chunk(s, r, d0, qp < S ? qbase + (size_t)qp * tile::HD : nullptr, scale);
  }
  tile::State st;
  st.init();
  __syncthreads();

  // keys this tile can see: [kmin, kmax]
  const int kmax = min(min(q0 + tile::BQ - 1, len - 1), S - 1);
  const int kmin = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int k0 = (kmin / tile::BK) * tile::BK; k0 <= kmax; k0 += tile::BK) {
    const int nkeys = min(tile::BK, S - k0);
    tile::step(
        s, st, nkeys, softcap,
        [&](int kk, const bf16*& kp, const bf16*& vp) {
          kp = kbase + (size_t)(k0 + kk) * tile::HD;
          vp = vbase + (size_t)(k0 + kk) * tile::HD;
        },
        [&](int r, int kk) {
          const int qp = q0 + r;
          const int kp = k0 + kk;
          return kp <= qp && kp < len && (window <= 0 || qp - kp < window);
        });
  }
  bf16* obase = out + ((size_t)b * H + h) * (size_t)S * tile::HD;
  tile::store(st, [&](int r) -> bf16* {
    const int qp = q0 + r;
    return qp < S ? obase + (size_t)qp * tile::HD : nullptr;
  });
}

}  // namespace

extern "C" int flash_prefill_bf16(const void* q, const void* k, const void* v,
                                  const void* lengths, void* out, int B, int H,
                                  int Hkv, int S, int hd, int window,
                                  float softcap, float scale, void* stream) {
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
