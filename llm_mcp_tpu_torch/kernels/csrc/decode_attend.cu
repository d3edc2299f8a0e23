// decode_attend_bf16: one-position GQA decode attention over the
// PRE-append bf16 cache (flash-decoding).
//
// Replaces: llm_mcp_tpu/kernels/attention.py `_attend_bf16_kernel` (whole-S
// arm) and `_attend_bf16_blocked_kernel` (blocked arm), both behind
// `decode_attend_bf16`. The Pallas wrapper picks between the two arms at
// run time because a whole row may not fit VMEM; that split has no Hopper
// counterpart. This kernel reads only the attended prefix [0, w] of every
// row, whatever its length.
//
// Bound on the H100: bytes. Each row reads (w+1)*Hkv*hd values of K and of
// V once and does 4*G flops per value read (G = 4 for Llama-3.1-8B), far
// below the ~295 flops per byte where compute would bind. So the design
// spreads the read over as many SMs as it can: one CTA per (row, KV head,
// split of [0, w]), each streaming 64-position tiles of K and V with
// 16-byte coalesced loads. The G query heads of a KV head share every
// tile. Each split keeps an online softmax in f32 and writes its partial
// (m, l, acc); a second small kernel combines the splits. Splits past w
// exit at once, so a short row costs a few CTAs, not S/chunk of them.
//
// Position w takes this step's exact new_k/new_v (the cache does not hold
// them yet: the append runs after all layers). A row parked at w >= S
// attends its new vectors alone (w is clamped to 0) and reads no cache.
//
// Paged arm (`decode_attend_bf16_paged`). Replaces
// `_attend_bf16_paged_kernel` (same file), whose Pallas body streams each
// bt-token block with its own DMA, resolved through the row's block table
// to an arena home or a prefix-pool row. Here the split kernel is the same
// with one change: every key position p of cache row `row` finds its K/V
// through tbl[row * nbs + p / bt] (paged.cuh), so a 64-key tile may span
// two blocks (bt = 32) or sit inside one (bt >= 64), and blocks may live in
// other slots' arena homes or in the pool. The override at w holds in
// whichever block w lives. The read is the same bytes as the contiguous
// arm plus one 4-byte table entry per key (L1-resident), so the bound is
// unchanged.
//
// Layouts: q [Ba, Hkv, G, hd]; new_k/new_v [Ba, Hkv, hd];
// cache [L, B, Hkv, S, hd]; lengths/slot_ids [Ba] int32; out like q;
// paged: tbl [B, nbs] int32, pool [L, PXB, Hkv, bt, hd].

#include "paged.cuh"

namespace {

constexpr int HD = 128;    // head_dim this kernel is built for
constexpr int DK = 64;     // key positions per tile
constexpr int MAXG = 8;    // most query heads per KV head
constexpr int KPAD = HD + 1;  // padded K row: conflict-free column reads
constexpr int THREADS = 128;  // one thread per output dim in the PV phase

constexpr size_t SMEM_FLOATS = MAXG * HD + DK * KPAD + DK * HD + MAXG * DK;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);

template <bool PAGED>
__global__ void __launch_bounds__(THREADS)
decode_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ nk,
                    const bf16* __restrict__ nv, const bf16* __restrict__ ck,
                    const bf16* __restrict__ cv, const int* __restrict__ lengths,
                    const int* __restrict__ slot_ids, float* __restrict__ pm,
                    float* __restrict__ pl, float* __restrict__ pacc, int layer,
                    int B, int Hkv, int G, int S, int chunk, int nsplit,
                    float scale, PagedKV pkv) {
  extern __shared__ float sm[];
  float* qs = sm;                 // [MAXG][HD] scaled queries
  float* ks = qs + MAXG * HD;     // [DK][KPAD]
  float* vs = ks + DK * KPAD;     // [DK][HD]
  float* ps = vs + DK * HD;       // [MAXG][DK] scores, then probabilities
  __shared__ float m_s[MAXG], l_s[MAXG], a_s[MAXG];

  const int sp = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int w = lengths[b];
  const bool parked = (w < 0 || w >= S);
  const int we = parked ? 0 : w;  // last attended position
  const int lo = sp * chunk;
  const int hi = min(lo + chunk, we + 1);  // exclusive
  const size_t pidx = ((size_t)b * Hkv + h) * nsplit + sp;
  if (lo >= hi) {  // nothing to attend in this split: the combine skips l == 0
    if (tid < G) {
      pm[pidx * G + tid] = NEG_BIG;
      pl[pidx * G + tid] = 0.f;
    }
    return;
  }
  const int row = slot_ids[b];
  const bf16* qp = q + ((size_t)b * Hkv + h) * G * HD;
  for (int i = tid; i < G * HD; i += THREADS) qs[i] = __bfloat162float(qp[i]) * scale;
  if (tid < G) {
    m_s[tid] = NEG_BIG;
    l_s[tid] = 0.f;
  }
  const size_t cache_row = (((size_t)layer * B + row) * Hkv + h) * (size_t)S * HD;
  const bf16* kbase = ck + cache_row;
  const bf16* vbase = cv + cache_row;
  const bf16* nkp = nk + ((size_t)b * Hkv + h) * HD;
  const bf16* nvp = nv + ((size_t)b * Hkv + h) * HD;

  float acc[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) acc[g] = 0.f;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  __syncthreads();

  for (int t0 = lo; t0 < hi; t0 += DK) {
    const int nkeys = min(DK, hi - t0);
    // K/V tile into shared memory, 16 bytes per load
    for (int c = tid; c < DK * (HD / 8); c += THREADS) {
      const int kk = c / (HD / 8);
      const int d0 = (c % (HD / 8)) * 8;
      float kf[8], vf[8];
      if (kk < nkeys) {
        const int pos = t0 + kk;
        if (pos == we) {
          load8(nkp + d0, kf);
          load8(nvp + d0, vf);
        } else if constexpr (PAGED) {
          const bf16* kp;
          const bf16* vp;
          paged_row(pkv, ck, cv, layer, B, Hkv, h, S, HD, row, pos, kp, vp);
          load8(kp + d0, kf);
          load8(vp + d0, vf);
        } else {
          load8(kbase + (size_t)pos * HD + d0, kf);
          load8(vbase + (size_t)pos * HD + d0, vf);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kf[e] = vf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        ks[kk * KPAD + d0 + e] = kf[e];
        vs[kk * HD + d0 + e] = vf[e];
      }
    }
    __syncthreads();
    // scores: thread -> one key, every (THREADS / DK)-th head
    {
      const int kk = tid % DK;
      for (int g = tid / DK; g < G; g += THREADS / DK) {
        float s = 0.f;
        const float* qg = qs + g * HD;
        const float* kr = ks + kk * KPAD;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) s = fmaf(qg[d], kr[d], s);
        ps[g * DK + kk] = (kk < nkeys) ? s : NEG_BIG;
      }
    }
    __syncthreads();
    // online softmax: one warp per head
    for (int g = wid; g < G; g += THREADS / 32) {
      const float s0 = ps[g * DK + lane];
      const float s1 = ps[g * DK + lane + 32];
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = (lane < nkeys) ? __expf(s0 - m_new) : 0.f;
      const float p1 = (lane + 32 < nkeys) ? __expf(s1 - m_new) : 0.f;
      const float sum = warp_sum(p0 + p1);
      ps[g * DK + lane] = p0;
      ps[g * DK + lane + 32] = p1;
      if (lane == 0) {
        const float alpha = __expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // PV: thread -> one output dim, all heads
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        float a = acc[g] * a_s[g];
        const float* pg = ps + g * DK;
        for (int kk = 0; kk < nkeys; ++kk) a = fmaf(pg[kk], vs[kk * HD + tid], a);
        acc[g] = a;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
    if (g < G) pacc[(pidx * G + g) * HD + tid] = acc[g];
  if (tid < G) {
    pm[pidx * G + tid] = m_s[tid];
    pl[pidx * G + tid] = l_s[tid];
  }
}

// Combine the splits of one (row, KV head): out = sum_s e^(m_s - M) acc_s /
// sum_s e^(m_s - M) l_s over the splits that attended anything.
__global__ void __launch_bounds__(THREADS)
decode_combine_kernel(const float* __restrict__ pm, const float* __restrict__ pl,
                      const float* __restrict__ pacc, bf16* __restrict__ out,
                      int Hkv, int G, int nsplit) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  const size_t base = ((size_t)b * Hkv + h) * nsplit;
  for (int g = 0; g < G; ++g) {
    float M = NEG_BIG;
    for (int s = 0; s < nsplit; ++s) {
      const size_t i = (base + s) * G + g;
      if (pl[i] > 0.f) M = fmaxf(M, pm[i]);
    }
    float L = 0.f, o = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const size_t i = (base + s) * G + g;
      if (pl[i] > 0.f) {
        const float e = __expf(pm[i] - M);
        L += pl[i] * e;
        o += pacc[i * HD + d] * e;
      }
    }
    out[(((size_t)b * Hkv + h) * G + g) * HD + d] = __float2bfloat16(L > 0.f ? o / L : 0.f);
  }
}

template <bool PAGED>
int launch(const void* q, const void* nk, const void* nv, const void* ck, const void* cv,
           const void* lengths, const void* slot_ids, void* pm, void* pl, void* pacc,
           void* out, int layer, int B, int Ba, int Hkv, int G, int S, int hd, int chunk,
           int nsplit, float scale, PagedKV pg, void* stream) {
  if (hd != HD || G > MAXG || G < 1 || chunk <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      decode_split_kernel<PAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid(nsplit, Hkv, Ba);
  decode_split_kernel<PAGED><<<grid, THREADS, SMEM_BYTES, st>>>(
      (const bf16*)q, (const bf16*)nk, (const bf16*)nv, (const bf16*)ck,
      (const bf16*)cv, (const int*)lengths, (const int*)slot_ids, (float*)pm,
      (float*)pl, (float*)pacc, layer, B, Hkv, G, S, chunk, nsplit, scale, pg);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  decode_combine_kernel<<<dim3(Hkv, Ba), THREADS, 0, st>>>(
      (const float*)pm, (const float*)pl, (const float*)pacc, (bf16*)out, Hkv,
      G, nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int decode_attend_bf16(const void* q, const void* nk, const void* nv,
                                  const void* ck, const void* cv,
                                  const void* lengths, const void* slot_ids,
                                  void* pm, void* pl, void* pacc, void* out,
                                  int layer, int B, int Ba, int Hkv, int G,
                                  int S, int hd, int chunk, int nsplit,
                                  float scale, void* stream) {
  return launch<false>(q, nk, nv, ck, cv, lengths, slot_ids, pm, pl, pacc, out, layer, B,
                       Ba, Hkv, G, S, hd, chunk, nsplit, scale, PagedKV{}, stream);
}

extern "C" int decode_attend_bf16_paged(const void* q, const void* nk, const void* nv,
                                        const void* ck, const void* cv,
                                        const void* lengths, const void* slot_ids,
                                        const void* tbl, const void* pool_k,
                                        const void* pool_v, void* pm, void* pl,
                                        void* pacc, void* out, int layer, int B, int Ba,
                                        int Hkv, int G, int S, int hd, int chunk,
                                        int nsplit, int nbs, int bt, int pxb,
                                        float scale, void* stream) {
  if (nbs <= 0 || bt <= 0 || nbs * bt != S || pxb <= 0) return (int)cudaErrorInvalidValue;
  const PagedKV pg{(const int*)tbl, (const bf16*)pool_k, (const bf16*)pool_v, nbs, bt, pxb};
  return launch<true>(q, nk, nv, ck, cv, lengths, slot_ids, pm, pl, pacc, out, layer, B,
                      Ba, Hkv, G, S, hd, chunk, nsplit, scale, pg, stream);
}
