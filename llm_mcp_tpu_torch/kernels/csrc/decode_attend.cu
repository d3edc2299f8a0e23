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
// Post-append arm (`decode_attention_bf16`). Replaces
// `_decode_attn_kernel` (behind `decode_attention`), the legacy whole-S
// decode body, which no served path calls: the cache already holds this
// step's K/V, so every key, position w included, comes from the cache
// [B, Hkv, S, hd] (no layer axis, rows are the batch). Its mask is
// inclusive, keys at pos <= lengths[b]: lengths[b] >= S attends all S, and
// lengths[b] < 0 masks every key with the finite -1e30, so JAX's softmax
// weighs all S keys alike and the row is the mean of V over S; here such a
// row attends all S with every score set to 0, the same average. There is
// no parked row. Bound: bytes, as the pre-append arm.
//
// Layouts: q [Ba, Hkv, G, hd]; new_k/new_v [Ba, Hkv, hd];
// cache [L, B, Hkv, S, hd]; lengths/slot_ids [Ba] int32; out like q;
// paged: tbl [B, nbs] int32, pool [L, PXB, Hkv, bt, hd]. The int8 arms
// (further down) read the fused cache {q [L, B, 2*Hkv + p, S, hd] int8,
// s [L, B, 2*Hkv, S] bf16} and its pool {[L, PXB, 2*Hkv + p, bt, hd],
// [L, PXB, 2*Hkv, bt]}.

#include "paged.cuh"

namespace {

constexpr int HD = 128;    // head_dim this kernel is built for
constexpr int DK = 64;     // key positions per tile
constexpr int MAXG = 8;    // most query heads per KV head
constexpr int KPAD = HD + 1;  // padded K row: conflict-free column reads
constexpr int THREADS = 128;  // one thread per output dim in the PV phase

constexpr size_t SMEM_FLOATS = MAXG * HD + DK * KPAD + DK * HD + MAXG * DK;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);

template <bool PAGED, bool POST = false>
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
  // last attended position; POST: a row of w < 0 attends all S uniformly
  const int we = POST ? (w < 0 ? S - 1 : min(w, S - 1)) : parked ? 0 : w;
  const bool uniform = POST && w < 0;
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
  const int row = POST ? b : slot_ids[b];
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
        if (!POST && pos == we) {
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
        ps[g * DK + kk] = (kk < nkeys) ? (uniform ? 0.f : s) : NEG_BIG;
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

template <bool PAGED, bool POST = false>
int launch(const void* q, const void* nk, const void* nv, const void* ck, const void* cv,
           const void* lengths, const void* slot_ids, void* pm, void* pl, void* pacc,
           void* out, int layer, int B, int Ba, int Hkv, int G, int S, int hd, int chunk,
           int nsplit, float scale, PagedKV pg, void* stream) {
  if (hd != HD || G > MAXG || G < 1 || chunk <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(decode_split_kernel<PAGED, POST>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid(nsplit, Hkv, Ba);
  decode_split_kernel<PAGED, POST><<<grid, THREADS, SMEM_BYTES, st>>>(
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


// ---------------------------------------------------------------------------
// decode_attend_q8 / decode_attend_q8_paged: the same split and combine over
// the fused int8 cache.
//
// Replaces `_attend_q8_kernel` (whole-S arm), `_attend_q8_blocked_kernel`
// (blocked arm) and `_attend_q8_paged_kernel` (paged arm), all behind
// `decode_attend_q8`. Their arithmetic is kept: q is requantized per (h, g)
// row (qsc = max(max|q| / 127, 1e-30)), the scores are s8 x s8 -> s32 dots
// (`__dp4a`, four int8 products a lane per instruction) dequantized after
// the dot, s = s32 * (scale * qsc) * kss; position w takes the exact f32
// score and value of new_k/new_v; p * vss is requantized to int8 per group
// of keys with its own psc and the PV product is s8 x s8 -> s32 again,
// acc = acc * alpha + s32 * psc + p_w * new_v.
//
// The requantization group decides the numbers, so it is an argument: the
// JAX blocked arm requantizes per BS keys (the first of 256/128/64/32 that
// divides S), the paged arm per bt, the whole-S arm per S. A split (256
// keys) holds whole groups. p8 does not change when p is scaled by a
// constant, so a group's p taken against the split's running max gives
// JAX's p8 up to f32 rounding, and psc carries the scale.
//
// Bound on the H100: bytes, as the bf16 arm, at half the bytes: (w+1) keys
// of Hkv*hd int8 K and V plus four bytes of scales a key. The group's K
// tile (rows padded to 33 words, so a lane per key reads without bank
// conflicts), V tile, scales and scores live in shared memory; K and V
// arrive as 16-byte loads.
//
// Scales come from the packed pseudo-head (PACKED, Hf = 2*Hkv + 1: the two
// bf16 of head h sit at bytes 2h and 2(Hkv + h) of the position's row), as
// the blocked and paged arms read them, or from the plain "s" (Hf = 2*Hkv).
// `x / 127` is a multiplication by the float32 reciprocal, as XLA compiles
// the JAX kernels' division by the constant.

constexpr int QBS = 256;          // most keys per requantization group
constexpr int HDW = HD / 4;       // int32 words per int8 head row
constexpr int KPADW = HDW + 1;    // padded K row (words)
constexpr float INV127 = 1.0f / 127.0f;
constexpr size_t Q8_SMEM_BYTES =
    sizeof(int) * (MAXG * HDW + QBS * KPADW) + QBS * HD +       // q8, K tile, V tile
    sizeof(float) * (MAXG * QBS + 2 * QBS) + MAXG * QBS;          // scores, kss/vss, p8

template <bool PAGED, bool PACKED>
__global__ void __launch_bounds__(THREADS)
decode_q8_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ nk,
                       const bf16* __restrict__ nv, FusedQ8 c,
                       const int* __restrict__ lengths, const int* __restrict__ slot_ids,
                       float* __restrict__ pm, float* __restrict__ pl,
                       float* __restrict__ pacc, int layer, int Hkv, int G, int chunk,
                       int nsplit, int group, float scale) {
  extern __shared__ __align__(16) unsigned char smq[];
  int* q8w = reinterpret_cast<int*>(smq);              // [MAXG][HDW]
  int* kw = q8w + MAXG * HDW;                          // [QBS][KPADW]
  int8_t* v8 = reinterpret_cast<int8_t*>(kw + QBS * KPADW);  // [QBS][HD]
  float* sc = reinterpret_cast<float*>(v8 + QBS * HD);  // [MAXG][QBS] scores, then p*vss
  float* kss = sc + MAXG * QBS;                        // [QBS]
  float* vss = kss + QBS;                              // [QBS]
  int8_t* p8 = reinterpret_cast<int8_t*>(vss + QBS);   // [MAXG][QBS]
  __shared__ float qsc_s[MAXG], snew_s[MAXG], m_s[MAXG], l_s[MAXG], a_s[MAXG], psc_s[MAXG],
      pw_s[MAXG];

  const int sp = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int S = c.S;
  const int w = lengths[b];
  const bool parked = (w < 0 || w >= S);
  const int we = parked ? 0 : w;
  const int lo = sp * chunk;
  const int hi = min(lo + chunk, we + 1);
  const size_t pidx = ((size_t)b * Hkv + h) * nsplit + sp;
  if (lo >= hi) {
    if (tid < G) {
      pm[pidx * G + tid] = NEG_BIG;
      pl[pidx * G + tid] = 0.f;
    }
    return;
  }
  const int row = slot_ids[b];
  const int lane = tid & 31;
  const int wid = tid >> 5;
  // q rows to int8 (one warp a head, four dims a lane) and the exact score
  // of position w
  for (int g = wid; g < G; g += THREADS / 32) {
    const bf16* qp = q + (((size_t)b * Hkv + h) * G + g) * HD + lane * 4;
    const bf16* kp = nk + ((size_t)b * Hkv + h) * HD + lane * 4;
    float qf[4];
    float amax = 0.f, dot = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qf[e] = __bfloat162float(qp[e]);
      amax = fmaxf(amax, fabsf(qf[e]));
      dot = fmaf(qf[e], __bfloat162float(kp[e]), dot);
    }
    amax = warp_max(amax);
    dot = warp_sum(dot);
    const float qsc = fmaxf(amax * INV127, 1e-30f);
    unsigned packed = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      packed |= ((unsigned)(int)rintf(qf[e] / qsc) & 0xffu) << (8 * e);
    q8w[g * HDW + lane] = (int)packed;
    if (lane == 0) {
      qsc_s[g] = qsc;
      snew_s[g] = dot * scale;
      m_s[g] = NEG_BIG;
      l_s[g] = 0.f;
    }
  }
  const float nvd = __bfloat162float(nv[((size_t)b * Hkv + h) * HD + tid]);
  float acc[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) acc[g] = 0.f;
  __syncthreads();

  for (int g0 = lo; g0 < hi; g0 += group) {
    const int nkeys = min(group, hi - g0);
    // K and V rows of the group, 16 bytes a load
    for (int i = tid; i < nkeys * (HD / 16); i += THREADS) {
      const int kk = i / (HD / 16);
      const int part = i % (HD / 16);
      const KeyHome home = q8_home<PAGED>(c, row, g0 + kk);
      const uint4 kv = *reinterpret_cast<const uint4*>(q8_payload(c, home, layer, h) + part * 16);
      const uint4 vv =
          *reinterpret_cast<const uint4*>(q8_payload(c, home, layer, Hkv + h) + part * 16);
      int* kr = kw + kk * KPADW + part * 4;
      kr[0] = (int)kv.x;
      kr[1] = (int)kv.y;
      kr[2] = (int)kv.z;
      kr[3] = (int)kv.w;
      *reinterpret_cast<uint4*>(v8 + kk * HD + part * 16) = vv;
    }
    for (int kk = tid; kk < nkeys; kk += THREADS) {
      const KeyHome home = q8_home<PAGED>(c, row, g0 + kk);
      if constexpr (PACKED) {
        const bf16* sp8 = reinterpret_cast<const bf16*>(q8_payload(c, home, layer, c.Hs));
        kss[kk] = __bfloat162float(sp8[h]);
        vss[kk] = __bfloat162float(sp8[Hkv + h]);
      } else {
        kss[kk] = q8_scale(c, home, layer, h);
        vss[kk] = q8_scale(c, home, layer, Hkv + h);
      }
    }
    __syncthreads();
    // scores: s8 x s8 -> s32, dequantized after the dot
    for (int i = tid; i < G * nkeys; i += THREADS) {
      const int g = i / nkeys;
      const int kk = i - g * nkeys;
      const int* qr = q8w + g * HDW;
      const int* kr = kw + kk * KPADW;
      int si = 0;
#pragma unroll 8
      for (int d = 0; d < HDW; ++d) si = __dp4a(qr[d], kr[d], si);
      float s = (float)si * (scale * qsc_s[g]) * kss[kk];
      if (g0 + kk == we) s = snew_s[g];
      sc[g * QBS + kk] = s;
    }
    __syncthreads();
    // online softmax and the group's requantization: one warp a head
    for (int g = wid; g < G; g += THREADS / 32) {
      float* sg = sc + g * QBS;
      float mx = NEG_BIG;
      for (int kk = lane; kk < nkeys; kk += 32) mx = fmaxf(mx, sg[kk]);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.f, pw = 0.f, pa = 0.f;
      for (int kk = lane; kk < nkeys; kk += 32) {
        const float p = expf(sg[kk] - m_new);
        sum += p;
        float pv = 0.f;
        if (g0 + kk == we) {
          pw = p;
        } else {
          pv = p * vss[kk];
        }
        sg[kk] = pv;
        pa = fmaxf(pa, pv);
      }
      sum = warp_sum(sum);
      pw = warp_sum(pw);
      pa = warp_max(pa);
      const float psc = fmaxf(pa * INV127, 1e-30f);
      for (int kk = lane; kk < nkeys; kk += 32)
        p8[g * QBS + kk] = (int8_t)(int)rintf(sg[kk] / psc);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
        psc_s[g] = psc;
        pw_s[g] = pw;
      }
    }
    __syncthreads();
    // PV: thread -> one output dim, s8 x s8 -> s32 per head
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        const int8_t* pg = p8 + g * QBS;
        int ci = 0;
        for (int kk = 0; kk < nkeys; ++kk) ci += (int)pg[kk] * (int)v8[kk * HD + tid];
        acc[g] = acc[g] * a_s[g] + (float)ci * psc_s[g] + pw_s[g] * nvd;
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

template <bool PAGED, bool PACKED>
int launch_q8_arm(const void* q, const void* nk, const void* nv, const FusedQ8& c,
                  const void* lengths, const void* slot_ids, void* pm, void* pl, void* pacc,
                  int layer, int Ba, int Hkv, int G, int chunk, int nsplit, int group,
                  float scale, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(decode_q8_split_kernel<PAGED, PACKED>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)Q8_SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  decode_q8_split_kernel<PAGED, PACKED><<<dim3(nsplit, Hkv, Ba), THREADS, Q8_SMEM_BYTES, st>>>(
      (const bf16*)q, (const bf16*)nk, (const bf16*)nv, c, (const int*)lengths,
      (const int*)slot_ids, (float*)pm, (float*)pl, (float*)pacc, layer, Hkv, G, chunk,
      nsplit, group, scale);
  return (int)cudaGetLastError();
}

template <bool PAGED>
int launch_q8(const void* q, const void* nk, const void* nv, const FusedQ8& c,
              const void* lengths, const void* slot_ids, void* pm, void* pl, void* pacc,
              void* out, int layer, int Ba, int Hkv, int G, int hd, int chunk, int nsplit,
              int group, float scale, void* stream) {
  if (hd != HD || G > MAXG || G < 1 || group <= 0 || group > QBS || chunk % group != 0 ||
      c.Hs != 2 * Hkv || (c.Hf != c.Hs && c.Hf != c.Hs + 1) || (c.Hf > c.Hs && 2 * c.Hs > HD))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int rc =
      c.Hf > c.Hs
          ? launch_q8_arm<PAGED, true>(q, nk, nv, c, lengths, slot_ids, pm, pl, pacc, layer, Ba,
                                       Hkv, G, chunk, nsplit, group, scale, st)
          : launch_q8_arm<PAGED, false>(q, nk, nv, c, lengths, slot_ids, pm, pl, pacc, layer,
                                        Ba, Hkv, G, chunk, nsplit, group, scale, st);
  if (rc != 0) return rc;
  decode_combine_kernel<<<dim3(Hkv, Ba), THREADS, 0, st>>>(
      (const float*)pm, (const float*)pl, (const float*)pacc, (bf16*)out, Hkv, G, nsplit);
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

extern "C" int decode_attention_bf16(const void* q, const void* ck, const void* cv,
                                     const void* lengths, void* pm, void* pl, void* pacc,
                                     void* out, int B, int Hkv, int G, int S, int hd, int chunk,
                                     int nsplit, float scale, void* stream) {
  return launch<false, true>(q, q, q, ck, cv, lengths, nullptr, pm, pl, pacc, out,
                             0, B, B, Hkv, G, S, hd, chunk, nsplit, scale, PagedKV{}, stream);
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

extern "C" int decode_attend_q8(const void* q, const void* nk, const void* nv,
                                const void* cq, const void* cs, const void* lengths,
                                const void* slot_ids, void* pm, void* pl, void* pacc,
                                void* out, int layer, int B, int Ba, int Hkv, int Hf, int G,
                                int S, int hd, int chunk, int nsplit, int group, float scale,
                                void* stream) {
  const FusedQ8 c{(const int8_t*)cq, (const bf16*)cs, nullptr, nullptr, nullptr,
                  B, Hf, 2 * Hkv, S, hd, 0, 0, 0};
  return launch_q8<false>(q, nk, nv, c, lengths, slot_ids, pm, pl, pacc, out, layer, Ba, Hkv,
                          G, hd, chunk, nsplit, group, scale, stream);
}

extern "C" int decode_attend_q8_paged(const void* q, const void* nk, const void* nv,
                                      const void* cq, const void* cs, const void* lengths,
                                      const void* slot_ids, const void* tbl,
                                      const void* pool_q, const void* pool_s, void* pm,
                                      void* pl, void* pacc, void* out, int layer, int B,
                                      int Ba, int Hkv, int Hf, int G, int S, int hd,
                                      int chunk, int nsplit, int nbs, int bt, int pxb,
                                      float scale, void* stream) {
  if (nbs <= 0 || bt <= 0 || nbs * bt != S || pxb <= 0) return (int)cudaErrorInvalidValue;
  const FusedQ8 c{(const int8_t*)cq, (const bf16*)cs, (const int*)tbl, (const int8_t*)pool_q,
                  (const bf16*)pool_s, B, Hf, 2 * Hkv, S, hd, nbs, bt, pxb};
  // the paged arm requantizes per block, as `_attend_q8_paged_kernel`
  return launch_q8<true>(q, nk, nv, c, lengths, slot_ids, pm, pl, pacc, out, layer, Ba, Hkv,
                         G, hd, chunk, nsplit, bt, scale, stream);
}
