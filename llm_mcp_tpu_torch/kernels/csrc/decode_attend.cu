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
// below the ~295 flops per byte where compute would bind. So the design has
// one job: keep enough bytes in flight and touch each of them once.
//
//   - One CTA (four warps) per (row, KV head, split of `chunk` keys of
//     [0, w]); splits past w exit at once. The G query heads of a KV head
//     share every key.
//   - K and V stay bf16. They reach shared memory through a ring of NST = 3
//     stages of SK = 32 keys (16 KB a stage, 48 KB a CTA), as 16-byte
//     `cp.async.cg` copies, one commit group a stage: two stages are in
//     flight while the third is consumed, and the copies hold no register.
//   - Each warp copies and consumes its own 8 keys of a stage, and a lane
//     reads back exactly the 16 bytes it copied: half-warp `half` takes
//     keys 2j + half, lane chunk c (16 lanes x 16 bytes cover one 256-byte
//     row). So the key loop needs `cp.async.wait_group` and `__syncwarp`,
//     and no block-wide barrier.
//   - A lane holds its 8 dims of the G scaled queries and of the G
//     accumulators in f32 registers, arrays of GM heads with G a run-time
//     argument: GM = 4 serves G <= 4 in about 128 registers, so four CTAs
//     fit an SM (registers, not the ring, set the occupancy: at GM = 8 it
//     is two). A score is 8 f32 products reduced over the half-warp with
//     shuffles. Each half-warp keeps its own online softmax (m, l) and
//     rescales once a stage. At the end of the split the two half-warps
//     merge through shuffles and the four warps through shared memory (the
//     ring, reused), and the CTA writes the split's (m, l, acc) partial.
//   - A second kernel combines the splits, a CTA per (row, KV head, query
//     head) with the splits spread over its threads, so its loads are in
//     flight together (a combine of one thread a dim walking every split of
//     every head in turn grows with S / chunk). The int8 arm shares it.
//   - A key past the split's end inside a stage copies nothing: its slot
//     is zero-filled (src-size 0), its score is NEG_BIG and its
//     probability exactly 0, so no stale value reaches a sum.
//
// Position w takes this step's exact new_k/new_v (the cache does not hold
// them yet: the append runs after all layers): its copy reads them in
// place of the cache row. A row parked at w >= S attends its new vectors
// alone (w is clamped to 0) and reads no cache.
//
// Paged arm (`decode_attend_bf16_paged`). Replaces
// `_attend_bf16_paged_kernel` (same file), whose Pallas body streams each
// bt-token block with its own DMA, resolved through the row's block table
// to an arena home or a prefix-pool row. Here the kernel is the same with
// one change: a lane resolves each of its keys once a stage through
// tbl[row * nbs + p / bt] (paged.cuh), so any block size works (a stage
// may span blocks or sit inside one), and blocks may live in other slots'
// arena homes or in the pool. The override at w holds in whichever block w
// lives. The read is the same bytes as the contiguous arm plus one 4-byte
// table entry per key (L1-resident), so the bound is unchanged.
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

constexpr int HD = 128;       // head_dim this kernel is built for
constexpr int MAXG = 8;       // most query heads per KV head
constexpr int THREADS = 128;  // four warps
constexpr int WARPS = THREADS / 32;
constexpr int SK = 32;                   // keys per ring stage
constexpr int NST = 3;                   // ring stages
constexpr int WK = SK / WARPS;           // keys a warp takes of a stage
constexpr int HK = WK / 2;               // keys a half-warp takes of a stage
constexpr int ROW_BYTES = HD * 2;        // one bf16 K or V row: 16 lanes x 16 bytes
constexpr int STAGE_BYTES = 2 * SK * ROW_BYTES;  // K then V rows of a stage
constexpr int SMEM_BYTES = NST * STAGE_BYTES;    // 48 KB
static_assert(WARPS * MAXG * (HD + 2) * 4 <= SMEM_BYTES, "the merge reuses the ring");

template <bool PAGED, bool POST, int GM>
__global__ void __launch_bounds__(THREADS, GM <= 4 ? 4 : 1)
decode_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ nk,
                    const bf16* __restrict__ nv, const bf16* __restrict__ ck,
                    const bf16* __restrict__ cv, const int* __restrict__ lengths,
                    const int* __restrict__ slot_ids, float* __restrict__ pm,
                    float* __restrict__ pl, float* __restrict__ pacc, int layer,
                    int B, int Hkv, int G, int S, int chunk, int nsplit,
                    float scale, PagedKV pkv) {
  extern __shared__ __align__(16) unsigned char ring[];

  const int sp = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const int half = lane >> 4;  // the half-warp: keys 2j + half of the warp's
  const int c = lane & 15;     // the lane's 16-byte chunk (8 dims) of a row
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
  const size_t cache_row = (((size_t)layer * B + row) * Hkv + h) * (size_t)S * HD;
  const bf16* kbase = ck + cache_row + c * 8;
  const bf16* vbase = cv + cache_row + c * 8;
  const bf16* nkp = nk + ((size_t)b * Hkv + h) * HD + c * 8;
  const bf16* nvp = nv + ((size_t)b * Hkv + h) * HD + c * 8;
  // this lane's slot of a stage: K row (wid * WK + half), chunk c; V rows follow K's
  unsigned char* const mine = ring + (wid * WK + half) * ROW_BYTES + c * 16;
  const int nst = (hi - lo + SK - 1) / SK;

  // copy this lane's keys of stage st into ring slot st % NST (zeros past hi)
  auto copy_stage = [&](int st) {
    unsigned char* dst = mine + (st % NST) * STAGE_BYTES;
    const int p0 = lo + st * SK + wid * WK + half;
#pragma unroll
    for (int j = 0; j < HK; ++j) {
      const int pos = p0 + 2 * j;
      const bf16* kp = nullptr;
      const bf16* vp = nullptr;
      if (pos < hi) {
        if (!POST && pos == we) {  // this step's K/V, not yet in the cache
          kp = nkp;
          vp = nvp;
        } else if constexpr (PAGED) {
          paged_row(pkv, ck, cv, layer, B, Hkv, h, S, HD, row, pos, kp, vp);
          kp += c * 8;
          vp += c * 8;
        } else {
          kp = kbase + (size_t)pos * HD;
          vp = vbase + (size_t)pos * HD;
        }
      }
      cp16(dst + 2 * j * ROW_BYTES, kp, nkp);
      cp16(dst + SK * ROW_BYTES + 2 * j * ROW_BYTES, vp, nvp);
    }
  };
#pragma unroll
  for (int st = 0; st < NST - 1; ++st) {
    if (st < nst) copy_stage(st);
    cp_commit();
  }

  // the lane's 8 dims of the G scaled queries
  float qr[GM][8];
  const bf16* qp = q + ((size_t)b * Hkv + h) * G * HD + c * 8;
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g < G) {
      load8(qp + g * HD, qr[g]);
#pragma unroll
      for (int e = 0; e < 8; ++e) qr[g][e] *= scale;
    }
  }
  float m[GM], l[GM], acc[GM][8];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = NEG_BIG;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }

  for (int st = 0; st < nst; ++st) {
    if (st + NST - 1 < nst) copy_stage(st + NST - 1);
    cp_commit();
    cp_wait<NST - 1>();  // this lane's copies of stage st have landed
    __syncwarp();
    const unsigned char* kt = mine + (st % NST) * STAGE_BYTES;  // the ring slot read
    const int p0 = lo + st * SK + wid * WK + half;
    float s[HK][GM];
#pragma unroll
    for (int j = 0; j < HK; ++j) {
      float kf[8];
      load8(reinterpret_cast<const bf16*>(kt + 2 * j * ROW_BYTES), kf);
      const bool live = p0 + 2 * j < hi;
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < G) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) d = fmaf(qr[g][e], kf[e], d);
          d = half_sum(d);
          s[j][g] = !live ? NEG_BIG : uniform ? 0.f : d;
        }
      }
    }
    // online softmax, once a stage: rescale by alpha, then the stage's p
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < G) {
        float mx = m[g];
#pragma unroll
        for (int j = 0; j < HK; ++j) mx = fmaxf(mx, s[j][g]);
        const float alpha = __expf(m[g] - mx);
        m[g] = mx;
        l[g] *= alpha;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] *= alpha;
#pragma unroll
        for (int j = 0; j < HK; ++j) {
          s[j][g] = (p0 + 2 * j < hi) ? __expf(s[j][g] - mx) : 0.f;
          l[g] += s[j][g];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < HK; ++j) {
      float vf[8];
      load8(reinterpret_cast<const bf16*>(kt + SK * ROW_BYTES + 2 * j * ROW_BYTES), vf);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < G) {
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(s[j][g], vf[e], acc[g][e]);
        }
      }
    }
    __syncwarp();
  }
  cp_wait<0>();

  // merge the two half-warps (same dims, other keys) through shuffles
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g < G) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], 16);
      const float lx = __shfl_xor_sync(0xffffffffu, l[g], 16);
      const float mm = fmaxf(m[g], mo);
      const float a = __expf(m[g] - mm), ao = __expf(mo - mm);
      m[g] = mm;
      l[g] = l[g] * a + lx * ao;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[g][e] = acc[g][e] * a + __shfl_xor_sync(0xffffffffu, acc[g][e], 16) * ao;
    }
  }
  // then the four warps through shared memory: red_acc [WARPS][MAXG][HD],
  // red_m and red_l [WARPS][MAXG], over the ring
  __syncthreads();
  float* red_acc = reinterpret_cast<float*>(ring);
  float* red_m = red_acc + WARPS * MAXG * HD;
  float* red_l = red_m + WARPS * MAXG;
  if (half == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < G) {
        float4* dst = reinterpret_cast<float4*>(red_acc + (wid * MAXG + g) * HD + c * 8);
        dst[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
        dst[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
        if (c == 0) {
          red_m[wid * MAXG + g] = m[g];
          red_l[wid * MAXG + g] = l[g];
        }
      }
    }
  }
  __syncthreads();
  for (int g = 0; g < G; ++g) {  // thread tid: output dim tid
    float mm = NEG_BIG;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) mm = fmaxf(mm, red_m[k * MAXG + g]);
    float ls = 0.f, o = 0.f;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) {
      const float e = __expf(red_m[k * MAXG + g] - mm);
      ls += red_l[k * MAXG + g] * e;
      o += red_acc[(k * MAXG + g) * HD + tid] * e;
    }
    pacc[(pidx * G + g) * HD + tid] = o;
    if (tid == 0) {
      pm[pidx * G + g] = mm;
      pl[pidx * G + g] = ls;
    }
  }
}

// Combine the splits of one (row, KV head, query head): out = sum_s
// e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s over the splits that attended
// anything (l_s > 0), with the splits spread over the CTA: the maximum and
// the weights are taken a split a thread, then each thread (an output dim)
// sums its column of acc over the splits of nonzero weight, many loads in
// flight. The bf16 and the int8 split kernels both write its partials.
__global__ void __launch_bounds__(THREADS)
decode_combine_wide_kernel(const float* __restrict__ pm, const float* __restrict__ pl,
                           const float* __restrict__ pacc, bf16* __restrict__ out,
                           int Hkv, int G, int nsplit) {
  __shared__ float es[THREADS];
  __shared__ float red[2][WARPS];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = blockIdx.z;
  const int tid = threadIdx.x;
  const size_t base = ((size_t)b * Hkv + h) * nsplit;
  float mx = NEG_BIG;
  for (int s = tid; s < nsplit; s += THREADS) {
    const size_t i = (base + s) * G + g;
    if (pl[i] > 0.f) mx = fmaxf(mx, pm[i]);
  }
  mx = warp_max(mx);
  if ((tid & 31) == 0) red[0][tid >> 5] = mx;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < WARPS; ++k) mx = fmaxf(mx, red[0][k]);
  float ls = 0.f, o = 0.f;
  for (int s0 = 0; s0 < nsplit; s0 += THREADS) {
    float e = 0.f;
    if (s0 + tid < nsplit) {
      const size_t i = (base + s0 + tid) * G + g;
      if (pl[i] > 0.f) {
        e = __expf(pm[i] - mx);
        ls += pl[i] * e;
      }
    }
    __syncthreads();  // the previous tile's weights are read
    es[tid] = e;
    __syncthreads();
    const int n = min(THREADS, nsplit - s0);
#pragma unroll 8
    for (int k = 0; k < n; ++k) {
      const float ek = es[k];
      if (ek != 0.f) o += ek * pacc[((base + s0 + k) * G + g) * HD + tid];
    }
  }
  ls = warp_sum(ls);
  if ((tid & 31) == 0) red[1][tid >> 5] = ls;
  __syncthreads();
  ls = 0.f;
#pragma unroll
  for (int k = 0; k < WARPS; ++k) ls += red[1][k];
  out[(((size_t)b * Hkv + h) * G + g) * HD + tid] = __float2bfloat16(ls > 0.f ? o / ls : 0.f);
}

// The split kernel's registers hold GM heads: four when G <= 4 (about 128
// registers, four CTAs an SM), else eight.
template <bool PAGED, bool POST, int GM>
int launch_split(const void* q, const void* nk, const void* nv, const void* ck,
                 const void* cv, const void* lengths, const void* slot_ids, void* pm, void* pl,
                 void* pacc, int layer, int B, int Ba, int Hkv, int G, int S, int chunk,
                 int nsplit, float scale, const PagedKV& pg, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(decode_split_kernel<PAGED, POST, GM>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  decode_split_kernel<PAGED, POST, GM><<<dim3(nsplit, Hkv, Ba), THREADS, SMEM_BYTES, st>>>(
      (const bf16*)q, (const bf16*)nk, (const bf16*)nv, (const bf16*)ck, (const bf16*)cv,
      (const int*)lengths, (const int*)slot_ids, (float*)pm, (float*)pl, (float*)pacc, layer,
      B, Hkv, G, S, chunk, nsplit, scale, pg);
  return (int)cudaGetLastError();
}

template <bool PAGED, bool POST = false>
int launch(const void* q, const void* nk, const void* nv, const void* ck, const void* cv,
           const void* lengths, const void* slot_ids, void* pm, void* pl, void* pacc,
           void* out, int layer, int B, int Ba, int Hkv, int G, int S, int hd, int chunk,
           int nsplit, float scale, PagedKV pg, void* stream) {
  if (hd != HD || G > MAXG || G < 1 || chunk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int rc =
      G <= 4 ? launch_split<PAGED, POST, 4>(q, nk, nv, ck, cv, lengths, slot_ids, pm, pl, pacc,
                                            layer, B, Ba, Hkv, G, S, chunk, nsplit, scale, pg, st)
             : launch_split<PAGED, POST, MAXG>(q, nk, nv, ck, cv, lengths, slot_ids, pm, pl,
                                               pacc, layer, B, Ba, Hkv, G, S, chunk, nsplit,
                                               scale, pg, st);
  if (rc != 0) return rc;
  decode_combine_wide_kernel<<<dim3(Hkv, Ba, G), THREADS, 0, st>>>(
      (const float*)pm, (const float*)pl, (const float*)pacc, (bf16*)out, Hkv, G, nsplit);
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
  decode_combine_wide_kernel<<<dim3(Hkv, Ba, G), THREADS, 0, st>>>(
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
