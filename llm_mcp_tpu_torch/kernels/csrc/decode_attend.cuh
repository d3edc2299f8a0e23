// The GQA decode kernels (bf16 and int8, contiguous and paged, with their
// fused appends, and the post-append arm) for the head_dim the including
// source builds them for (decode_attend.cu: 128, decode_attend_hd64.cu:
// 64, as DECODE_HD). See decode_attend.cu.

#pragma once

#include "paged.cuh"

namespace {

#ifndef DECODE_HD
#define DECODE_HD 128
#endif

constexpr int HD = DECODE_HD;  // head_dim this library is built for
static_assert(HD == 64 || HD == 128, "the decode kernels are built for head_dim 64 or 128");
constexpr int MAXG = 8;       // most query heads per KV head
constexpr int THREADS = 128;  // four warps
constexpr int WARPS = THREADS / 32;
constexpr int LPR = HD / 8;              // lanes that read one bf16 row, 16 bytes each
constexpr int SUB = 32 / LPR;            // lane groups a warp: rows it reads at once
constexpr int SK = 4096 / HD;            // keys per ring stage (16 KB a stage)
constexpr int NST = 3;                   // ring stages
constexpr int WK = SK / WARPS;           // keys a warp takes of a stage
constexpr int HK = WK / SUB;             // keys a lane group takes of a stage
constexpr int ROW_BYTES = HD * 2;        // one bf16 K or V row: LPR lanes x 16 bytes
constexpr int STAGE_BYTES = 2 * SK * ROW_BYTES;  // K then V rows of a stage
constexpr int SMEM_BYTES = NST * STAGE_BYTES;    // 48 KB
constexpr int CT = HD;                   // the combine's threads: one an output dim
constexpr int CW = CT / 32;
static_assert(WARPS * MAXG * (HD + 2) * 4 <= SMEM_BYTES, "the merge reuses the ring");

// A score's sum over the lanes that share a row, N of them (half_sum at N = 16).
template <int N>
__device__ __forceinline__ float lanes_sum(float v) {
#pragma unroll
  for (int o = N / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <bool PAGED, bool POST, int GM>
__global__ void __launch_bounds__(THREADS, GM <= 4 ? 4 : 1)
decode_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ nk,
                    const bf16* __restrict__ nv, const bf16* __restrict__ ck,
                    const bf16* __restrict__ cv, const int* __restrict__ lengths,
                    const int* __restrict__ slot_ids, float* __restrict__ pm,
                    float* __restrict__ pl, float* __restrict__ pacc, int layer,
                    int B, int Hkv, int G, int S, int chunk, int nsplit,
                    float scale, PagedKV pkv, bf16* __restrict__ wk, bf16* __restrict__ wv) {
  extern __shared__ __align__(16) unsigned char ring[];

  const int sp = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const int half = lane / LPR;  // the lane group: keys SUB * j + half of the warp's
  const int c = lane % LPR;     // the lane's 16-byte chunk (8 dims) of a row
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
      const int pos = p0 + SUB * j;
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
      cp16(dst + SUB * j * ROW_BYTES, kp, nkp);
      cp16(dst + SK * ROW_BYTES + SUB * j * ROW_BYTES, vp, nvp);
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
      load8(reinterpret_cast<const bf16*>(kt + SUB * j * ROW_BYTES), kf);
      const bool live = p0 + SUB * j < hi;
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < G) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) d = fmaf(qr[g][e], kf[e], d);
          d = lanes_sum<LPR>(d);
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
          s[j][g] = (p0 + SUB * j < hi) ? __expf(s[j][g] - mx) : 0.f;
          l[g] += s[j][g];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < HK; ++j) {
      float vf[8];
      load8(reinterpret_cast<const bf16*>(kt + SK * ROW_BYTES + SUB * j * ROW_BYTES), vf);
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
  // the fused append: the split that holds w writes head h's new rows at w,
  // lane group 0 K and lane group 1 V, 16 bytes a lane
  if (wk != nullptr && !POST && !parked && hi == we + 1 && wid == 0 && (SUB == 2 || half < 2)) {
    const size_t at = cache_row + (size_t)we * HD + c * 8;
    *reinterpret_cast<uint4*>((half ? wv : wk) + at) =
        *reinterpret_cast<const uint4*>(half ? nvp : nkp);
  }

  // merge the lane groups (same dims, other keys) through shuffles: the
  // lanes `o` apart
  auto merge = [&](int o) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < G) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
        const float lx = __shfl_xor_sync(0xffffffffu, l[g], o);
        const float mm = fmaxf(m[g], mo);
        const float a = __expf(m[g] - mm), ao = __expf(mo - mm);
        m[g] = mm;
        l[g] = l[g] * a + lx * ao;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc[g][e] = acc[g][e] * a + __shfl_xor_sync(0xffffffffu, acc[g][e], o) * ao;
      }
    }
  };
  merge(16);
  if constexpr (SUB == 4) merge(8);  // head_dim 64: four lane groups, 8 lanes each
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
  // thread tid: output dim tid % HD of heads tid / HD, + THREADS / HD, ...
  const int dim = HD == THREADS ? tid : tid % HD;
  for (int g = HD == THREADS ? 0 : tid / HD; g < G; g += THREADS / HD) {
    float mm = NEG_BIG;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) mm = fmaxf(mm, red_m[k * MAXG + g]);
    float ls = 0.f, o = 0.f;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) {
      const float e = __expf(red_m[k * MAXG + g] - mm);
      ls += red_l[k * MAXG + g] * e;
      o += red_acc[(k * MAXG + g) * HD + dim] * e;
    }
    pacc[(pidx * G + g) * HD + dim] = o;
    if (dim == 0) {
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
// flight. The bf16 split kernel writes its partials.
__global__ void __launch_bounds__(CT)
decode_combine_wide_kernel(const float* __restrict__ pm, const float* __restrict__ pl,
                           const float* __restrict__ pacc, bf16* __restrict__ out,
                           int Hkv, int G, int nsplit) {
  __shared__ float es[CT];
  __shared__ float red[2][CW];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = blockIdx.z;
  const int tid = threadIdx.x;
  const size_t base = ((size_t)b * Hkv + h) * nsplit;
  float mx = NEG_BIG;
  for (int s = tid; s < nsplit; s += CT) {
    const size_t i = (base + s) * G + g;
    if (pl[i] > 0.f) mx = fmaxf(mx, pm[i]);
  }
  mx = warp_max(mx);
  if ((tid & 31) == 0) red[0][tid >> 5] = mx;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < CW; ++k) mx = fmaxf(mx, red[0][k]);
  float ls = 0.f, o = 0.f;
  for (int s0 = 0; s0 < nsplit; s0 += CT) {
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
    const int n = min(CT, nsplit - s0);
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
  for (int k = 0; k < CW; ++k) ls += red[1][k];
  out[(((size_t)b * Hkv + h) * G + g) * HD + tid] = __float2bfloat16(ls > 0.f ? o / ls : 0.f);
}

// The split kernel's registers hold GM heads: four when G <= 4 (about 128
// registers, four CTAs an SM), else eight.
template <bool PAGED, bool POST, int GM>
int launch_split(const void* q, const void* nk, const void* nv, const void* ck,
                 const void* cv, const void* lengths, const void* slot_ids, void* pm, void* pl,
                 void* pacc, int layer, int B, int Ba, int Hkv, int G, int S, int chunk,
                 int nsplit, float scale, const PagedKV& pg, bool append, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(decode_split_kernel<PAGED, POST, GM>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  decode_split_kernel<PAGED, POST, GM><<<dim3(nsplit, Hkv, Ba), THREADS, SMEM_BYTES, st>>>(
      (const bf16*)q, (const bf16*)nk, (const bf16*)nv, (const bf16*)ck, (const bf16*)cv,
      (const int*)lengths, (const int*)slot_ids, (float*)pm, (float*)pl, (float*)pacc, layer,
      B, Hkv, G, S, chunk, nsplit, scale, pg, append ? (bf16*)ck : nullptr,
      append ? (bf16*)cv : nullptr);
  return (int)cudaGetLastError();
}

template <bool PAGED, bool POST = false>
int launch(const void* q, const void* nk, const void* nv, const void* ck, const void* cv,
           const void* lengths, const void* slot_ids, void* pm, void* pl, void* pacc,
           void* out, int layer, int B, int Ba, int Hkv, int G, int S, int hd, int chunk,
           int nsplit, float scale, PagedKV pg, bool append, void* stream) {
  if (hd != HD || G > MAXG || G < 1 || chunk <= 0 || (POST && append))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int rc =
      G <= 4 ? launch_split<PAGED, POST, 4>(q, nk, nv, ck, cv, lengths, slot_ids, pm, pl, pacc,
                                            layer, B, Ba, Hkv, G, S, chunk, nsplit, scale, pg,
                                            append, st)
             : launch_split<PAGED, POST, MAXG>(q, nk, nv, ck, cv, lengths, slot_ids, pm, pl,
                                               pacc, layer, B, Ba, Hkv, G, S, chunk, nsplit,
                                               scale, pg, append, st);
  if (rc != 0) return rc;
  decode_combine_wide_kernel<<<dim3(Hkv, Ba, G), CT, 0, st>>>(
      (const float*)pm, (const float*)pl, (const float*)pacc, (bf16*)out, Hkv, G, nsplit);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// decode_attend_q8 / decode_attend_q8_paged: the int8 arms over the fused
// cache, one launch a call.
//
// Replaces `_attend_q8_kernel` (whole-S arm), `_attend_q8_blocked_kernel`
// (blocked arm) and `_attend_q8_paged_kernel` (paged arm), all behind
// `decode_attend_q8`, and JAX's exact `_decode_attend_q8_fallback` for a
// length that no int8 group divides. Their arithmetic is kept: q is
// requantized per (h, g) row (qsc = max(max|q| / 127, 1e-30)), the scores
// are s8 x s8 -> s32 dots dequantized after the dot, s = s32 * (scale *
// qsc) * kss; position w takes the exact f32 score and value of
// new_k/new_v; p * vss is requantized to int8 per group of keys with the
// group's own psc = max(max(p * vss) / 127, 1e-30), and PV is s8 x s8 ->
// s32 again, acc = sum over groups of s32 * psc, plus p_w * new_v. The
// group is an argument: q8_group(S) keys contiguous (JAX's blocked BS, or
// S where S <= 256), bt through tables, S (the whole row: JAX's whole-S
// body where no int8 block divides S but the row fits its budget), or 0:
// the exact arm, q and p in f32 with no requantization.
//
// Bound on the H100: bytes, (w+1) keys of Hkv*hd int8 K and V plus four
// bytes of scales a key, read from HBM once; the products are a few
// hundred operations a byte below the int8 tensor cores' rate.
//
//   - A CTA (four warps) takes one (KV head, row, split of QCH = 256 keys);
//     a split holds whole groups (32..256 keys, or the exact arm's none).
//     The grid's split index varies slowest and runs from the last split
//     down, so the long rows' late splits start at once and the splits
//     past short rows' fills exit while the SMs have room; the live splits
//     then all fit one wave.
//   - Each warp owns 64 consecutive keys: it streams their K rows, then
//     their V rows, through a ring of three 4 KB slots in shared memory as
//     16-byte `cp.async.cg` copies in four 32-key stages, a commit group
//     each: K0 and K1 at once, V0 once K0 is scored, V1 (into K0's slot)
//     once K1 is. Each byte is read once; two stages a warp in flight keep
//     HBM busy while the scores, the exchange and p8 run under the V
//     copies; and a CTA holds 50 KB: four fit an SM, and the live splits of
//     a decode step run in one wave. A stage lies inside one bt >= 32
//     block, so the paged arm resolves its table once a stage; the scales
//     of a stage's keys are one contiguous run of "s" (or a bf16 pair of
//     each key's packed row), loaded ahead of the copies.
//   - Scores on the int8 tensor cores: `mma.sync.m16n8k32` s8 with the keys
//     on M (16 a tile, as stored: K-major) and the G <= 8 query heads on N.
//     The K tile's 16-byte chunks are XOR-swizzled by key so that the
//     fragments' loads hit 32 banks. The exact arm multiplies on
//     `m16n8k16` bf16 (an int8 key is exact in bf16), f32 sums.
//   - A warp's scores stay in registers; each warp publishes its max and,
//     per 32-key stage, its max of e^(s - m) * vss off w, once: one block
//     barrier. Every warp then takes the split max M and each group's max
//     of p * vss over all its stages (max over them of a e^(m - M)), so a
//     group's scale sees the whole group however many warps it spans, and
//     forms p8 = rint(p * vss / psc) with p = e^(s - m) e^(m - M). p8 does
//     not depend on the reference max, so these are JAX's p8 up to f32
//     rounding.
//   - PV on `m16n8k32` s8 too: output dims on M, heads on N, keys on K. s8
//     `mma.sync` takes its operands only K-major, so the V tile is
//     transposed in registers (`transpose4`: four keys' words of a dim
//     quad), its chunks XOR-swizzled so those loads are conflict-free; the
//     s32 sums of each 32-key stage are flushed into f32 times the stage's
//     group psc. The exact arm keeps p * vss in f32 and runs its PV on FMA
//     (a lane four dims of every head).
//   - The warps' partials, all relative to M, are summed in warp order
//     through shared memory (each in its warp's spent V0 slot) and p_w *
//     new_v added. A row of one split writes its output there; otherwise
//     the CTA writes the split's (M, l, acc) and counts itself in (one
//     atomic a CTA, `q8_arrivals`), and the row's last split to arrive
//     combines the row's splits in split order (so two calls agree bit for
//     bit) from L2. No second kernel: its launch and its wait for the last
//     split were a fifth of the call.
//
// The whole-row arm (group S, S not a multiple of the 32-key stage, so no
// split-local group): one psc for the whole row, which spans every split,
// so no split can form p8 from its own keys. Two launches: a score pass
// (the same kernel up to the exchange, no V read) writes each split's max
// m_j and its max a_j of e^(s - m_j) * vss off w into a workspace; the
// split kernel, launched to start under it (programmatic dependent launch),
// streams its K and V and scores as above, waits for the score pass only
// after its exchange, and then takes the row max M = max_j m_j as its
// reference max and psc = max_j a_j e^(m_j - M) / 127: the max of p * vss
// over the row against the row max, JAX's whole-S psc up to f32 rounding.
// Its splits all share M, so the last CTA's combine weighs them alike.
//
// Fused append (`ap.q`, every arm): the CTA whose split holds w quantizes
// head h's new K and V rows with `append_kv_q8`'s arithmetic (append_kv_q8.cu,
// which replaces `_append_q8_kernel`: amax * (1/127), IEEE division, rint,
// the scale rounded to bf16) and writes them at (layer, slot_ids[b], w):
// payload heads h and Hkv + h, their two plain scales, their four bytes
// of the packed pseudo-head row, and (KV head 0) that row's zero tail. The
// CTAs of a row write disjoint bytes, and no CTA reads position w from the
// cache (w scores from new_k/new_v; its copies and scales are skipped), so
// the writes race with nothing. A parked row writes nothing.
//
// Four block barriers a split: the requantized queries, the exchange, the
// final sum and the arrival. A key past the split's end, or at w, copies
// zeros (its score is NEG_BIG or the exact one, its p * vss 0). A parked
// row (w outside [0, S)) attends its new vectors alone and reads no cache.
//
// head_dim 64: an int8 row is 64 bytes, so a stage's 32 rows fill a 2 KB
// slot (a CTA about 27 KB), two rows share each 128-byte line of the
// swizzle, the score's s8 products take 2 k-steps of 32 dims and PV 2 dim
// blocks of 32. The query, new K/V and the append's rows take 16 lanes,
// four values each (the other 16 hold zeros), and threads tid < 64 own
// the output dims. The packed pseudo-head is one 64-byte row: 4*Hkv bytes
// of scales (32 at Llama-3.2-1B, 8 at Qwen2.5-0.5B) and a zero tail.
//
// Scales come from the packed pseudo-head (PACKED, Hf = 2*Hkv + 1: the two
// bf16 of head h sit at bytes 2h and 2(Hkv + h) of the position's row), as
// the blocked and paged arms read them, or from the plain "s" (Hf = 2*Hkv).
// `x / 127` is a multiplication by the float32 reciprocal, as XLA compiles
// the JAX kernels' division by the constant.

constexpr int QCH = 256;             // keys a CTA: the split
constexpr int QWK = QCH / WARPS;     // keys a warp
constexpr int QSK = 32;              // keys a copy stage: one s8 mma k-step
constexpr int QSLOT = QSK * HD;      // a ring slot: one stage's K or V rows, bytes
constexpr int QNS = 3;               // ring slots a warp
constexpr int QL = HD / 4;           // lanes holding a row, four values each (32 or 16)
constexpr int QCK = HD / 16;         // 16-byte chunks an int8 row
constexpr int RPL = 128 / HD;        // int8 rows a 128-byte line of a ring slot
constexpr int Q8STR = HD + 16;       // padded q8 row (bytes)
constexpr int P8STR = QWK + 16;      // padded p8 row (bytes)
constexpr float INV127 = 1.0f / 127.0f;
static_assert(QWK * MAXG * 4 <= QSLOT && MAXG * HD * 4 <= QSLOT, "pf and partials fit a slot");

struct __align__(16) Q8Smem {
  // a warp's ring: its stages K0 and K1 in slots 0 and 1, V0 in slot 2 once
  // K0 is scored, V1 in slot 0 once K1 is; after the exchange slot 1 holds
  // p8 (or pf), and after PV slot 2 the warp's partial
  unsigned char ring[WARPS][QNS][QSLOT];
  unsigned char q8[MAXG * Q8STR];
  float ks[QCH], vs[QCH];
  float xm[WARPS][MAXG], xa[WARPS][2][MAXG], xl[WARPS][MAXG];
  float qsc[MAXG], snew[MAXG], pw[MAXG], fm[MAXG], fl[MAXG], rowm[MAXG];
  int last;
};

// The kernel's arms: the exact one (group 0), a group inside the split,
// and the whole row's two launches, the score pass and the split kernel.
enum Q8Arm { Q8_EXACT, Q8_GROUP, Q8_ROW_SCORE, Q8_ROW };

// Where the fused append writes: the arena's payload and plain scales
// (nullptr: no append).
struct Q8Append {
  int8_t* q;
  bf16* s;
};

// Programmatic dependent launch: the whole row's split kernel is launched
// to start while its score pass runs, and waits for the pass's writes only
// where it needs them. Without the launch attribute both are no-ops.
__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }

// The whole row's reference max M and max of p * vss against it, from the
// score pass's (m_j, a_j) of the row's `nlive` splits, head g: rs holds
// [Ba, Hkv, nsplit, G, 2] and `base` is (b * Hkv + h) * nsplit * G + g.
__device__ __forceinline__ float2 q8_row_max(const float* rs, size_t base, int nlive, int G) {
  float m = NEG_BIG, a = 0.f;
  for (int j = 0; j < nlive; ++j) m = fmaxf(m, __ldcg(rs + (base + (size_t)j * G) * 2));
  for (int j = 0; j < nlive; ++j) {
    const float* r = rs + (base + (size_t)j * G) * 2;
    a = fmaxf(a, __ldcg(r + 1) * __expf(__ldcg(r) - m));
  }
  return make_float2(m, a);
}

// Arrivals of each (row, KV head)'s splits: the last to arrive combines the
// row and sets its count back to 0, so it is 0 between calls (calls on one
// stream at a time, as the engine makes them).
constexpr int Q8_ARRIVALS = 1 << 16;
__device__ int q8_arrivals[Q8_ARRIVALS];

// the byte offset in a ring slot of chunk `ch` of a stage's key row `key`,
// its 16-byte chunks XOR-swizzled over a 128-byte line: K by the line % 8
// (the score fragments read 8 keys at one chunk), V by (key / 4) % 4 (the
// transposing loads read four key quads at 8 dim quads). A line is one row
// at head_dim 128 and two at 64 (RPL), so 8 chunks always share the swizzle
// and the reads keep all 32 banks.
__device__ __forceinline__ int slot_k(int key, int ch) {
  return key / RPL * 128 + ((key % RPL * QCK + ch) ^ (key / RPL & 7)) * 16;
}
__device__ __forceinline__ int slot_v(int key, int ch) {
  return key / RPL * 128 + ((key % RPL * QCK + ch) ^ (((key >> 2) & 3) << 1)) * 16;
}

// A stage's sources: the K and V payload rows of its first key (the next
// keys follow, hd bytes apart: a stage lies in one block) and its scales
// (sstr elements apart).
struct Q8Stage {
  const int8_t* k;
  const int8_t* v;
  const bf16* ks;
  const bf16* vs;
  int sstr;
};

template <bool PAGED, bool PACKED>
__device__ __forceinline__ Q8Stage q8_stage(const FusedQ8& c, int layer, int row, int h, int Hkv,
                                            int p0) {
  const KeyHome home = q8_home<PAGED>(c, row, p0);  // the table, once a stage
  Q8Stage s{q8_payload(c, home, layer, h), q8_payload(c, home, layer, Hkv + h), nullptr,
            nullptr, 1};
  if constexpr (PACKED) {
    const bf16* sp = reinterpret_cast<const bf16*>(q8_payload(c, home, layer, c.Hs));
    s.ks = sp + h;
    s.vs = sp + Hkv + h;
    s.sstr = c.hd / 2;
  } else {
    s.ks = q8_scale_ptr(c, home, layer, h);
    s.vs = q8_scale_ptr(c, home, layer, Hkv + h);
  }
  return s;
}

template <bool PAGED, bool PACKED, int ARM>
__global__ void __launch_bounds__(THREADS, ARM == Q8_EXACT ? 3 : 4)
decode_q8_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ nk,
                       const bf16* __restrict__ nv, FusedQ8 c,
                       const int* __restrict__ lengths, const int* __restrict__ slot_ids,
                       float* __restrict__ pm, float* __restrict__ pl, float* __restrict__ pacc,
                       bf16* __restrict__ out, float* __restrict__ rs, Q8Append ap, int layer,
                       int Hkv, int G, int nsplit, int group, float scale) {
  constexpr bool REQUANT = ARM != Q8_EXACT;
  constexpr bool SCORE = ARM == Q8_ROW_SCORE;  // the whole row's score pass
  extern __shared__ __align__(16) unsigned char smq[];
  Q8Smem& sm = *reinterpret_cast<Q8Smem*>(smq);
  if constexpr (SCORE) pdl_launch_dependents();
  // the last splits first: the long rows' late splits start at once, and
  // the splits past short rows' fills exit while the SMs have room
  const int h = blockIdx.x, b = blockIdx.y, sp = nsplit - 1 - blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int S = c.S;
  const int w = lengths[b];
  const int row = slot_ids[b];
  const int we = (w < 0 || w >= S) ? 0 : w;  // a parked row attends its new vectors alone
  const int lo = sp * QCH;
  const int hi = min(lo + QCH, we + 1);  // exclusive
  if (lo >= hi) return;  // past the row's fill: no partial
  const int nlive = we / QCH + 1;  // the row's splits
  const size_t bh = (size_t)b * Hkv + h;
  const int kw = lo + wid * QWK;  // the warp's first key
  unsigned char(*const ring)[QSLOT] = sm.ring[wid];

  // stage 0..3 of the warp (K0, K1, V0, V1: 32 keys each) into its ring
  // slot, 16 bytes a lane: chunk lane % 8 of keys lane / 8 + 4r; zeros past
  // hi and at w
  Q8Stage st[2] = {};
#pragma unroll
  for (int s = 0; s < 2; ++s)
    if (kw + s * QSK < hi) st[s] = q8_stage<PAGED, PACKED>(c, layer, row, h, Hkv, kw + s * QSK);
  // ahead of the copies: the scales of the warp's keys (a key a lane a
  // stage), and the queries (a warp two heads, four dims a lane), this
  // step's K and V
  float kss[2] = {0.f, 0.f}, vss[2] = {0.f, 0.f};
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int pos = kw + s * QSK + lane;
    if (pos < hi && pos != we) {
      kss[s] = __bfloat162float(st[s].ks[lane * st[s].sstr]);
      vss[s] = __bfloat162float(st[s].vs[lane * st[s].sstr]);
    }
  }
  const bool ql = QL == 32 || lane < QL;  // the lane holds four of a row's values
  const bool dl = HD == THREADS || tid < HD;  // the thread owns output dim tid
  uint2 qraw[2] = {make_uint2(0u, 0u), make_uint2(0u, 0u)};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int g = wid + WARPS * j;
    if (g < G && ql)
      qraw[j] = *reinterpret_cast<const uint2*>(q + (bh * G + g) * HD + lane * 4);
  }
  const uint2 kraw =
      ql ? *reinterpret_cast<const uint2*>(nk + bh * HD + lane * 4) : make_uint2(0u, 0u);
  const bool w_in = we >= lo && we < hi;  // position w is this split's
  const float nvd = w_in && dl ? __bfloat162float(nv[bh * HD + tid]) : 0.f;
  auto copy_stage = [&](int stage) {
    const int s = stage & 1;
    const bool v = stage >= 2;
    unsigned char* dst = ring[stage == 3 ? 0 : stage];
#pragma unroll
    for (int r = 0; r < QSK * QCK / 32; ++r) {
      const int kk = lane / QCK + (32 / QCK) * r, ch = lane % QCK;
      const int pos = kw + s * QSK + kk;
      const int8_t* src = nullptr;
      if (pos < hi && pos != we) src = (v ? st[s].v : st[s].k) + (size_t)kk * HD + ch * 16;
      cp16(dst + (v ? slot_v(kk, ch) : slot_k(kk, ch)), src, c.q);
    }
    cp_commit();
  };
  copy_stage(0);
  copy_stage(1);
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    sm.ks[wid * QWK + s * QSK + lane] = kss[s];
    sm.vs[wid * QWK + s * QSK + lane] = vss[s];
  }
  // q rows to int8 and the exact score of position w; heads past G score
  // zeros
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int g = wid + WARPS * j;
    const __nv_bfloat162* q2 = reinterpret_cast<const __nv_bfloat162*>(&qraw[j]);
    const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&kraw);
    const float2 qa = __bfloat1622float2(q2[0]), qb = __bfloat1622float2(q2[1]);
    const float2 ka = __bfloat1622float2(k2[0]), kb = __bfloat1622float2(k2[1]);
    const float qf[4] = {qa.x, qa.y, qb.x, qb.y};
    const float amax = warp_max(fmaxf(fmaxf(fabsf(qf[0]), fabsf(qf[1])),
                                      fmaxf(fabsf(qf[2]), fabsf(qf[3]))));
    const float dot = warp_sum(qf[0] * ka.x + qf[1] * ka.y + qf[2] * kb.x + qf[3] * kb.y);
    const float qsc = fmaxf(amax * INV127, 1e-30f);
    unsigned packed = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      packed |= ((unsigned)(int)rintf(qf[e] / qsc) & 0xffu) << (8 * e);
    if (ql) *reinterpret_cast<unsigned*>(sm.q8 + g * Q8STR + lane * 4) = packed;
    if (lane == 0) {
      sm.qsc[g] = qsc;
      sm.snew[g] = dot * scale;
    }
  }
  __syncthreads();

  // scores of the warp's 64 keys: tile mt holds keys 16 mt .. 16 mt + 15;
  // c fragment j: key 16 mt + g + 8 (j / 2), head 2t + j % 2
  const int g = lane >> 2, t = lane & 3;
  // B fragments of head g's query: q8 over four 32-byte k-steps, or (the
  // exact arm) bf16 over eight 16-dim k-steps
  unsigned bq[HD / 16][2];
  if constexpr (REQUANT) {
#pragma unroll
    for (int ks = 0; ks < HD / 32; ++ks) {
      bq[ks][0] = ld32(sm.q8 + g * Q8STR + ks * 32 + 4 * t);
      bq[ks][1] = ld32(sm.q8 + g * Q8STR + ks * 32 + 16 + 4 * t);
    }
  } else {
    const bf16* qg = q + (bh * G + min(g, G - 1)) * HD + 2 * t;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      bq[ks][0] = g < G ? ld32(qg + 16 * ks) : 0u;
      bq[ks][1] = g < G ? ld32(qg + 16 * ks + 8) : 0u;
    }
  }
  float s[4][4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    cp_wait<1>();  // this lane's copies of K stage `half` have landed
    __syncwarp();
    const unsigned char* kst = ring[half];  // the K stage read
#pragma unroll
    for (int m2 = 0; m2 < 2; ++m2) {
      if constexpr (REQUANT) {
        // the A fragment by ldmatrix: lane gives row lr, chunk 2 ks + lane / 16
        const int lr = 16 * m2 + (lane & 8) + (lane & 7);
        int acc[4] = {0, 0, 0, 0};
#pragma unroll
        for (int ks = 0; ks < HD / 32; ++ks) {
          unsigned af[4];
          ldsm_x4(af, kst + slot_k(lr, 2 * ks + (lane >> 4)));
          mma_s8(acc, af, bq[ks][0], bq[ks][1]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) s[2 * half + m2][j] = (float)acc[j];
      } else {
        const int r0 = 16 * m2 + g, r1 = r0 + 8;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < HD / 16; ++ks) {
          const unsigned char* k0 = kst + slot_k(r0, ks) + 2 * t;
          const unsigned char* k1 = kst + slot_k(r1, ks) + 2 * t;
          const unsigned af[4] = {i8x2_bf16x2(ld16(k0)), i8x2_bf16x2(ld16(k1)),
                                  i8x2_bf16x2(ld16(k0 + 8)), i8x2_bf16x2(ld16(k1 + 8))};
          mma_bf16(acc, af, bq[ks][0], bq[ks][1]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) s[2 * half + m2][j] = acc[j];
      }
    }
    __syncwarp();  // K stage `half` scored by every lane: V stage `half` follows
    if constexpr (SCORE) cp_commit();  // no V read: an empty group keeps the count
    else copy_stage(2 + half);
  }
  // dequantize, position w's exact score, the mask past hi; the warp's max
  float mw[2] = {NEG_BIG, NEG_BIG};
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = 16 * mt + g + 8 * (j >> 1), hd2 = 2 * t + (j & 1), pos = kw + key;
      const float ks = sm.ks[wid * QWK + key];
      float v = REQUANT ? s[mt][j] * (scale * sm.qsc[hd2]) * ks : s[mt][j] * scale * ks;
      if (pos == we) v = sm.snew[hd2];
      s[mt][j] = pos < hi ? v : NEG_BIG;
      mw[j & 1] = fmaxf(mw[j & 1], s[mt][j]);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) mw[i] = fmaxf(mw[i], __shfl_xor_sync(0xffffffffu, mw[i], o));
  // e = e^(s - mw) (0 past hi), kept in s; the warp's sum of e and, per
  // stage, its max of e * vss off w
  float lw[2] = {0.f, 0.f}, aw[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // aw [stage][head]
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = 16 * mt + g + 8 * (j >> 1), i = j & 1, pos = kw + key;
      const float e = pos < hi ? __expf(s[mt][j] - mw[i]) : 0.f;
      s[mt][j] = e;
      lw[i] += e;
      if (REQUANT && pos != we)
        aw[mt >> 1][i] = fmaxf(aw[mt >> 1][i], e * sm.vs[wid * QWK + key]);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      lw[i] += __shfl_xor_sync(0xffffffffu, lw[i], o);
      aw[0][i] = fmaxf(aw[0][i], __shfl_xor_sync(0xffffffffu, aw[0][i], o));
      aw[1][i] = fmaxf(aw[1][i], __shfl_xor_sync(0xffffffffu, aw[1][i], o));
    }
  if (g == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sm.xm[wid][2 * t + i] = mw[i];
      sm.xl[wid][2 * t + i] = lw[i];
      sm.xa[wid][0][2 * t + i] = aw[0][i];
      sm.xa[wid][1][2 * t + i] = aw[1][i];
    }
  }
  __syncthreads();  // the exchange: every warp's max, sum and stage maxima
  if constexpr (SCORE) {
    // the split's (m, a) of each head: its max, and its max of e^(s - m) *
    // vss off w over every stage
    if (tid < G) {
      float mm = NEG_BIG, aa = 0.f;
#pragma unroll
      for (int x = 0; x < WARPS; ++x) mm = fmaxf(mm, sm.xm[x][tid]);
#pragma unroll
      for (int x = 0; x < WARPS; ++x)
        aa = fmaxf(aa, fmaxf(sm.xa[x][0][tid], sm.xa[x][1][tid]) * __expf(sm.xm[x][tid] - mm));
      float* r = rs + ((bh * nsplit + sp) * G + tid) * 2;
      r[0] = mm;
      r[1] = aa;
    }
    return;
  }

  // the split max M, each warp's factor e^(m - M), and each of this warp's
  // stages' group scale: the max of p * vss over every stage of its group,
  // whichever warp holds it
  float M[2], fx[2][WARPS], psc[2][2], rpsc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    M[i] = NEG_BIG;
#pragma unroll
    for (int x = 0; x < WARPS; ++x) M[i] = fmaxf(M[i], sm.xm[x][2 * t + i]);
#pragma unroll
    for (int x = 0; x < WARPS; ++x) fx[i][x] = __expf(sm.xm[x][2 * t + i] - M[i]);
  }
  if constexpr (ARM == Q8_ROW) {
    // the whole row's scale, once the score pass has written every split's
    // (m, a): the row max is the reference max of every split
    pdl_wait();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float p = 1.f;  // a head past G scores zeros: any bounded scale
      if (2 * t + i < G) {
        const float2 r = q8_row_max(rs, bh * nsplit * G + 2 * t + i, nlive, G);
        M[i] = r.x;
        p = fmaxf(r.y * INV127, 1e-30f);
        if (wid == 0 && g == 0) sm.rowm[2 * t + i] = M[i];
      }
      psc[0][i] = psc[1][i] = p;
      rpsc[0][i] = rpsc[1][i] = 1.f / p;
    }
  } else if constexpr (REQUANT) {
    const int gh = group / QSK;  // stages a group covers
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int z0 = (2 * wid + half) / gh * gh;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float gmax = 0.f;
#pragma unroll
        for (int z = 0; z < 2 * WARPS; ++z)
          if (z >= z0 && z < z0 + gh)
            gmax = fmaxf(gmax, sm.xa[z >> 1][z & 1][2 * t + i] * fx[i][z >> 1]);
        psc[half][i] = fmaxf(gmax * INV127, 1e-30f);
        rpsc[half][i] = 1.f / psc[half][i];
      }
    }
  }
  // p = e * e^(mw - M): p at w, and p * vss as p8 (or f32) in the spent K1
  // slot
  const float fw[2] = {__expf(mw[0] - M[0]), __expf(mw[1] - M[1])};  // fx of this warp
  int8_t* const p8 = reinterpret_cast<int8_t*>(ring[1]);
  float* const pf = reinterpret_cast<float*>(ring[1]);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = 16 * mt + g + 8 * (j >> 1), i = j & 1, pos = kw + key;
      const float p = s[mt][j] * fw[i];
      if (pos == we) sm.pw[2 * t + i] = p;
      const float pv = pos == we ? 0.f : p * sm.vs[wid * QWK + key];
      if constexpr (REQUANT)
        p8[(2 * t + i) * P8STR + key] = (int8_t)min((int)rintf(pv * rpsc[mt >> 1][i]), 127);
      else
        pf[key * MAXG + 2 * t + i] = pv;
    }
  __syncwarp();

  // PV over the warp's V stages; its partial [head][dim] then goes to the
  // V0 slot
  float* const red = reinterpret_cast<float*>(ring[2]);
  if constexpr (REQUANT) {
    // dim quad c = 8 jj + g: tile (jj, ab) rows g / g + 8 are dims 4c + 2ab
    // and 4c + 2ab + 1; c fragment r: that dim + r / 2, head 2t + r % 2
    float acc[HD / 32][2][4] = {};
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      if (ks == 0) cp_wait<1>();  // this lane's V stage 0 has landed
      else cp_wait<0>();
      __syncwarp();
      const unsigned char* vst = ring[ks ? 0 : 2];  // the V stage read
      const unsigned b0 = ld32(p8 + g * P8STR + ks * QSK + 4 * t);
      const unsigned b1 = ld32(p8 + g * P8STR + ks * QSK + 16 + 4 * t);
#pragma unroll
      for (int jj = 0; jj < HD / 32; ++jj) {
        const int cq = 8 * jj + g;
        unsigned o[2][4];
#pragma unroll
        for (int kq = 0; kq < 2; ++kq) {
          unsigned wv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int kr = 16 * kq + 4 * t + i;
            wv[i] = ld32(vst + slot_v(kr, cq >> 2) + (cq & 3) * 4);
          }
          transpose4(wv, o[kq]);
        }
#pragma unroll
        for (int ab = 0; ab < 2; ++ab) {
          const unsigned af[4] = {o[0][2 * ab], o[0][2 * ab + 1], o[1][2 * ab], o[1][2 * ab + 1]};
          int ci[4] = {0, 0, 0, 0};
          mma_s8(ci, af, b0, b1);
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[jj][ab][r] += (float)ci[r] * psc[ks][r & 1];
        }
      }
    }
    __syncwarp();  // every lane's V reads, before the partial
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (2 * t + i >= G) continue;
#pragma unroll
      for (int jj = 0; jj < HD / 32; ++jj)
        *reinterpret_cast<float4*>(red + (2 * t + i) * HD + 4 * (8 * jj + g)) = make_float4(
            acc[jj][0][i], acc[jj][0][2 + i], acc[jj][1][i], acc[jj][1][2 + i]);
    }
  } else {
    // a lane dims 4 lane .. 4 lane + 3 of every head, FMA over the keys
    float acc[MAXG][4] = {};
    cp_wait<0>();
    __syncwarp();
    const int nkeys = ql ? min(QWK, hi - kw) : 0;  // lanes past the row's dims idle
    for (int key = 0; key < nkeys; ++key) {
      const int kr = key & (QSK - 1);
      const unsigned vw =
          ld32(ring[key < QSK ? 2 : 0] + slot_v(kr, lane >> 2) + (lane & 3) * 4);
      const float x[4] = {(float)(int8_t)(vw & 0xff), (float)(int8_t)((vw >> 8) & 0xff),
                          (float)(int8_t)((vw >> 16) & 0xff), (float)(int8_t)(vw >> 24)};
      const float4 p0 = *reinterpret_cast<const float4*>(pf + key * MAXG);
      const float4 p1 = *reinterpret_cast<const float4*>(pf + key * MAXG + 4);
      const float ph[MAXG] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int gg = 0; gg < MAXG; ++gg)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[gg][e] = fmaf(ph[gg], x[e], acc[gg][e]);
    }
    __syncwarp();
#pragma unroll
    for (int gg = 0; gg < MAXG; ++gg)
      if (gg < G && ql)
        *reinterpret_cast<float4*>(red + gg * HD + 4 * lane) =
            make_float4(acc[gg][0], acc[gg][1], acc[gg][2], acc[gg][3]);
  }
  __syncthreads();  // every warp's partial

  // this split's (M, l, acc) of each head, thread tid output dim tid, the
  // warps' partials summed in warp order
  float o[MAXG];
#pragma unroll
  for (int gg = 0; gg < MAXG; ++gg) {
    o[gg] = 0.f;
    if (gg < G && dl) {
#pragma unroll
      for (int x = 0; x < WARPS; ++x)
        o[gg] += reinterpret_cast<const float*>(sm.ring[x][2])[gg * HD + tid];
      if (w_in) o[gg] += sm.pw[gg] * nvd;
    }
  }
  if (tid < G) {
    float mm = NEG_BIG, ls = 0.f;
    if constexpr (ARM == Q8_ROW) {
      mm = sm.rowm[tid];
    } else {
#pragma unroll
      for (int x = 0; x < WARPS; ++x) mm = fmaxf(mm, sm.xm[x][tid]);
    }
#pragma unroll
    for (int x = 0; x < WARPS; ++x) ls += sm.xl[x][tid] * __expf(sm.xm[x][tid] - mm);
    sm.fm[tid] = mm;
    sm.fl[tid] = ls;
  }
  __syncthreads();
  // the fused append, by the split that holds w of a row that is not
  // parked: warp 0 K, warp 1 V (a lane four values), warp 2 of KV head 0
  // the packed row's zero tail
  if (ap.q != nullptr && w_in && w == we && wid < 3) {
    const int Hs = c.Hs;
    const size_t lr = (size_t)layer * c.B + row;
    int8_t* const prow = ap.q + ((lr * c.Hf + Hs) * c.S + w) * HD;  // packed scales
    if (wid < 2) {
      const uint2 raw = wid == 0 || !ql ? kraw
                                        : *reinterpret_cast<const uint2*>(nv + bh * HD + lane * 4);
      const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float2 xa = __bfloat1622float2(x2[0]), xb = __bfloat1622float2(x2[1]);
      const float f[4] = {xa.x, xa.y, xb.x, xb.y};
      float amax = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) amax = fmaxf(amax, fabsf(f[e]));
      amax = warp_max(amax);
      const float s = amax * INV127;
      const float d = fmaxf(s, 1e-30f);
      unsigned packed = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qv = s > 0.f ? (int)rintf(__fdiv_rn(f[e], d)) : 0;
        packed |= ((unsigned)qv & 0xffu) << (8 * e);
      }
      const int head = wid == 0 ? h : Hkv + h;
      if (ql)
        *reinterpret_cast<unsigned*>(ap.q + ((lr * c.Hf + head) * c.S + w) * HD + lane * 4) =
            packed;
      if (lane == 0) {
        const bf16 sb = __float2bfloat16_rn(s);
        ap.s[(lr * Hs + head) * c.S + w] = sb;
        if (c.Hf > Hs) reinterpret_cast<bf16*>(prow)[head] = sb;
      }
    } else if (h == 0 && c.Hf > Hs && lane >= Hkv && ql) {
      reinterpret_cast<unsigned*>(prow)[lane] = 0u;  // bytes 2 * Hs .. HD - 1
    }
  }
  if (nlive == 1) {  // the row's only split: its output
#pragma unroll
    for (int gg = 0; gg < MAXG; ++gg)
      if (gg < G && dl) out[(bh * G + gg) * HD + tid] = __float2bfloat16(o[gg] / sm.fl[gg]);
    return;
  }
  const size_t pidx = bh * nsplit + sp;
#pragma unroll
  for (int gg = 0; gg < MAXG; ++gg)
    if (gg < G && dl) pacc[(pidx * G + gg) * HD + tid] = o[gg];
  if (tid < G) {
    pm[pidx * G + tid] = sm.fm[tid];
    pl[pidx * G + tid] = sm.fl[tid];
  }
  // the row's last split to arrive combines them all, in split order
  __syncthreads();
  if (tid == 0) {
    __threadfence();  // the CTA's partial (ordered by the barrier) before its arrival
    const bool last = atomicAdd(&q8_arrivals[bh], 1) == nlive - 1;
    __threadfence();  // and the other splits' partials after it
    if (last) q8_arrivals[bh] = 0;  // for the next call
    sm.last = last;
  }
  __syncthreads();
  if (!sm.last) return;
  // a warp a head, four dims a lane; 32 splits at a time: their max and
  // weights a split a lane, their partials sixteen at a time in flight
  for (int gg = wid; gg < G; gg += WARPS) {
    const size_t base = bh * nsplit * G + gg;  // pm / pl of split z at base + z * G
    float mx = NEG_BIG, ls = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int z0 = 0; z0 < nlive; z0 += 32) {
      const int n = min(32, nlive - z0);
      const float4* pz = reinterpret_cast<const float4*>(pacc + (base + z0 * G) * HD) + lane;
      float4 v[16];
#pragma unroll
      for (int k = 0; k < 16; ++k)  // the first partials, in flight with the weights
        if (k < n && ql) v[k] = __ldcg(pz + (size_t)k * G * (HD / 4));
      const float mz = lane < n ? __ldcg(pm + base + (z0 + lane) * G) : NEG_BIG;
      const float lz = lane < n ? __ldcg(pl + base + (z0 + lane) * G) : 0.f;
      const float m2 = fmaxf(mx, warp_max(mz));
      const float r = __expf(mx - m2), ez = __expf(mz - m2);
      mx = m2;
      ls = ls * r + warp_sum(lz * ez);
      acc = make_float4(acc.x * r, acc.y * r, acc.z * r, acc.w * r);
      for (int k0 = 0; k0 < n; k0 += 16) {
        if (k0 > 0) {
#pragma unroll
          for (int k = 0; k < 16; ++k)
            if (k0 + k < n && ql) v[k] = __ldcg(pz + (size_t)(k0 + k) * G * (HD / 4));
        }
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const float e = __shfl_sync(0xffffffffu, ez, (k0 + k) & 31);
          if (k0 + k < n) {
            acc.x += e * v[k].x;
            acc.y += e * v[k].y;
            acc.z += e * v[k].z;
            acc.w += e * v[k].w;
          }
        }
      }
    }
    if (!ql) continue;
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(out + (bh * G + gg) * HD + 4 * lane);
    o2[0] = __floats2bfloat162_rn(acc.x / ls, acc.y / ls);
    o2[1] = __floats2bfloat162_rn(acc.z / ls, acc.w / ls);
  }
}

// A group the split can keep: 0 (the exact arm), or 32..QCH keys in whole
// copy stages that tile the split.
__host__ __device__ constexpr bool q8_group_fits(int group) {
  return group == 0 || (group >= QSK && group <= QCH && group % QSK == 0 && QCH % group == 0);
}

// Launch one arm of the int8 kernel; `after`: programmatic dependent
// launch, to start while the stream's previous kernel (the score pass)
// runs.
template <bool PAGED, bool PACKED, int ARM>
int launch_q8_arm(const void* q, const void* nk, const void* nv, const FusedQ8& c,
                  const void* lengths, const void* slot_ids, void* pm, void* pl, void* pacc,
                  void* out, float* rs, const Q8Append& ap, int layer, int Ba, int Hkv, int G,
                  int nsplit, int group, float scale, bool after, cudaStream_t st) {
  auto kernel = decode_q8_split_kernel<PAGED, PACKED, ARM>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)sizeof(Q8Smem));
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Hkv, Ba, nsplit);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = sizeof(Q8Smem);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = after ? 1 : 0;
  return (int)cudaLaunchKernelEx(&cfg, kernel, (const bf16*)q, (const bf16*)nk, (const bf16*)nv,
                                 c, (const int*)lengths, (const int*)slot_ids, (float*)pm,
                                 (float*)pl, (float*)pacc, (bf16*)out, rs, ap, layer, Hkv, G,
                                 nsplit, group, scale);
}

template <bool PACKED>
int launch_q8_row(const void* q, const void* nk, const void* nv, const FusedQ8& c,
                  const void* lengths, const void* slot_ids, void* pm, void* pl, void* pacc,
                  void* out, float* rs, const Q8Append& ap, int layer, int Ba, int Hkv, int G,
                  int nsplit, int group, float scale, cudaStream_t st) {
  const int rc = launch_q8_arm<false, PACKED, Q8_ROW_SCORE>(
      q, nk, nv, c, lengths, slot_ids, pm, pl, pacc, out, rs, Q8Append{nullptr, nullptr}, layer,
      Ba, Hkv, G, nsplit, group, scale, false, st);
  if (rc != 0) return rc;
  return launch_q8_arm<false, PACKED, Q8_ROW>(q, nk, nv, c, lengths, slot_ids, pm, pl, pacc,
                                              out, rs, ap, layer, Ba, Hkv, G, nsplit, group,
                                              scale, true, st);
}

template <bool PAGED>
int launch_q8(const void* q, const void* nk, const void* nv, const FusedQ8& c,
              const void* lengths, const void* slot_ids, void* pm, void* pl, void* pacc,
              void* out, int layer, int Ba, int Hkv, int G, int hd, int chunk, int nsplit,
              int group, float scale, float* rs, const Q8Append& ap, void* stream) {
  // the whole row: group S where no group inside a split can stand for it
  const bool row = !PAGED && group == c.S && !q8_group_fits(group);
  if (hd != HD || G > MAXG || G < 1 || chunk != QCH || nsplit != (c.S + QCH - 1) / QCH ||
      !(q8_group_fits(group) || row) || (PAGED && group == 0) || (row && rs == nullptr) ||
      c.Hs != 2 * Hkv || (c.Hf != c.Hs && c.Hf != c.Hs + 1) || (c.Hf > c.Hs && 2 * c.Hs > HD) ||
      (size_t)Ba * Hkv > Q8_ARRIVALS)
    return (int)cudaErrorInvalidValue;
  const bool packed = c.Hf > c.Hs;
  cudaStream_t st = (cudaStream_t)stream;
  if (row)
    return (packed ? launch_q8_row<true> : launch_q8_row<false>)(
        q, nk, nv, c, lengths, slot_ids, pm, pl, pacc, out, rs, ap, layer, Ba, Hkv, G, nsplit,
        group, scale, st);
  auto arm = packed ? (group ? launch_q8_arm<PAGED, true, Q8_GROUP>
                             : launch_q8_arm<false, true, Q8_EXACT>)
                    : (group ? launch_q8_arm<PAGED, false, Q8_GROUP>
                             : launch_q8_arm<false, false, Q8_EXACT>);
  return arm(q, nk, nv, c, lengths, slot_ids, pm, pl, pacc, out, rs, ap, layer, Ba, Hkv, G,
             nsplit, group, scale, false, st);
}

}  // namespace

