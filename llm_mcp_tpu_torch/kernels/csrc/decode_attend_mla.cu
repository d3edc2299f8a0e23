// decode_attend_q8_mla / decode_attend_q8_mla_paged: absorbed MLA decode
// attention over the int8 latent cache, PRE-append.
//
// Replaces: llm_mcp_tpu/kernels/attention.py `_attend_q8_mla_kernel`
// (whole-S arm), `_attend_q8_mla_blocked_kernel` (blocked arm) and
// `_attend_q8_mla_paged_kernel` (paged arm), all behind
// `decode_attend_q8_mla`. Their arithmetic is kept, per batch row b and
// head h: q̃ is requantized per head (qsc = max(max|q̃| / 127, 1e-30));
// latent scores are s8 x s8 -> s32 dots (`__dp4a`), times scale * qsc * ls;
// rope scores are f32 dots over the rope keys dequantized (rop * rs), times
// scale; position w takes the exact score of this step's latent and rope
// key; after the softmax, p * ls (0 at w) is requantized to int8 per group
// of keys with its own psc = max(max / 127, 1e-30), and the context is
// sum_g psc_g * (p8 . lat)_g + p_w * c_new, over l.
//
// The requantization group decides the numbers, so it is an argument: the
// whole row (JAX's whole-S arm, which JAX serves whenever the row fits its
// VMEM budget: S = 4096 at DeepSeek-V2-Lite's shapes), the block size
// (blocked arm), bt (paged arm), or 0 for JAX's exact fallback, which does
// not requantize at all (f32 latent dots and PV). A CTA takes one (row,
// head) and `chunk` consecutive keys of it, whole groups only: pass 1
// writes every key's score, with its latent scale and its home (resolved
// through the table once), to shared memory (one thread a key, 16-byte
// loads of its latent row, 16 in flight); pass 2 takes the softmax and the
// groups' maxima over the stored scores, exactly, and stores p8; pass 3
// streams the latents again for the PV product (a thread a 4-column slice,
// two halves of the CTA on alternate keys, 32 keys' loads issued together,
// int32 accumulators flushed at each group boundary). p8 does not depend on
// the scale of its group, so these are JAX's p8 up to f32 rounding.
//
// A whole-row group forbids splitting a row, so chunk = S there (JAX's
// whole-S arm only runs where the row fits). The other groups let a long
// row split: each CTA then writes its unnormalized context with its max
// and sum, and a second kernel combines a row's chunks (flash decoding),
// which is how the blocked arm's rows (S past the whole-S budget, e.g.
// 16384 at V2-Lite) fit shared memory.
//
// Bound on the H100: bytes (580 a key: 512 + 64 int8 and two bf16 scales,
// one pass over the attended prefix). This first version reads each row's
// latents twice per CTA and once per head, from L2 mostly. Tensor cores
// are later work.
//
// A row parked at w >= S attends its new vectors alone (its output is
// c_new) and reads no cache. Paged: every key resolves through row
// rows[b]'s table (paged.cuh), to an arena home or a pool row.
//
// Layouts: qt [Ba, H, R], qr [Ba, H, dr], c_new [Ba, R], r_new [Ba, dr]
// bf16; latents {q int8 [L, B, 1, S, R], s bf16 [L, B, 1, S]}, rope keys
// {q [L, B, 1, S, dr], s}; pools the same with [L, pxb, 1, bt, ...];
// lengths/rows [Ba] int32; tables [B, nbs] int32; out [Ba, H, R] bf16;
// with more than one chunk a row, the f32 workspaces part [Ba, H, nsplit,
// R] and ml [Ba, H, nsplit, 2]. R = 512, dr = 64. `x / 127` is a
// multiplication by the float32 reciprocal, as XLA compiles the Pallas
// bodies' division by the constant.

#include "paged.cuh"

namespace {

constexpr int R = 512;   // kv_lora_rank
constexpr int DR = 64;   // qk_rope_head_dim
constexpr int RW = R / 4;  // int32 words of an int8 latent row
constexpr int THREADS = 256;
constexpr int COMBINE_THREADS = 128;
constexpr int UNR = 32;  // keys whose loads a thread issues together in pass 3
constexpr float INV127 = 1.0f / 127.0f;

struct LatentCache {
  const int8_t* lq;   // latent payload [L, B, 1, S, R]
  const bf16* ls;     // latent scales [L, B, 1, S]
  const int8_t* rq;   // rope payload [L, B, 1, S, DR]
  const bf16* rs;     // rope scales
  const int* tbl;     // paged: [B, nbs]
  const int8_t* plq;  // paged: pools [L, pxb, 1, bt, ...]
  const bf16* pls;
  const int8_t* prq;
  const bf16* prs;
  int B, S, nbs, bt, pxb;
};

// The home of key `pos` of cache row `row`: which plane (pool or arena) and
// its token index into that plane's [L, rows, 1, tokens] layout.
struct Tok {
  bool pool;
  size_t t;
};

template <bool PAGED>
__device__ __forceinline__ Tok key_tok(const LatentCache& c, int layer, int row, int pos) {
  if constexpr (PAGED) {
    const KeyHome k = paged_home(c.tbl, c.nbs, c.bt, c.pxb, c.B, row, pos);
    if (k.pool) return {true, ((size_t)layer * c.pxb + k.row) * c.bt + k.t};
    return {false, ((size_t)layer * c.B + k.row) * c.S + k.t};
  }
  return {false, ((size_t)layer * c.B + row) * c.S + pos};
}

// A key's home packed in 32 bits for pass 3: the token index, bit 31 set
// for a pool row (tokens of a layer-stacked plane stay below 2^31).
__device__ __forceinline__ unsigned tok_code(const Tok& k) {
  return (unsigned)k.t | (k.pool ? 0x80000000u : 0u);
}

__device__ __forceinline__ float i8(unsigned w, int e) {
  return (float)(int8_t)(w >> (8 * e));
}

// grid (H, Ba, nsplit): head h of row b, keys [z * chunk, (z + 1) * chunk)
template <bool PAGED, bool REQUANT>
__global__ void __launch_bounds__(THREADS)
mla_decode_kernel(const bf16* __restrict__ qt, const bf16* __restrict__ qr,
                  const bf16* __restrict__ cnew, const bf16* __restrict__ rnew, LatentCache c,
                  const int* __restrict__ lengths, const int* __restrict__ rows,
                  bf16* __restrict__ out, float* __restrict__ part, float* __restrict__ ml,
                  int layer, int H, int group, int chunk, int ngroups, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sc = reinterpret_cast<float*>(smem);             // [chunk] scores, then p * ls
  float* lss = sc + chunk;                                 // [chunk] latent scales
  unsigned* toks = reinterpret_cast<unsigned*>(lss + chunk);  // [chunk] homes (tok_code)
  int8_t* p8 = reinterpret_cast<int8_t*>(toks + chunk);    // [chunk]
  int* pmax = reinterpret_cast<int*>(smem + (((size_t)chunk * 13 + 15) & ~(size_t)15));  // [ngroups]
  __shared__ float qf[R];
  __shared__ int qw[RW];
  __shared__ float qrs[DR];
  __shared__ float comb[R];
  __shared__ float red[THREADS / 32];
  __shared__ float qsc_s, snew_s, m_s, l_s, pw_s;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int z = blockIdx.z;
  const int nsplit = gridDim.z;
  const size_t bh = (size_t)b * H + h;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const int S = c.S;
  const int w = lengths[b];
  const int we = (w < 0 || w >= S) ? 0 : w;  // a parked row attends its new vectors alone
  const int k0 = z * chunk;
  const int n = min(we + 1 - k0, chunk);  // this CTA's keys: positions k0 .. k0 + n - 1
  const int wl = we - k0;                  // position w among them (n - 1 when here)

  if (n <= 0) {  // past the row's fill: an empty part (only when nsplit > 1)
    if (tid == 0) {
      ml[(bh * nsplit + z) * 2] = NEG_BIG;
      ml[(bh * nsplit + z) * 2 + 1] = 0.f;
    }
    for (int i = tid; i < R; i += THREADS) part[(bh * nsplit + z) * R + i] = 0.f;
    return;
  }
  const int row = rows[b];

  for (int i = tid; i < R; i += THREADS) qf[i] = __bfloat162float(qt[bh * R + i]);
  for (int i = tid; i < DR; i += THREADS) qrs[i] = __bfloat162float(qr[bh * DR + i]);
  if constexpr (REQUANT)
    for (int i = tid; i < ngroups; i += THREADS) pmax[i] = 0;
  if (tid == 0) pw_s = 0.f;
  __syncthreads();
  // qsc and the exact score of position w
  if (wid == 0) {
    float amax = 0.f, dc = 0.f, dr = 0.f;
    for (int d = lane; d < R; d += 32) {
      const float v = qf[d];
      amax = fmaxf(amax, fabsf(v));
      dc = fmaf(v, __bfloat162float(cnew[(size_t)b * R + d]), dc);
    }
    for (int d = lane; d < DR; d += 32)
      dr = fmaf(qrs[d], __bfloat162float(rnew[(size_t)b * DR + d]), dr);
    amax = warp_max(amax);
    dc = warp_sum(dc);
    dr = warp_sum(dr);
    if (lane == 0) {
      qsc_s = fmaxf(amax * INV127, 1e-30f);
      snew_s = (dc + dr) * scale;
    }
  }
  __syncthreads();
  if constexpr (REQUANT) {
    for (int k = tid; k < RW; k += THREADS) {
      unsigned packed = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        packed |= ((unsigned)(int)rintf(qf[4 * k + e] / qsc_s) & 0xffu) << (8 * e);
      qw[k] = (int)packed;
    }
    __syncthreads();
  }

  // pass 1: one thread a key, its whole latent and rope rows
  for (int p = tid; p < n; p += THREADS) {
    float s;
    if (p == wl) {
      s = snew_s;
    } else {
      const Tok k = key_tok<PAGED>(c, layer, row, k0 + p);
      const int8_t* lp = (k.pool ? c.plq : c.lq) + k.t * R;
      const int8_t* rp = (k.pool ? c.prq : c.rq) + k.t * DR;
      const float lsc = __bfloat162float((k.pool ? c.pls : c.ls)[k.t]);
      const float rsc = __bfloat162float((k.pool ? c.prs : c.rs)[k.t]);
      lss[p] = lsc;
      toks[p] = tok_code(k);
      int si = 0;
      float sf = 0.f, sr = 0.f;
#pragma unroll 16
      for (int k16 = 0; k16 < R / 16; ++k16) {
        const uint4 v = *reinterpret_cast<const uint4*>(lp + 16 * k16);
        const unsigned wv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (REQUANT) {
            si = __dp4a((int)wv[j], qw[4 * k16 + j], si);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) sf = fmaf(qf[16 * k16 + 4 * j + e], i8(wv[j], e), sf);
          }
        }
      }
#pragma unroll
      for (int k16 = 0; k16 < DR / 16; ++k16) {
        const uint4 v = *reinterpret_cast<const uint4*>(rp + 16 * k16);
        const unsigned wv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // the kernel arm dequantizes the rope key before its dot; the
            // exact fallback scales the dot
            const float x = REQUANT ? i8(wv[j], e) * rsc : i8(wv[j], e);
            sr = fmaf(qrs[16 * k16 + 4 * j + e], x, sr);
          }
      }
      if constexpr (REQUANT)
        s = (float)si * (scale * qsc_s) * lsc + sr * scale;
      else
        s = (sf * lsc + sr * rsc) * scale;
    }
    sc[p] = s;
  }
  __syncthreads();

  // pass 2: the softmax over the stored scores, p * ls, the groups' maxima
  {
    float mx = NEG_BIG;
    for (int p = tid; p < n; p += THREADS) mx = fmaxf(mx, sc[p]);
    mx = warp_max(mx);
    if (lane == 0) red[wid] = mx;
    __syncthreads();
    if (tid == 0) {
      float m = NEG_BIG;
      for (int i = 0; i < THREADS / 32; ++i) m = fmaxf(m, red[i]);
      m_s = m;
    }
    __syncthreads();
  }
  {
    float lsum = 0.f;
    // all lanes run the same trip count so the warp-wide group max below
    // sees every lane
    for (int p0 = wid * 32; p0 < n; p0 += THREADS) {
      const int p = p0 + lane;
      const bool live = p < n;
      float pv = 0.f;
      if (live) {
        const float e = expf(sc[p] - m_s);
        lsum += e;
        if (p == wl) pw_s = e;
        pv = (p == wl) ? 0.f : e * lss[p];
        sc[p] = pv;
      }
      if constexpr (REQUANT) {
        const int g = min(p, n - 1) / group;
        const int g0 = __shfl_sync(0xffffffffu, g, 0);
        if (__all_sync(0xffffffffu, g == g0)) {
          const float m = warp_max(pv);
          if (lane == 0) atomicMax(&pmax[g0], __float_as_int(m));
        } else {
          atomicMax(&pmax[g], __float_as_int(pv));
        }
      }
    }
    lsum = warp_sum(lsum);
    if (lane == 0) red[wid] = lsum;
    __syncthreads();
    if (tid == 0) {
      float l = 0.f;
      for (int i = 0; i < THREADS / 32; ++i) l += red[i];
      l_s = l;
    }
    if constexpr (REQUANT) {
      for (int p = tid; p < n; p += THREADS) {
        const float psc = fmaxf(__int_as_float(pmax[p / group]) * INV127, 1e-30f);
        p8[p] = (int8_t)(int)rintf(sc[p] / psc);
      }
    }
    __syncthreads();
  }

  // pass 3: P.V, a 4-column slice a thread, two halves on alternate keys
  const int half = tid >> 7;
  const int c0 = (tid & 127) * 4;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  int ci[4] = {0, 0, 0, 0};
  int gcur = 0;
  for (int p0 = half; p0 < n; p0 += 2 * UNR) {
    // UNR keys' loads first, then their products: the loads overlap
    unsigned v[UNR];
#pragma unroll
    for (int j = 0; j < UNR; ++j) {
      const int p = p0 + 2 * j;
      v[j] = 0u;  // position w (p8 = 0; the exact c_new is added below) and past the end
      if (p < n && p != wl) {
        const unsigned code = toks[p];  // resolved once, in pass 1
        const int8_t* base = (code & 0x80000000u) ? c.plq : c.lq;
        v[j] = *reinterpret_cast<const unsigned*>(base + (size_t)(code & 0x7fffffffu) * R + c0);
      }
    }
#pragma unroll
    for (int j = 0; j < UNR; ++j) {
      const int p = p0 + 2 * j;
      if (p >= n) break;
      if constexpr (REQUANT) {
        const int q = p8[p];
        const int g = p / group;
        if (g != gcur) {
          const float psc = fmaxf(__int_as_float(pmax[gcur]) * INV127, 1e-30f);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[e] += (float)ci[e] * psc;
            ci[e] = 0;
          }
          gcur = g;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) ci[e] += q * (int)(int8_t)(v[j] >> (8 * e));
      } else {
        const float pv = sc[p];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] = fmaf(pv, i8(v[j], e), acc[e]);
      }
    }
  }
  if constexpr (REQUANT) {
    const float psc = fmaxf(__int_as_float(pmax[gcur]) * INV127, 1e-30f);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += (float)ci[e] * psc;
  }
  if (half == 1)
#pragma unroll
    for (int e = 0; e < 4; ++e) comb[c0 + e] = acc[e];
  __syncthreads();
  if (half == 0) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float ctx = acc[e] + comb[c0 + e] + pw_s * __bfloat162float(cnew[(size_t)b * R + c0 + e]);
      if (nsplit == 1)
        out[bh * R + c0 + e] = __float2bfloat16(ctx / l_s);
      else
        part[(bh * nsplit + z) * R + c0 + e] = ctx;
    }
  }
  if (nsplit > 1 && tid == 0) {
    ml[(bh * nsplit + z) * 2] = m_s;
    ml[(bh * nsplit + z) * 2 + 1] = l_s;
  }
}

// grid (H, Ba): a row's chunks, each relative to its own max, onto one max
__global__ void __launch_bounds__(COMBINE_THREADS)
mla_decode_combine(const float* __restrict__ part, const float* __restrict__ ml,
                   bf16* __restrict__ out, int nsplit) {
  const size_t bh = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  const float* mlr = ml + bh * nsplit * 2;
  float m = NEG_BIG;
  for (int z = 0; z < nsplit; ++z) m = fmaxf(m, mlr[2 * z]);
  float l = 0.f;
  for (int z = 0; z < nsplit; ++z) l += expf(mlr[2 * z] - m) * mlr[2 * z + 1];
  for (int col = threadIdx.x; col < R; col += COMBINE_THREADS) {
    float acc = 0.f;
    for (int z = 0; z < nsplit; ++z) acc += expf(mlr[2 * z] - m) * part[(bh * nsplit + z) * R + col];
    out[bh * R + col] = __float2bfloat16(acc / l);
  }
}

size_t dyn_smem(int chunk, int ngroups) {
  return (((size_t)chunk * 13 + 15) & ~(size_t)15) + (size_t)ngroups * 4;
}

template <bool PAGED, bool REQUANT>
int launch_arm(const void* qt, const void* qr, const void* cnew, const void* rnew,
               const LatentCache& c, const void* lengths, const void* rows, void* out,
               void* part, void* ml, int layer, int Ba, int H, int group, int chunk,
               float scale, cudaStream_t st) {
  const int nsplit = (c.S + chunk - 1) / chunk;
  const int ngroups = REQUANT ? (chunk + group - 1) / group : 0;
  if (nsplit > 1 && (part == nullptr || ml == nullptr)) return (int)cudaErrorInvalidValue;
  const size_t smem = dyn_smem(chunk, ngroups);
  cudaError_t e = cudaFuncSetAttribute(mla_decode_kernel<PAGED, REQUANT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  mla_decode_kernel<PAGED, REQUANT><<<dim3(H, Ba, nsplit), THREADS, smem, st>>>(
      (const bf16*)qt, (const bf16*)qr, (const bf16*)cnew, (const bf16*)rnew, c,
      (const int*)lengths, (const int*)rows, (bf16*)out, (float*)part, (float*)ml, layer, H,
      group, chunk, ngroups, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return (int)e;
  mla_decode_combine<<<dim3(H, Ba), COMBINE_THREADS, 0, st>>>((const float*)part,
                                                             (const float*)ml, (bf16*)out, nsplit);
  return (int)cudaGetLastError();
}

template <bool PAGED>
int launch(const void* qt, const void* qr, const void* cnew, const void* rnew,
           const LatentCache& c, const void* lengths, const void* rows, void* out, void* part,
           void* ml, int layer, int Ba, int H, int Rr, int dr, int group, int chunk, float scale,
           void* stream) {
  // a chunk covers whole groups: the whole row, or a multiple of the group
  if (Rr != R || dr != DR || group < 0 || c.S < 1 || chunk < 1 || chunk > c.S ||
      (chunk < c.S && group > 0 && chunk % group != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (group > 0)
    return launch_arm<PAGED, true>(qt, qr, cnew, rnew, c, lengths, rows, out, part, ml, layer,
                                   Ba, H, group, chunk, scale, st);
  return launch_arm<PAGED, false>(qt, qr, cnew, rnew, c, lengths, rows, out, part, ml, layer, Ba,
                                  H, 1, chunk, scale, st);
}

}  // namespace

extern "C" int decode_attend_q8_mla(const void* qt, const void* qr, const void* cnew,
                                    const void* rnew, const void* lat_q, const void* lat_s,
                                    const void* rop_q, const void* rop_s, const void* lengths,
                                    const void* rows, void* out, void* part, void* ml, int layer,
                                    int B, int Ba, int H, int S, int R_, int dr, int group,
                                    int chunk, float scale, void* stream) {
  const LatentCache c{(const int8_t*)lat_q, (const bf16*)lat_s, (const int8_t*)rop_q,
                      (const bf16*)rop_s, nullptr, nullptr, nullptr, nullptr, nullptr,
                      B, S, 0, 0, 0};
  return launch<false>(qt, qr, cnew, rnew, c, lengths, rows, out, part, ml, layer, Ba, H, R_, dr,
                       group, chunk, scale, stream);
}

extern "C" int decode_attend_q8_mla_paged(
    const void* qt, const void* qr, const void* cnew, const void* rnew, const void* lat_q,
    const void* lat_s, const void* rop_q, const void* rop_s, const void* lengths,
    const void* rows, const void* tbl, const void* plat_q, const void* plat_s,
    const void* prop_q, const void* prop_s, void* out, void* part, void* ml, int layer, int B,
    int Ba, int H, int S, int R_, int dr, int group, int chunk, int nbs, int bt, int pxb,
    float scale, void* stream) {
  if (nbs <= 0 || bt <= 0 || nbs * bt != S || pxb <= 0) return (int)cudaErrorInvalidValue;
  const LatentCache c{(const int8_t*)lat_q, (const bf16*)lat_s, (const int8_t*)rop_q,
                      (const bf16*)rop_s, (const int*)tbl, (const int8_t*)plat_q,
                      (const bf16*)plat_s, (const int8_t*)prop_q, (const bf16*)prop_s,
                      B, S, nbs, bt, pxb};
  return launch<true>(qt, qr, cnew, rnew, c, lengths, rows, out, part, ml, layer, Ba, H, R_, dr,
                      group, chunk, scale, stream);
}
