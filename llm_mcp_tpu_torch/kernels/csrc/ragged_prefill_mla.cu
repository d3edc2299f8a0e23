// ragged_prefill_attend_mla[_q8][_paged]: packed multi-row chunked prefill
// attention over the MLA latent cache, absorbed form.
//
// Replaces: llm_mcp_tpu/kernels/attention.py `_ragged_prefill_mla_kernel`
// (behind `ragged_prefill_attend_mla`), which covers bf16 and int8 latents
// in one body (ones for the scales at bf16) and identity or block tables.
// Here one templated kernel has the same four arms: the latent payload type
// (bf16 or int8) and the table (identity: the row's slot; paged: every key
// through tbl[r * nbs + p / bt], paged.cuh).
//
// A [T]-token buffer carries up to R rows' chunks back to back (the layout
// of ragged_prefill.cu). Each token t, for every head h, attends
//   (a) its row's cached prefix [0, starts[r]): score (q̃ . lat) * ls +
//       (qr . rop) * rs, times scale, value lat * ls;
//   (b) the chunk's own keys of its row at packed index <= t: score
//       q̃ . c + qr . kr, times scale, value c (exact, not quantized);
// with one online softmax over both, in f32 throughout, no requantization;
// a row that attends nothing emits 0. Pads (rowid R) attend earlier pads.
//
// Bound on the H100: operations, 2 * (R + dr) + 2 * R = 2176 flops per
// (query, key, head). The absorbed form is MQA-shaped: every head of a
// token scores against the same latent row, so a CTA owns 32 query rows,
// the (token, head) pairs of 32 / H tokens, and shares each 32-key tile of
// latent + rope rows across all of them. The [BQ, H, R] accumulator of the
// Pallas body is 4x wider than a GQA head, so a thread keeps 2 rows x 32
// columns of it in registers, and the query and key tiles live in shared
// memory as f32 rows padded to 580 floats (16-byte loads along the row,
// conflict-free). f32 FMA, not tensor cores: a first version.
//
// Layouts: qt [T, H, R], qr [T, H, dr], c_self [T, R], kr_self [T, dr]
// bf16; latents [L, B, 1, S, R] bf16 or {int8 q, bf16 s [L, B, 1, S]},
// rope keys [L, B, 1, S, dr] likewise; pools [L, pxb, 1, bt, ...]; rowids
// [T], offsets [R+1], slots/starts [R] int32; tables [R, nbs] (gathered to
// the descriptor rows by the wrapper); out [T, H, R] bf16. R = 512, dr = 64.

#include "paged.cuh"

namespace {

constexpr int RL = 512;  // kv_lora_rank
constexpr int DR = 64;   // qk_rope_head_dim
constexpr int D = RL + DR;
constexpr int BQ = 32;        // query rows a CTA
constexpr int BK = 32;        // keys a tile
constexpr int KSTR = D + 4;   // padded row stride (floats), a multiple of 4
constexpr int PSTR = BQ + 1;
constexpr int THREADS = 256;  // (ty, tx) = (tid / 16, tid % 16)
constexpr int CH = D / 8;     // 8-element chunks of a latent + rope row
constexpr size_t SMEM_FLOATS = (size_t)BQ * KSTR + BK * KSTR + BK * PSTR + 2 * BK;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);

template <class T>
struct Past {
  const T* lat;    // [L, B, 1, S, RL]
  const bf16* ls;  // int8: [L, B, 1, S]
  const T* rop;    // [L, B, 1, S, DR]
  const bf16* rs;
  const int* tbl;  // paged: [R, nbs]
  const T* plat;   // paged: pools [L, pxb, 1, bt, ...]
  const bf16* pls;
  const T* prop;
  const bf16* prs;
  int B, S, nbs, bt, pxb;
};

__device__ __forceinline__ void load8v(const bf16* p, float* out) { load8(p, out); }

__device__ __forceinline__ void load8v(const int8_t* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int e = 0; e < 8; ++e) out[e] = (float)b[e];
}

struct Smem {
  float* q;   // [BQ][KSTR]: q̃ | qr per query row
  float* k;   // [BK][KSTR]: latent | rope per key
  float* pT;  // [BK][PSTR]: probabilities (times ls for past keys)
  float* ls;  // [BK]
  float* rs;  // [BK]
  __device__ explicit Smem(float* base)
      : q(base), k(base + BQ * KSTR), pT(base + (BQ + BK) * KSTR),
        ls(base + (BQ + BK) * KSTR + BK * PSTR), rs(base + (BQ + BK) * KSTR + BK * PSTR + BK) {}
};

struct State {
  float acc[2][32];
  float m[2];
  float l[2];
};

// One key tile, once its rows and scales are in shared memory. `mask(r,
// kk)` says whether query row r may attend key kk (kk < nkeys).
template <class Mask>
__device__ void step_tile(const Smem& s, State& st, int nkeys, float scale, Mask mask) {
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  float sl[2][2], sr[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) sl[i][j] = sr[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < RL; d += 4) {
    const float4 q0 = *reinterpret_cast<const float4*>(s.q + ty * KSTR + d);
    const float4 q1 = *reinterpret_cast<const float4*>(s.q + (ty + 16) * KSTR + d);
    const float4 k0 = *reinterpret_cast<const float4*>(s.k + tx * KSTR + d);
    const float4 k1 = *reinterpret_cast<const float4*>(s.k + (tx + 16) * KSTR + d);
    sl[0][0] = fmaf(q0.x, k0.x, fmaf(q0.y, k0.y, fmaf(q0.z, k0.z, fmaf(q0.w, k0.w, sl[0][0]))));
    sl[0][1] = fmaf(q0.x, k1.x, fmaf(q0.y, k1.y, fmaf(q0.z, k1.z, fmaf(q0.w, k1.w, sl[0][1]))));
    sl[1][0] = fmaf(q1.x, k0.x, fmaf(q1.y, k0.y, fmaf(q1.z, k0.z, fmaf(q1.w, k0.w, sl[1][0]))));
    sl[1][1] = fmaf(q1.x, k1.x, fmaf(q1.y, k1.y, fmaf(q1.z, k1.z, fmaf(q1.w, k1.w, sl[1][1]))));
  }
#pragma unroll
  for (int d = RL; d < D; d += 4) {
    const float4 q0 = *reinterpret_cast<const float4*>(s.q + ty * KSTR + d);
    const float4 q1 = *reinterpret_cast<const float4*>(s.q + (ty + 16) * KSTR + d);
    const float4 k0 = *reinterpret_cast<const float4*>(s.k + tx * KSTR + d);
    const float4 k1 = *reinterpret_cast<const float4*>(s.k + (tx + 16) * KSTR + d);
    sr[0][0] = fmaf(q0.x, k0.x, fmaf(q0.y, k0.y, fmaf(q0.z, k0.z, fmaf(q0.w, k0.w, sr[0][0]))));
    sr[0][1] = fmaf(q0.x, k1.x, fmaf(q0.y, k1.y, fmaf(q0.z, k1.z, fmaf(q0.w, k1.w, sr[0][1]))));
    sr[1][0] = fmaf(q1.x, k0.x, fmaf(q1.y, k0.y, fmaf(q1.z, k0.z, fmaf(q1.w, k0.w, sr[1][0]))));
    sr[1][1] = fmaf(q1.x, k1.x, fmaf(q1.y, k1.y, fmaf(q1.z, k1.z, fmaf(q1.w, k1.w, sr[1][1]))));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ty + 16 * i;
    float sc[2];
    bool ok[2];
    float mx = NEG_BIG;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int kk = tx + 16 * j;
      ok[j] = kk < nkeys && mask(r, kk);
      // the scales fold after each dot (ones for bf16 latents and self keys)
      sc[j] = ok[j] ? (sl[i][j] * s.ls[kk] + sr[i][j] * s.rs[kk]) * scale : NEG_BIG;
      mx = fmaxf(mx, sc[j]);
    }
    const float m_new = fmaxf(st.m[i], half_max(mx));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int kk = tx + 16 * j;
      const float p = ok[j] ? expf(sc[j] - m_new) : 0.f;
      sum += p;
      s.pT[kk * PSTR + r] = ok[j] ? p * s.ls[kk] : 0.f;  // value-side dequant
    }
    sum = half_sum(sum);
    const float alpha = expf(st.m[i] - m_new);
    st.l[i] = st.l[i] * alpha + sum;
    st.m[i] = m_new;
#pragma unroll
    for (int j = 0; j < 32; ++j) st.acc[i][j] *= alpha;
  }
  __syncthreads();
  for (int kk = 0; kk < nkeys; ++kk) {
    const float p0 = s.pT[kk * PSTR + ty];
    const float p1 = s.pT[kk * PSTR + ty + 16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(s.k + kk * KSTR + 4 * tx + 64 * j);
      st.acc[0][4 * j + 0] = fmaf(p0, v.x, st.acc[0][4 * j + 0]);
      st.acc[0][4 * j + 1] = fmaf(p0, v.y, st.acc[0][4 * j + 1]);
      st.acc[0][4 * j + 2] = fmaf(p0, v.z, st.acc[0][4 * j + 2]);
      st.acc[0][4 * j + 3] = fmaf(p0, v.w, st.acc[0][4 * j + 3]);
      st.acc[1][4 * j + 0] = fmaf(p1, v.x, st.acc[1][4 * j + 0]);
      st.acc[1][4 * j + 1] = fmaf(p1, v.y, st.acc[1][4 * j + 1]);
      st.acc[1][4 * j + 2] = fmaf(p1, v.z, st.acc[1][4 * j + 2]);
      st.acc[1][4 * j + 3] = fmaf(p1, v.w, st.acc[1][4 * j + 3]);
    }
  }
  __syncthreads();
}

// Key tile rows into shared memory as f32: `row(kk, lat, rop, ls, rs)`
// points at key kk's latent and rope rows and gives its scales.
template <class T, class Row>
__device__ void load_keys(const Smem& s, int nkeys, Row row) {
  for (int i = threadIdx.x; i < BK * CH; i += THREADS) {
    const int kk = i / CH;
    const int c = i % CH;
    float f[8];
    if (kk < nkeys) {
      const T* lat;
      const T* rop;
      float ls, rs;
      row(kk, lat, rop, ls, rs);
      load8v(c < RL / 8 ? lat + 8 * c : rop + 8 * (c - RL / 8), f);
      if (c == 0) {
        s.ls[kk] = ls;
        s.rs[kk] = rs;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = 0.f;
      if (c == 0) s.ls[kk] = s.rs[kk] = 0.f;
    }
    float4* dst = reinterpret_cast<float4*>(s.k + kk * KSTR + 8 * c);
    dst[0] = make_float4(f[0], f[1], f[2], f[3]);
    dst[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
  __syncthreads();
}

template <class T, bool PAGED>
__global__ void __launch_bounds__(THREADS)
ragged_prefill_mla_kernel(const bf16* __restrict__ qt, const bf16* __restrict__ qr,
                          const bf16* __restrict__ cs, const bf16* __restrict__ krs, Past<T> c,
                          const int* __restrict__ rowids, const int* __restrict__ offsets,
                          const int* __restrict__ slots, const int* __restrict__ starts,
                          bf16* __restrict__ out, int layer, int T_, int R, int H, float scale) {
  extern __shared__ __align__(16) float sm[];
  const Smem s(sm);
  __shared__ int row_tok[BQ];  // packed token of query row (-1: none)
  __shared__ int row_rid[BQ];  // its descriptor row (R: pad)
  __shared__ int key_rid[BK];  // descriptor row of each self key
  constexpr bool Q8 = sizeof(T) == 1;

  const int TQ = BQ / H;  // tokens a CTA
  const int t0 = blockIdx.x * TQ;
  const int tid = threadIdx.x;
  if (tid < BQ) {
    const int t = t0 + tid / H;
    row_tok[tid] = t < T_ ? t : -1;
    row_rid[tid] = t < T_ ? rowids[t] : -1;
  }
  for (int i = tid; i < BQ * CH; i += THREADS) {
    const int r = i / CH;
    const int ch = i % CH;
    const int t = t0 + r / H;
    const int h = r % H;
    float f[8];
    if (t < T_) {
      load8(ch < RL / 8 ? qt + ((size_t)t * H + h) * RL + 8 * ch
                        : qr + ((size_t)t * H + h) * DR + 8 * (ch - RL / 8), f);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = 0.f;
    }
    float4* dst = reinterpret_cast<float4*>(s.q + r * KSTR + 8 * ch);
    dst[0] = make_float4(f[0], f[1], f[2], f[3]);
    dst[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
  State st;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    st.m[i] = NEG_BIG;
    st.l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) st.acc[i][j] = 0.f;
  }
  __syncthreads();

  const int t_last = min(t0 + TQ, T_) - 1;
  // (a) the cached prefix of every row with tokens in this tile
  for (int r = 0; r < R; ++r) {
    const int lo = offsets[r];
    const int hi = offsets[r + 1];
    const int start = min(starts[r], c.S);
    if (hi <= lo || lo > t_last || hi <= t0 || start <= 0) continue;
    const int srow = slots[r];
    for (int k0 = 0; k0 < start; k0 += BK) {
      const int nkeys = min(BK, start - k0);
      load_keys<T>(s, nkeys, [&](int kk, const T*& lat, const T*& rop, float& ls, float& rs) {
        const int pos = k0 + kk;
        bool pool = false;
        size_t tk;
        if constexpr (PAGED) {
          const KeyHome k = paged_home(c.tbl, c.nbs, c.bt, c.pxb, c.B, r, pos);
          pool = k.pool;
          tk = k.pool ? ((size_t)layer * c.pxb + k.row) * c.bt + k.t
                      : ((size_t)layer * c.B + k.row) * c.S + k.t;
        } else {
          tk = ((size_t)layer * c.B + srow) * c.S + pos;
        }
        lat = (pool ? c.plat : c.lat) + tk * RL;
        rop = (pool ? c.prop : c.rop) + tk * DR;
        if constexpr (Q8) {
          ls = __bfloat162float((pool ? c.pls : c.ls)[tk]);
          rs = __bfloat162float((pool ? c.prs : c.rs)[tk]);
        } else {
          ls = rs = 1.f;
        }
      });
      step_tile(s, st, nkeys, scale, [&](int qrow, int kk) { return row_rid[qrow] == r; });
    }
  }
  // (b) the chunk's own keys: from the first row's start up to the tile's
  // last token, same row and packed index <= the query's
  const int rid0 = t0 < T_ ? rowids[t0] : R;
  const int u_lo = offsets[min(max(rid0, 0), R)];
  for (int u0 = u_lo; u0 <= t_last; u0 += BK) {
    const int nkeys = min(BK, t_last + 1 - u0);
    if (tid < BK) key_rid[tid] = tid < nkeys ? rowids[u0 + tid] : -2;
    load_keys<bf16>(s, nkeys, [&](int kk, const bf16*& lat, const bf16*& rop, float& ls,
                                  float& rs) {
      lat = cs + (size_t)(u0 + kk) * RL;
      rop = krs + (size_t)(u0 + kk) * DR;
      ls = rs = 1.f;
    });
    step_tile(s, st, nkeys, scale, [&](int qrow, int kk) {
      return row_tok[qrow] >= u0 + kk && key_rid[kk] == row_rid[qrow];
    });
  }
  const int ty = tid / 16;
  const int tx = tid % 16;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ty + 16 * i;
    const int t = row_tok[r];
    if (t < 0) continue;
    bf16* o = out + ((size_t)t * H + r % H) * RL;
    const float inv = st.l[i] > 0.f ? 1.f / st.l[i] : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[4 * tx + 64 * j + e] = __float2bfloat16(st.acc[i][4 * j + e] * inv);
  }
}

template <class T, bool PAGED>
int launch(const void* qt, const void* qr, const void* cs, const void* krs, const Past<T>& c,
           const void* rowids, const void* offsets, const void* slots, const void* starts,
           void* out, int layer, int T_, int R, int H, int Rl, int dr, float scale,
           void* stream) {
  if (Rl != RL || dr != DR || H < 1 || BQ % H != 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(ragged_prefill_mla_kernel<T, PAGED>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const int TQ = BQ / H;
  ragged_prefill_mla_kernel<T, PAGED><<<(T_ + TQ - 1) / TQ, THREADS, SMEM_BYTES,
                                        (cudaStream_t)stream>>>(
      (const bf16*)qt, (const bf16*)qr, (const bf16*)cs, (const bf16*)krs, c,
      (const int*)rowids, (const int*)offsets, (const int*)slots, (const int*)starts,
      (bf16*)out, layer, T_, R, H, scale);
  return (int)cudaGetLastError();
}

bool paged_ok(int S, int nbs, int bt, int pxb) {
  return nbs > 0 && bt > 0 && nbs * bt == S && pxb > 0;
}

}  // namespace

extern "C" int ragged_prefill_mla(const void* qt, const void* qr, const void* cs, const void* krs,
                                  const void* lat, const void* rop, const void* rowids,
                                  const void* offsets, const void* slots, const void* starts,
                                  void* out, int layer, int T, int R, int B, int H, int S, int Rl,
                                  int dr, float scale, void* stream) {
  const Past<bf16> c{(const bf16*)lat, nullptr, (const bf16*)rop, nullptr, nullptr, nullptr,
                     nullptr, nullptr, nullptr, B, S, 0, 0, 0};
  return launch<bf16, false>(qt, qr, cs, krs, c, rowids, offsets, slots, starts, out, layer, T, R,
                             H, Rl, dr, scale, stream);
}

extern "C" int ragged_prefill_mla_paged(const void* qt, const void* qr, const void* cs,
                                        const void* krs, const void* lat, const void* rop,
                                        const void* rowids, const void* offsets,
                                        const void* slots, const void* starts, const void* tbl,
                                        const void* plat, const void* prop, void* out, int layer,
                                        int T, int R, int B, int H, int S, int Rl, int dr,
                                        int nbs, int bt, int pxb, float scale, void* stream) {
  if (!paged_ok(S, nbs, bt, pxb)) return (int)cudaErrorInvalidValue;
  const Past<bf16> c{(const bf16*)lat, nullptr, (const bf16*)rop, nullptr, (const int*)tbl,
                     (const bf16*)plat, nullptr, (const bf16*)prop, nullptr, B, S, nbs, bt, pxb};
  return launch<bf16, true>(qt, qr, cs, krs, c, rowids, offsets, slots, starts, out, layer, T, R,
                            H, Rl, dr, scale, stream);
}

extern "C" int ragged_prefill_mla_q8(const void* qt, const void* qr, const void* cs,
                                     const void* krs, const void* lat_q, const void* lat_s,
                                     const void* rop_q, const void* rop_s, const void* rowids,
                                     const void* offsets, const void* slots, const void* starts,
                                     void* out, int layer, int T, int R, int B, int H, int S,
                                     int Rl, int dr, float scale, void* stream) {
  const Past<int8_t> c{(const int8_t*)lat_q, (const bf16*)lat_s, (const int8_t*)rop_q,
                       (const bf16*)rop_s, nullptr, nullptr, nullptr, nullptr, nullptr,
                       B, S, 0, 0, 0};
  return launch<int8_t, false>(qt, qr, cs, krs, c, rowids, offsets, slots, starts, out, layer, T,
                               R, H, Rl, dr, scale, stream);
}

extern "C" int ragged_prefill_mla_q8_paged(
    const void* qt, const void* qr, const void* cs, const void* krs, const void* lat_q,
    const void* lat_s, const void* rop_q, const void* rop_s, const void* rowids,
    const void* offsets, const void* slots, const void* starts, const void* tbl,
    const void* plat_q, const void* plat_s, const void* prop_q, const void* prop_s, void* out,
    int layer, int T, int R, int B, int H, int S, int Rl, int dr, int nbs, int bt, int pxb,
    float scale, void* stream) {
  if (!paged_ok(S, nbs, bt, pxb)) return (int)cudaErrorInvalidValue;
  const Past<int8_t> c{(const int8_t*)lat_q, (const bf16*)lat_s, (const int8_t*)rop_q,
                       (const bf16*)rop_s, (const int*)tbl, (const int8_t*)plat_q,
                       (const bf16*)plat_s, (const int8_t*)prop_q, (const bf16*)prop_s,
                       B, S, nbs, bt, pxb};
  return launch<int8_t, true>(qt, qr, cs, krs, c, rowids, offsets, slots, starts, out, layer, T,
                              R, H, Rl, dr, scale, stream);
}
