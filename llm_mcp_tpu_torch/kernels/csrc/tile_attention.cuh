// One 64-query-row tile of flash attention, shared by the prefill kernels.
//
// A CTA of 256 threads owns 64 query rows. Thread (ty, tx) = (tid / 16,
// tid % 16) owns rows ty + 16i (i < 4) for scores and output, score columns
// tx + 16j (j < 4) and output dims tx + 16j (j < 8). Each step brings one
// tile of up to 64 keys into shared memory (16-byte coalesced loads),
// forms the 64x64 score block with FMA register tiles, folds it into the
// per-row online softmax (f32, reductions over the 16 lanes of a
// half-warp), and accumulates P.V. Scores and the output stay on chip.
//
// Shared memory (floats): Q^T [HD][65] (pre-scaled), K^T [HD][65],
// V [64][HD], P^T [64][65], and the key tile's int8 dequant scales
// kss/vss [64] (`step_q8`). The padded strides keep the column reads
// conflict-free.

#pragma once

#include "common.cuh"

namespace tile {

constexpr int HD = 128;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int PAD = 65;
constexpr int THREADS = 256;
constexpr size_t SMEM_FLOATS = HD * PAD + HD * PAD + BK * HD + BK * PAD + 2 * BK;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);

struct Smem {
  float* qT;
  float* kT;
  float* v;
  float* pT;
  float* kss;
  float* vss;
  __device__ explicit Smem(float* base)
      : qT(base), kT(base + HD * PAD), v(base + 2 * HD * PAD), pT(base + 2 * HD * PAD + BK * HD),
        kss(base + 2 * HD * PAD + BK * HD + BK * PAD), vss(kss + BK) {}
};

struct State {
  float acc[4][8];
  float m[4];
  float l[4];
  __device__ void init() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = NEG_BIG;
      l[i] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
  }
};

// Stage query row r (r < BQ) from `src` (HD contiguous bf16, or nullptr for
// a row past the end) into Q^T, multiplied by `scale`. Called by all
// threads over all rows; the caller syncs before the first step.
__device__ __forceinline__ void load_q_chunk(const Smem& s, int r, int d0, const bf16* src,
                                             float scale) {
  float f[8];
  if (src != nullptr) {
    load8(src + d0, f);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = 0.f;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) s.qT[(d0 + e) * PAD + r] = f[e] * scale;
}

// The tile's scores, online softmax and P.V once K^T and V are in shared
// memory. SCALED: an int8 tile whose scores take kss[kk] after the dot and
// whose probabilities take vss[kk] before P.V (the row sum l keeps the bare
// probabilities), as `_ragged_prefill_q8_kernel` dequantizes.
template <bool SCALED, class Mask>
__device__ void step_tile(const Smem& s, State& st, int nkeys, float softcap, Mask mask);

// One key tile. `kv_row(kk, kp, vp)` points kp/vp at key kk's K and V rows
// (kk < nkeys); `mask(r, kk)` says whether row r may attend key kk.
template <class KvRow, class Mask>
__device__ void step(const Smem& s, State& st, int nkeys, float softcap, KvRow kv_row,
                     Mask mask) {
  const int tid = threadIdx.x;
  for (int c = tid; c < BK * (HD / 8); c += THREADS) {
    const int kk = c / (HD / 8);
    const int d0 = (c % (HD / 8)) * 8;
    float kf[8], vf[8];
    if (kk < nkeys) {
      const bf16* kp;
      const bf16* vp;
      kv_row(kk, kp, vp);
      load8(kp + d0, kf);
      load8(vp + d0, vf);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) kf[e] = vf[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s.kT[(d0 + e) * PAD + kk] = kf[e];
      s.v[kk * HD + d0 + e] = vf[e];
    }
  }
  __syncthreads();
  step_tile<false>(s, st, nkeys, softcap, mask);
}

// One int8 key tile. `kv_row(kk, kp, vp, ks, vs)` points kp/vp at key kk's
// int8 K and V rows and gives its scales; the values convert on load.
template <class KvRowQ8, class Mask>
__device__ void step_q8(const Smem& s, State& st, int nkeys, KvRowQ8 kv_row, Mask mask) {
  const int tid = threadIdx.x;
  for (int c = tid; c < BK * (HD / 8); c += THREADS) {
    const int kk = c / (HD / 8);
    const int d0 = (c % (HD / 8)) * 8;
    float kf[8], vf[8];
    if (kk < nkeys) {
      const int8_t* kp;
      const int8_t* vp;
      float ks, vs;
      kv_row(kk, kp, vp, ks, vs);
      const uint2 kr = *reinterpret_cast<const uint2*>(kp + d0);
      const uint2 vr = *reinterpret_cast<const uint2*>(vp + d0);
      const int8_t* kb = reinterpret_cast<const int8_t*>(&kr);
      const int8_t* vb = reinterpret_cast<const int8_t*>(&vr);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        kf[e] = (float)kb[e];
        vf[e] = (float)vb[e];
      }
      if (d0 == 0) {
        s.kss[kk] = ks;
        s.vss[kk] = vs;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) kf[e] = vf[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s.kT[(d0 + e) * PAD + kk] = kf[e];
      s.v[kk * HD + d0 + e] = vf[e];
    }
  }
  __syncthreads();
  step_tile<true>(s, st, nkeys, 0.f, mask);
}

template <bool SCALED, class Mask>
__device__ void step_tile(const Smem& s, State& st, int nkeys, float softcap, Mask mask) {
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  float sc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float qv[4], kv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = s.qT[d * PAD + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) kv[j] = s.kT[d * PAD + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    bool ok[4];
    float mx = NEG_BIG;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = tx + 16 * j;
      float v = sc[i][j];
      if constexpr (SCALED) v *= s.kss[kk];
      if (softcap > 0.f) v = tanhf(v / softcap) * softcap;
      ok[j] = (kk < nkeys) && mask(r, kk);
      sc[i][j] = ok[j] ? v : NEG_BIG;
      mx = fmaxf(mx, sc[i][j]);
    }
    const float m_new = fmaxf(st.m[i], half_max(mx));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = ok[j] ? __expf(sc[i][j] - m_new) : 0.f;
      sum += p;
      if constexpr (SCALED) {
        // a masked key's scale may be stale shared memory: keep its 0 a 0
        s.pT[(tx + 16 * j) * PAD + r] = ok[j] ? p * s.vss[tx + 16 * j] : 0.f;
      } else {
        s.pT[(tx + 16 * j) * PAD + r] = p;
      }
    }
    sum = half_sum(sum);
    const float alpha = __expf(st.m[i] - m_new);
    st.l[i] = st.l[i] * alpha + sum;
    st.m[i] = m_new;
#pragma unroll
    for (int j = 0; j < 8; ++j) st.acc[i][j] *= alpha;
  }
  __syncthreads();

  for (int kk = 0; kk < nkeys; ++kk) {
    float pv[4], vv[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = s.pT[kk * PAD + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 8; ++j) vv[j] = s.v[kk * HD + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) st.acc[i][j] = fmaf(pv[i], vv[j], st.acc[i][j]);
  }
  __syncthreads();
}

// Write row r = ty + 16i of the normalized output to dst(r) (HD contiguous
// bf16, nullptr = row not stored). Rows that attended nothing emit 0.
template <class Dst>
__device__ void store(const State& st, Dst dst) {
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    bf16* out = dst(ty + 16 * i);
    if (out == nullptr) continue;
    const float inv = st.l[i] > 0.f ? 1.f / st.l[i] : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) out[tx + 16 * j] = __float2bfloat16(st.acc[i][j] * inv);
  }
}

}  // namespace tile
