// One 64-query-row tile of flash attention on Hopper's tensor cores, shared
// by the prefill kernels (flash_prefill.cu, ragged_prefill.cu).
//
// A CTA is one warpgroup (128 threads) that owns 64 query rows. Both
// products run on `wgmma.mma_async` (sm_90a), bf16 in and f32 out:
//   S = Q.K^T   m64n64k16 x 8 (head_dim 128), Q and the key tile read from
//               shared memory;
//   O += P.V    m64n128k16 x 4 (64 keys), P in registers as the A operand,
//               the value tile read from shared memory.
// The scores, the online softmax (m, l) and O (64 x 128 f32) stay in
// registers. Thread (warp w, lane) holds rows 16w + lane/4 and that + 8,
// and columns 8j + 2(lane%4) + {0, 1} of each 8-column block: the same
// layout for the S accumulator and the P operand, so P needs no shuffle.
// Row maxima and sums reduce over the four lanes that share a row.
//
// q enters the product as the bf16 it is; `scale` (and, for an int8 key
// tile, the key's scale) multiplies the f32 scores after it, then the
// softcap and the masks apply. P.V takes p as two bf16 terms, hi = bf16(p)
// and lo = bf16(p - hi), each multiplied by V (8 products a tile, not 4):
// p then carries about 16 bits, and the output keeps the f32 version's
// accuracy. p rounded once (2^-9 relative) missed |err| <= 1e-3 +
// 1e-2*|ref| on rows that attend a few keys and whose output cancels. l
// sums the f32 probabilities.
//
// Tiles live in shared memory as bf16 [64 rows][128] in the 128-byte
// swizzled layout `wgmma` reads (two 64-column halves of 8 KB; row r's
// 16-byte chunk c of a half at r*128 + ((c ^ r%8) * 16)). Q, K, and V use
// the same layout: K and Q are K-major operands, V the MN-major B operand
// (transposed in the descriptor). Key tiles fill a ring of two stages with
// `cp.async` (16 bytes a copy, rows past the tile's keys zero-filled), so
// the copy of tile i+1 is in flight while tile i is multiplied. Before the
// copies, 64 threads resolve each key's K and V rows once (and, for an int8
// tile, its two scales) into a per-stage table: that is where a paged arm
// follows its block table.
//
// An int8 key tile (`Q8`) is copied as int8 into a staging ring (two
// stages of 16 KB, in the second bf16 stage's space) and widened to bf16
// into the first bf16 stage before its products: every int8 value is exact
// in bf16. Its scores take the key's K scale after Q.K^T; its
// probabilities take the key's V scale before P.V; l keeps the bare
// probabilities, as `_ragged_prefill_q8_kernel` dequantizes.
//
// Shared memory: Q 16 KB + two stages of K and V 64 KB + the key tables,
// about 85 KB a CTA, so two CTAs share an SM.
//
// head_dim 64 (Llama-3.2-1B, Qwen2.5-0.5B; a source defines TILE_HD 64):
// the CTA is one warpgroup with a single 64-column block, so a bf16 row is
// 128 bytes, exactly one swizzle atom. S = Q.K^T takes 4 k-steps of
// m64n64k16, O += P.V is m64n64k16 (32 O values a thread, not 64), and the
// descriptors are the 128 tile's first block (V's leading byte offset, the
// step between 64-column blocks, is then never taken). An int8 row is 64
// bytes: four 16-byte copies into the staging ring, widened into eight bf16
// chunks. Q 8 KB + two stages of K and V 32 KB + the key tables take about
// 45 KB a CTA, so shared memory would let five CTAs share an SM; the
// registers (ptxas's report in chip_smoke.py) set how many do.
//
// head_dim 256 (Gemma-2) has a kernel of its own, flash_prefill_hd256.cu.

#pragma once

#include "common.cuh"

#ifndef TILE_HD
#define TILE_HD 128
#endif

namespace tile {

constexpr int HD = TILE_HD;
static_assert(HD == 64 || HD == 128, "the tile is built for head_dim 64 or 128");
constexpr int OREG = HD / 2;  // O values a thread holds
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 128;  // one warpgroup
constexpr int CH = HD / 8;  // 16-byte chunks a bf16 row
constexpr int TILE_BYTES = BQ * HD * 2;  // one bf16 [64][HD] tile
constexpr int HALF_BYTES = BQ * 128;     // one 64-column block of a tile (8 KB)
constexpr int Q8_TILE_BYTES = BK * HD;   // one int8 [64][HD] tile
constexpr int Q8CH = HD / 16;            // 16-byte chunks an int8 row
constexpr int Q8SH = HD == 64 ? 2 : 3;   // log2(Q8CH) at the int8 widths
// byte offsets from the 1024-aligned base
constexpr int Q_OFF = 0;
constexpr int KV_OFF = TILE_BYTES;          // stage s: K at + 2s tiles, V at + (2s+1)
constexpr int Q8_OFF = KV_OFF + 2 * TILE_BYTES;  // int8 staging: bf16 stage 1's space
constexpr int TABLE_OFF = KV_OFF + 4 * TILE_BYTES;
constexpr int TABLE_BYTES = 2 * BK * (8 + 8 + 4 + 4 + 4);  // kp, vp, kss, vss, tag
constexpr size_t SMEM_BYTES = TABLE_OFF + TABLE_BYTES + 1024;  // + alignment slack

// Where a key of a tile comes from: its K and V rows (HD values, bf16 or
// int8), its int8 scales, and a tag the mask may read (the ragged kernels'
// descriptor row).
struct Key {
  const void* k;
  const void* v;
  float ks;
  float vs;
  int tag;
};

struct Smem {
  unsigned char* base;
  const void* any;  // a valid global address: the source of zero-filled copies
  __device__ Smem(unsigned char* raw, const void* global_any)
      : base(reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                              ~uintptr_t(1023))),
        any(global_any) {}
  __device__ unsigned char* q() const { return base + Q_OFF; }
  __device__ unsigned char* k(int s) const { return base + KV_OFF + 2 * s * TILE_BYTES; }
  __device__ unsigned char* v(int s) const { return base + KV_OFF + (2 * s + 1) * TILE_BYTES; }
  __device__ int8_t* k8(int s) const {
    return reinterpret_cast<int8_t*>(base + Q8_OFF + 2 * s * Q8_TILE_BYTES);
  }
  __device__ int8_t* v8(int s) const {
    return reinterpret_cast<int8_t*>(base + Q8_OFF + (2 * s + 1) * Q8_TILE_BYTES);
  }
  __device__ const void** kp(int s) const {
    return reinterpret_cast<const void**>(base + TABLE_OFF) + s * BK;
  }
  __device__ const void** vp(int s) const {
    return reinterpret_cast<const void**>(base + TABLE_OFF) + (2 + s) * BK;
  }
  __device__ float* kss(int s) const {
    return reinterpret_cast<float*>(base + TABLE_OFF + 4 * BK * 8) + s * BK;
  }
  __device__ float* vss(int s) const {
    return reinterpret_cast<float*>(base + TABLE_OFF + 4 * BK * 8) + (2 + s) * BK;
  }
  __device__ int* tag(int s) const {
    return reinterpret_cast<int*>(base + TABLE_OFF + 4 * BK * 8) + (4 + s) * BK;
  }
};

struct State {
  float o[OREG];  // O rows (r0, r0 + 8), columns 8j + 2t + {0, 1}: o[4j + 2i + c]
  float m[2];
  float l[2];
  __device__ void init() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = NEG_BIG;
      l[i] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < OREG; ++j) o[j] = 0.f;
  }
};

// -- shared memory, copies and fences -----------------------------------------

// Byte offset of 16-byte chunk c (0..CH-1) of row r in a swizzled tile.
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 3) * HALF_BYTES + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// make this thread's shared-memory writes visible to wgmma (async proxy)
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- wgmma --------------------------------------------------------------------

// Descriptor of a 128-byte-swizzled operand at `p` (1024-aligned atoms):
// lbo/sbo in bytes.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = smem_u32(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)1 << 62);
}

// K-major operand (Q or K): k-step kk covers columns 16kk..16kk+15; 8-row
// groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_kmajor(const unsigned char* t, int kk) {
  return desc(t + (kk >> 2) * HALF_BYTES + (kk & 3) * 32, 16, 1024);
}

// MN-major B operand (V [keys][hd]): k-step kk covers keys 16kk..16kk+15
// of all HD columns; the 64-column blocks HALF_BYTES apart (at head_dim 64
// the one block: the leading byte offset is never taken), 8-key groups
// 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_mnmajor(const unsigned char* t, int kk) {
  if constexpr (HD == 64) return desc(t + kk * 16 * 128, HALF_BYTES, 1024);  // the one block
  return desc(t + kk * 16 * 128, HALF_BYTES, 1024);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void mma_qk(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void mma_pv(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// P.V of the head_dim-64 tile: one 64-column block, m64n64k16
__device__ __forceinline__ void mma_pv(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// -- loads ----------------------------------------------------------------------

// Stage the 64 query rows: `row(r)` points at row r's HD bf16 values, or is
// nullptr for a row past the end (zero-filled), as one copy group; the
// first tile's wait covers it.
template <class Row>
__device__ __forceinline__ void load_q(const Smem& s, Row row) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < BQ * CH / THREADS; ++i) {
    const int c = i * THREADS + tid;
    const int r = c / CH;
    const int ch = c % CH;
    const bf16* p = row(r);
    cp16(s.q() + swz(r, ch), p != nullptr ? p + ch * 8 : nullptr, s.any);
  }
  cp_commit();
}

// Keys of tile i of a segment of n keys (a prefix of its 64).
__device__ __forceinline__ int tile_keys(int n, int i) { return min(BK, n - i * BK); }

// Resolve the keys of tile i into stage i & 1's table (64 threads, one key
// each; keys past the tile's count get nullptr rows and zero scales).
template <class Prep>
__device__ __forceinline__ void resolve(const Smem& s, int i, int n, Prep prep) {
  const int kk = threadIdx.x;
  if (kk >= BK) return;
  const Key key = kk < tile_keys(n, i) ? prep(i, kk) : Key{nullptr, nullptr, 0.f, 0.f, -2};
  const int st = i & 1;
  s.kp(st)[kk] = key.k;
  s.vp(st)[kk] = key.v;
  s.kss(st)[kk] = key.ks;
  s.vss(st)[kk] = key.vs;
  s.tag(st)[kk] = key.tag;
}

// Issue the copies of the tile whose table is in stage st: bf16 rows into
// bf16 stage st, or int8 rows into int8 staging st.
template <bool Q8>
__device__ __forceinline__ void issue(const Smem& s, int st) {
  const int tid = threadIdx.x;
  const void* const* kp = s.kp(st);
  const void* const* vp = s.vp(st);
  if constexpr (Q8) {
#pragma unroll
    for (int i = 0; i < BK * Q8CH / THREADS; ++i) {
      const int c = i * THREADS + tid;
      const int r = c >> Q8SH;
      const int ch = c & (Q8CH - 1);
      const int8_t* k = static_cast<const int8_t*>(kp[r]);
      const int8_t* v = static_cast<const int8_t*>(vp[r]);
      cp16(s.k8(st) + r * HD + ch * 16, k != nullptr ? k + ch * 16 : nullptr, s.any);
      cp16(s.v8(st) + r * HD + ch * 16, v != nullptr ? v + ch * 16 : nullptr, s.any);
    }
  } else {
#pragma unroll
    for (int i = 0; i < BK * CH / THREADS; ++i) {
      const int c = i * THREADS + tid;
      const int r = c / CH;
      const int ch = c % CH;
      const bf16* k = static_cast<const bf16*>(kp[r]);
      const bf16* v = static_cast<const bf16*>(vp[r]);
      cp16(s.k(st) + swz(r, ch), k != nullptr ? k + ch * 8 : nullptr, s.any);
      cp16(s.v(st) + swz(r, ch), v != nullptr ? v + ch * 8 : nullptr, s.any);
    }
  }
}

// int8 staging st -> bf16 stage 0, swizzled (16 int8 a job, two 16-byte
// bf16 chunks out).
__device__ __forceinline__ void widen(const Smem& s, int st) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 2 * BK * Q8CH / THREADS; ++i) {
    const int c = i * THREADS + tid;
    const bool is_v = c >= BK * Q8CH;
    const int cc = is_v ? c - BK * Q8CH : c;
    const int r = cc >> Q8SH;
    const int ch = cc & (Q8CH - 1);
    const int8_t* src = (is_v ? s.v8(st) : s.k8(st)) + r * HD + ch * 16;
    unsigned char* dst = is_v ? s.v(0) : s.k(0);
    const int4 raw = *reinterpret_cast<const int4*>(src);
    const int words[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t w[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int x = words[e >> 1] >> (16 * (e & 1));
      __nv_bfloat162 h = __floats2bfloat162_rn((float)(int8_t)(x & 0xff), (float)(int8_t)(x >> 8));
      w[e] = *reinterpret_cast<uint32_t*>(&h);
    }
    *reinterpret_cast<int4*>(dst + swz(r, 2 * ch)) = make_int4(w[0], w[1], w[2], w[3]);
    *reinterpret_cast<int4*>(dst + swz(r, 2 * ch + 1)) = make_int4(w[4], w[5], w[6], w[7]);
  }
}

// -- one key tile ---------------------------------------------------------------

// Scores, online softmax and P.V of one key tile whose K and V sit in bf16
// stage `kv` and whose table sits in stage `st`. mask(ti, r, kk, tag) says
// whether query row r may attend key kk (kk < nkeys) of tile ti.
template <bool Q8, class Mask>
__device__ __forceinline__ void step(const Smem& s, State& S_, int ti, int kv, int st,
                                     int nkeys, float scale, float softcap, Mask mask) {
  const int lane = threadIdx.x & 31;
  const int r0 = ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  float sc[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) sc[j] = 0.f;
  hold(sc);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    mma_qk(sc, desc_kmajor(s.q(), kk), desc_kmajor(s.k(kv), kk), kk);
  wg_commit();
  wg_wait();
  hold(sc);

  const float* kss = s.kss(st);
  const float* vss = s.vss(st);
  const int* tag = s.tag(st);
  uint32_t ok = 0;
  float mx[2] = {NEG_BIG, NEG_BIG};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int kk = 8 * j + c0 + c;
      const bool live = kk < nkeys;
      const int tg = tag[kk];
      float ksc = scale;
      if constexpr (Q8) ksc *= kss[kk];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = 4 * j + 2 * i + c;
        float v = sc[e] * ksc;
        if (softcap > 0.f) v = tanhf(v / softcap) * softcap;
        const bool a = live && mask(ti, r0 + 8 * i, kk, tg);
        ok |= (uint32_t)a << e;
        sc[e] = a ? v : NEG_BIG;
        mx[i] = fmaxf(mx[i], sc[e]);
      }
    }
  }
  float alpha[2], m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    m_new[i] = fmaxf(S_.m[i], mx[i]);
    alpha[i] = __expf(S_.m[i] - m_new[i]);
  }
  // probabilities, packed to bf16 pairs in the A layout of P.V: k-step kk2
  // takes sc[8kk2 .. 8kk2 + 7] as registers {0,1}, {2,3}, {4,5}, {6,7};
  // pa the high bf16 terms, pb the remainders
  uint32_t pa[4][4], pb[4][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float pv[4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 4 * j + 2 * i + c;
        const bool a = (ok >> e) & 1u;
        const float p = a ? __expf(sc[e] - m_new[i]) : 0.f;
        sum[i] += p;
        float pp = p;
        // a masked key's scale may be stale: its 0 stays 0
        if constexpr (Q8) pp = a ? p * vss[8 * j + c0 + c] : 0.f;
        pv[2 * i + c] = pp;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      __nv_bfloat162 hi = __floats2bfloat162_rn(pv[2 * i], pv[2 * i + 1]);
      const float2 back = __bfloat1622float2(hi);
      __nv_bfloat162 lo = __floats2bfloat162_rn(pv[2 * i] - back.x, pv[2 * i + 1] - back.y);
      pa[j >> 1][(j & 1) * 2 + i] = *reinterpret_cast<uint32_t*>(&hi);
      pb[j >> 1][(j & 1) * 2 + i] = *reinterpret_cast<uint32_t*>(&lo);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
    S_.l[i] = S_.l[i] * alpha[i] + sum[i];
    S_.m[i] = m_new[i];
  }
#pragma unroll
  for (int j = 0; j < OREG / 4; ++j) {
    S_.o[4 * j + 0] *= alpha[0];
    S_.o[4 * j + 1] *= alpha[0];
    S_.o[4 * j + 2] *= alpha[1];
    S_.o[4 * j + 3] *= alpha[1];
  }
  hold(S_.o);
  wg_fence();
#pragma unroll
  for (int kk2 = 0; kk2 < BK / 16; ++kk2) {
    mma_pv(S_.o, pa[kk2], desc_mnmajor(s.v(kv), kk2));
    mma_pv(S_.o, pb[kk2], desc_mnmajor(s.v(kv), kk2));
  }
  wg_commit();
  wg_wait();
  hold(S_.o);
}

// The first `ntiles` 64-key tiles of a segment of n keys: prep(i, kk)
// resolves key kk of tile i, mask(i, r, kk, tag) masks. All 128 threads
// call it; the ring is empty and the tables free on entry and exit.
template <bool Q8, class Prep, class Mask>
__device__ void run(const Smem& s, State& S_, int ntiles, int n, Prep prep, Mask mask,
                    float scale, float softcap) {
  if (ntiles <= 0) return;
  resolve(s, 0, n, prep);
  if (ntiles > 1) resolve(s, 1, n, prep);
  __syncthreads();
  issue<Q8>(s, 0);
  cp_commit();
  for (int i = 0; i < ntiles; ++i) {
    const int st = i & 1;
    if (i + 1 < ntiles) issue<Q8>(s, st ^ 1);
    cp_commit();
    cp_wait<1>();  // tile i (and the queries) landed
    if constexpr (Q8) {
      __syncthreads();
      widen(s, st);
    }
    fence_async();
    __syncthreads();
    step<Q8>(s, S_, i, Q8 ? 0 : st, st, tile_keys(n, i), scale, softcap, mask);
    __syncthreads();  // stage st and its table are free again
    if (i + 2 < ntiles) resolve(s, i + 2, n, prep);
    __syncthreads();
  }
}

// Write rows r0 and r0 + 8 of the normalized output: dst(r) points at row
// r's HD bf16 values (nullptr: not stored).
// Rows that attended nothing emit 0.
template <class Dst>
__device__ void store(const State& S_, Dst dst) {
  cp_wait<0>();
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    bf16* out = dst(r0 + 8 * i);
    if (out == nullptr) continue;
    const float inv = S_.l[i] > 0.f ? 1.f / S_.l[i] : 0.f;
#pragma unroll
    for (int j = 0; j < OREG / 4; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + c0) =
          __floats2bfloat162_rn(S_.o[4 * j + 2 * i] * inv, S_.o[4 * j + 2 * i + 1] * inv);
  }
}

}  // namespace tile
