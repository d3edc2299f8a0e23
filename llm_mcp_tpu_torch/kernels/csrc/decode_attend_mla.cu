// decode_attend_q8_mla / decode_attend_q8_mla_paged: absorbed MLA decode
// attention over the int8 latent cache, PRE-append.
//
// Replaces: llm_mcp_tpu/kernels/attention.py `_attend_q8_mla_kernel`
// (whole-S arm), `_attend_q8_mla_blocked_kernel` (blocked arm) and
// `_attend_q8_mla_paged_kernel` (paged arm), all behind
// `decode_attend_q8_mla`. Their arithmetic is kept, per batch row b and
// head h: q̃ is requantized per head (qsc = max(max|q̃| / 127, 1e-30));
// latent scores are s8 x s8 -> s32 dots, times scale * qsc * ls; rope
// scores are dots over the rope keys times rs * scale; position w takes
// the exact score of this step's latent and rope key; after the softmax,
// p * ls (0 at w) is requantized to int8 per group of keys with its own
// psc = max(max / 127, 1e-30), and the context is
// sum_g psc_g * (p8 . lat)_g + p_w * c_new, over l. The group is an
// argument: the whole row (JAX's whole-S arm: S = 4096 at
// DeepSeek-V2-Lite), the block size (blocked arm: 512 at S = 16384), bt
// (paged arm), or 0 for JAX's exact fallback, which does not requantize.
//
// Bound on the H100: bytes, 580 a key (512 + 64 int8 and two bf16 scales)
// of the attended prefix, read from HBM once a call. The JAX bodies are
// MQA-shaped: every head of a row attends the one latent row. So a CTA
// takes all heads of a row (16 at V2-Lite, the M of `mma.sync`; wider
// models take a CTA per 16 heads) and CH = 128 consecutive keys of it:
// grid (splits, rows, head groups), each byte of a key read by one CTA.
// The 8 rows of a V2-Lite step (fills 511..4095) make about 124 CTAs, one
// wave on 132 SMs. CTAs past a row's fill exit at once; nothing is read
// on the host. Three launches a call:
//
//  1. mla_score_kernel: each warp copies its 16 keys' latent and rope
//     rows into shared memory (`cp.async`, 16 bytes a lane, a latent row
//     a warp instruction; paged: the table is resolved once a block, by
//     paged.cuh) and multiplies them on the tensor cores: latent scores
//     as `mma.sync.m16n8k32.s32.s8.s8.s32` (A = q̃8 [16 x 512], B = the
//     tile as stored, key-major, which is the `.col` layout s8 takes;
//     integer sums, so JAX's s32 dot_general bit for bit), rope scores as
//     `m16n8k16` bf16 with f32 sums (an int8 rope key is exact in bf16;
//     the dot is scaled by rs after, as the exact arm scales its dots).
//     The exact arm (group 0) runs its latent dot the same way, q̃ in
//     bf16, f32 sums. It writes every score to the f32 workspace sc
//     [Ba, H, SP] and, per split and head, (m, l, a): the max score, the
//     sum of exp(s - m) and the max of exp(s - m) * ls off position w.
//  2. mla_pv_kernel: reads its row's (m, l, a), takes the row max M and,
//     for a group that spans splits (the whole row, 512; any group past
//     CH), the group's max of p * ls, max_z e^(m_z - M) a_z, before any
//     p8 is formed; a group inside the split (bt = 32, 64, 128) takes its
//     max from its own keys. p8 = rint(p * ls / psc) with p = e^(s - M)
//     (p8 does not depend on the reference max, so these are JAX's p8 up
//     to f32 rounding). PV = p8 [16 x keys] . lat [keys x 512] on
//     `m16n8k32` s8: s8 `mma.sync` takes B only K-major, so the latent
//     tile, stored N-major, is transposed in registers: a lane loads four
//     keys' 4-byte words of one column quad and permutes the 4 x 4 bytes
//     (`prmt`); the tile's 16-byte chunks are XOR-swizzled so those loads
//     are conflict-free. The int32 sums are flushed into f32 times psc at
//     every group boundary inside the split, else once at its end: the
//     partials are combined in f32 after each group's psc has been
//     applied, all relative to M, written to part [Ba, nsplit, H, 512].
//     The exact arm keeps p * ls in f32 and runs its PV as FMA over the
//     same shared tile (a thread two columns, all 16 heads).
//  3. mla_combine_kernel: a CTA per (row, head) sums the row's partials
//     in split order (deterministic: two calls agree bit for bit), adds
//     p_w * c_new and divides by l = sum_z e^(m_z - M) l_z.
//
// Passes 2 and 3 are launched to start while their predecessor runs
// (programmatic dependent launch): the PV pass copies its tile before it
// waits for the scores, so the fixed latency of three launches, which
// sets the time at V2-Lite's shapes more than the bytes do, overlaps.
//
// A row parked at w >= S (or w < 0) attends its new vectors alone: one
// split, no cache read, output c_new. Keys past the fill and position w
// copy zeros (p8 = 0, pv = 0 there).
//
// Registers per instantiation (nvcc -Xptxas -v, sm_90a; `chip_smoke.py`
// logs them at every build), <PAGED, REQUANT>, no spill anywhere:
// score 72 / 73 (contiguous int8 / exact), 68 / 71 (paged); PV 101 / 79,
// 101 / 78; combine 40. Shared memory (dynamic, sizeof): score 100,048
// bytes (two CTAs an SM), PV 75,536 (three); combine 32 bytes static.
//
// Layouts: qt [Ba, H, R], qr [Ba, H, dr], c_new [Ba, R], r_new [Ba, dr]
// bf16; latents {q int8 [L, B, 1, S, R], s bf16 [L, B, 1, S]}, rope keys
// {q [L, B, 1, S, dr], s}; pools the same with [L, pxb, 1, bt, ...];
// lengths/rows [Ba] int32; tables [B, nbs] int32; out [Ba, H, R] bf16;
// ws f32: part [Ba, nsplit, H, R], sc [Ba, H, SP], st [Ba, nsplit, 3, H]
// with nsplit = ceil(S / CH), SP = nsplit * CH. R = 512, dr = 64. `x /
// 127` is a multiplication by the float32 reciprocal, as XLA compiles the
// Pallas bodies' division by the constant.

#include "paged.cuh"

namespace {

constexpr int R = 512;   // kv_lora_rank
constexpr int DR = 64;   // qk_rope_head_dim
constexpr int HG = 16;   // heads a CTA: the M of mma.sync
constexpr int CH = 128;  // keys a CTA (the split)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int WKEYS = CH / WARPS;  // keys a warp in the score pass
constexpr int STAGES = CH / 32;    // 32-key copy stages of the PV pass
constexpr int COMBINE_THREADS = R / 4;
constexpr float INV127 = 1.0f / 127.0f;

// row strides (bytes) of the score pass's tiles, padded so that the
// fragments' 32-bit loads of 8 rows fall in distinct banks
constexpr int LSTR = R + 16;        // int8 latent row
constexpr int RSTR = DR + 16;       // int8 rope row
constexpr int Q8STR = R + 16;       // int8 q̃ row
constexpr int QBSTR = 2 * R + 16;   // bf16 q̃ row (exact arm)
constexpr int QRSTR = 2 * DR + 16;  // bf16 rope-query row
constexpr int P8STR = CH + 16;      // int8 p8 row (PV pass)

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

struct Args {
  const bf16* qt;
  const bf16* qr;
  const bf16* cnew;
  const bf16* rnew;
  LatentCache c;
  const int* lengths;
  const int* rows;
  bf16* out;
  float* sc;    // [Ba, H, SP] scores
  float* st;    // [Ba, nsplit, 3, H]: m, l, a
  float* part;  // [Ba, nsplit, H, R]
  int layer, H, group, nsplit, SP;
  float scale;
};

struct __align__(16) ScoreSmem {
  unsigned char lat[CH * LSTR];
  unsigned char rop[CH * RSTR];
  unsigned char q[HG * QBSTR];  // q̃8 rows at Q8STR, or bf16 q̃ rows at QBSTR
  unsigned char qr[HG * QRSTR];
  float ls[CH], rs[CH];
  unsigned long long home[CH + 1];
  float red[WARPS][HG], red2[WARPS][HG];
  float qsc[HG], snew[HG], m[HG];
};

struct __align__(16) PvSmem {
  unsigned char lat[CH * R];  // 16-byte chunks XOR-swizzled (swz)
  union {
    int8_t p8[HG * P8STR];  // requantizing arms: [head][key]
    float pf[CH * HG];      // exact arm: p * ls [key][head]
  } a;
  float ls[CH];
  unsigned long long home[CH + 1];
  float psc[HG][CH / 32];
};

// The row's split: its keys k0 .. k0 + n - 1 (n <= 0: past the fill) and
// position w among them (wl, outside [0, n) when elsewhere).
struct Split {
  int we, k0, n, wl;
};

__device__ __forceinline__ Split row_split(const Args& a, int b, int z) {
  const int w = a.lengths[b];
  const int we = (w < 0 || w >= a.c.S) ? 0 : w;  // a parked row attends its new vectors alone
  const int k0 = z * CH;
  return {we, k0, min(we + 1 - k0, CH), we - k0};
}

// A group inside one split whose keys fill whole mma k-steps (its max
// taken from the split's own keys), as opposed to one that spans splits or
// is the whole of a short row (its max from every split's a).
__device__ __forceinline__ bool local_group(int group) {
  return group >= 32 && group <= CH && CH % group == 0;
}

// One entry a table block of the keys [k0, k0 + n): the token index of the
// block's first key in its plane's [L, rows, 1, tokens] layout, bit 63 set
// for a pool row. The table is read once a block.
template <bool PAGED>
__device__ __forceinline__ void resolve_homes(const LatentCache& c, int layer, int row, int k0,
                                              int n, unsigned long long* home) {
  if constexpr (PAGED) {
    const int j0 = k0 / c.bt;
    const int nb = (k0 + n - 1) / c.bt - j0 + 1;
    for (int i = threadIdx.x; i < nb; i += blockDim.x) {
      const KeyHome k = paged_home(c.tbl, c.nbs, c.bt, c.pxb, c.B, row, (j0 + i) * c.bt);
      home[i] = k.pool ? ((((size_t)layer * c.pxb + k.row) * c.bt + k.t) | (1ull << 63))
                       : ((size_t)layer * c.B + k.row) * c.S + k.t;
    }
  }
}

struct Tok {
  bool pool;
  size_t t;
};

template <bool PAGED>
__device__ __forceinline__ Tok key_tok(const LatentCache& c, const unsigned long long* home,
                                       int layer, int row, int k0, int pos) {
  if constexpr (PAGED) {
    const unsigned long long h = home[pos / c.bt - k0 / c.bt];
    return {(h >> 63) != 0, (size_t)(h & ~(1ull << 63)) + pos % c.bt};
  }
  return {false, ((size_t)layer * c.B + row) * c.S + pos};
}

// A fragments (16 rows) of one k-step from a row-major tile: rows g and
// g + 8 at `base` and 16 bytes on (m16n8k32 s8 and m16n8k16 bf16 alike).
__device__ __forceinline__ void a_frag(unsigned (&af)[4], const unsigned char* base, int stride,
                                       int g) {
  af[0] = ld32(base + g * stride);
  af[1] = ld32(base + (g + 8) * stride);
  af[2] = ld32(base + g * stride + 16);
  af[3] = ld32(base + (g + 8) * stride + 16);
}

// Programmatic dependent launch: the PV and combine kernels are launched
// to start while their predecessor runs; each does what needs only the
// call's inputs (the row's keys, their copies, c_new), then waits for the
// predecessor's writes. Without the launch attribute both are no-ops.
__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 16 bytes, or zeros
__device__ __forceinline__ uint4 ld_or0(const bf16* p, bool ok) {
  return ok ? *reinterpret_cast<const uint4*>(p) : make_uint4(0, 0, 0, 0);
}

// 8 bf16 (16 bytes) as floats (common.cuh's load8, split from its load so
// that the loads are issued ahead)
__device__ __forceinline__ void bf8(const uint4& raw, float* out) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// ---------------------------------------------------------------------------
// pass 1: scores, and (m, l, a) per split and head

template <bool PAGED, bool REQUANT>
__global__ void __launch_bounds__(THREADS, 2) mla_score_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ScoreSmem& sm = *reinterpret_cast<ScoreSmem*>(smem_raw);
  const LatentCache& c = a.c;
  const int z = blockIdx.x, b = blockIdx.y, h0 = blockIdx.z * HG;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  pdl_launch_dependents();
  const Split sp = row_split(a, b, z);
  if (sp.n <= 0) return;  // past the row's fill
  const int n = sp.n, wl = sp.wl, k0 = sp.k0;
  const int row = a.rows[b];
  // the queries' loads first (a warp two heads), used under the copies
  uint4 qraw[2][2], craw[2], qrraw[2], rraw = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int hh = h0 + 2 * wid + j;
    const bf16* q = a.qt + ((size_t)b * a.H + hh) * R;
    qraw[j][0] = ld_or0(q + lane * 8, hh < a.H);
    qraw[j][1] = ld_or0(q + 256 + lane * 8, hh < a.H);
    qrraw[j] = ld_or0(a.qr + ((size_t)b * a.H + hh) * DR + lane * 8, hh < a.H && lane < DR / 8);
    craw[j] = ld_or0(a.cnew + (size_t)b * R + 256 * j + lane * 8, true);
  }
  if (lane < DR / 8) rraw = ld_or0(a.rnew + (size_t)b * DR + lane * 8, true);
  resolve_homes<PAGED>(c, a.layer, row, k0, n, sm.home);
  __syncthreads();

  // this warp's keys: a latent row a warp instruction, 16 bytes a lane
  const int p0 = wid * WKEYS;
#pragma unroll 4
  for (int kk = 0; kk < WKEYS; ++kk) {
    const int p = p0 + kk;
    const int8_t* src = nullptr;
    if (p < n && p != wl) {
      const Tok k = key_tok<PAGED>(c, sm.home, a.layer, row, k0, k0 + p);
      src = (k.pool ? c.plq : c.lq) + k.t * R + lane * 16;
    }
    cp16(sm.lat + p * LSTR + lane * 16, src, c.lq);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int idx = lane + 32 * r, p = p0 + idx / 4, ch = idx % 4;
    const int8_t* src = nullptr;
    if (p < n && p != wl) {
      const Tok k = key_tok<PAGED>(c, sm.home, a.layer, row, k0, k0 + p);
      src = (k.pool ? c.prq : c.rq) + k.t * DR + ch * 16;
    }
    cp16(sm.rop + p * RSTR + ch * 16, src, c.rq);
  }
  cp_commit();
  if (lane < WKEYS) {
    const int p = p0 + lane;
    float lsc = 0.f, rsc = 0.f;
    if (p < n && p != wl) {
      const Tok k = key_tok<PAGED>(c, sm.home, a.layer, row, k0, k0 + p);
      lsc = __bfloat162float((k.pool ? c.pls : c.ls)[k.t]);
      rsc = __bfloat162float((k.pool ? c.prs : c.rs)[k.t]);
    }
    sm.ls[p] = lsc;
    sm.rs[p] = rsc;
  }

  // the queries, under the copies: qsc, q̃8 (or q̃ in bf16) and the exact
  // score of position w
  float cn[16];
  bf8(craw[0], cn);
  bf8(craw[1], cn + 8);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int hl = 2 * wid + j;
    float v[16];
    bf8(qraw[j][0], v);
    bf8(qraw[j][1], v + 8);
    float amax = 0.f, dc = 0.f, dr = 0.f;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      amax = fmaxf(amax, fabsf(v[e]));
      dc = fmaf(v[e], cn[e], dc);
    }
    if (lane < DR / 8) {
      float qv[8], rv[8];
      bf8(qrraw[j], qv);
      bf8(rraw, rv);
#pragma unroll
      for (int e = 0; e < 8; ++e) dr = fmaf(qv[e], rv[e], dr);
      *reinterpret_cast<uint4*>(sm.qr + hl * QRSTR + lane * 16) = qrraw[j];
    }
    amax = warp_max(amax);
    dc = warp_sum(dc);
    dr = warp_sum(dr);
    const float qsc = fmaxf(amax * INV127, 1e-30f);
    if constexpr (REQUANT) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        unsigned w8[2] = {0u, 0u};
#pragma unroll
        for (int e = 0; e < 8; ++e)
          w8[e / 4] |= ((unsigned)(int)rintf(v[8 * half + e] / qsc) & 0xffu) << (8 * (e % 4));
        *reinterpret_cast<uint2*>(sm.q + hl * Q8STR + 256 * half + lane * 8) =
            make_uint2(w8[0], w8[1]);
      }
    } else {
      *reinterpret_cast<uint4*>(sm.q + hl * QBSTR + lane * 16) = qraw[j][0];
      *reinterpret_cast<uint4*>(sm.q + hl * QBSTR + 512 + lane * 16) = qraw[j][1];
    }
    if (lane == 0) {
      sm.qsc[hl] = qsc;
      sm.snew[hl] = (dc + dr) * a.scale;
    }
  }
  __syncthreads();
  cp_wait<0>();
  __syncwarp();

  // scores of the warp's two 8-key n-tiles for the 16 heads
  const int g = lane >> 2, t = lane & 3;
  float s[2][4];
  {
    float racc[2][4] = {};
    unsigned af[4];
#pragma unroll
    for (int ks = 0; ks < DR / 16; ++ks) {
      a_frag(af, sm.qr + ks * 32 + 4 * t, QRSTR, g);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const unsigned char* rb = sm.rop + (p0 + 8 * nt + g) * RSTR + ks * 16 + 2 * t;
        mma_bf16(racc[nt], af, i8x2_bf16x2(ld16(rb)), i8x2_bf16x2(ld16(rb + 8)));
      }
    }
    float lacc[2][4];
    if constexpr (REQUANT) {
      int acc[2][4] = {};
#pragma unroll 4
      for (int ks = 0; ks < R / 32; ++ks) {
        a_frag(af, sm.q + ks * 32 + 4 * t, Q8STR, g);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const unsigned char* lb = sm.lat + (p0 + 8 * nt + g) * LSTR + ks * 32 + 4 * t;
          mma_s8(acc[nt], af, ld32(lb), ld32(lb + 16));
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) lacc[nt][j] = (float)acc[nt][j];
    } else {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) lacc[nt][j] = 0.f;
#pragma unroll 4
      for (int ks = 0; ks < R / 16; ++ks) {
        a_frag(af, sm.q + ks * 32 + 4 * t, QBSTR, g);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const unsigned char* lb = sm.lat + (p0 + 8 * nt + g) * LSTR + ks * 16 + 2 * t;
          mma_bf16(lacc[nt], af, i8x2_bf16x2(ld16(lb)), i8x2_bf16x2(ld16(lb + 8)));
        }
      }
    }
    // c fragment j: head g + 8 * (j / 2), key 2t + j % 2 of the n-tile
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int hl = g + 8 * (j >> 1), p = p0 + 8 * nt + 2 * t + (j & 1);
        const float ls = sm.ls[p];
        const float rs = sm.rs[p];
        float v = REQUANT ? (float)lacc[nt][j] * (a.scale * sm.qsc[hl]) * ls +
                                racc[nt][j] * rs * a.scale
                          : (lacc[nt][j] * ls + racc[nt][j] * rs) * a.scale;
        if (p == wl) v = sm.snew[hl];
        s[nt][j] = p < n ? v : NEG_BIG;
        if (p < n && h0 + hl < a.H) a.sc[((size_t)b * a.H + h0 + hl) * a.SP + k0 + p] = v;
      }
  }

  // (m, l, a) of this split, per head
  float m0 = fmaxf(fmaxf(s[0][0], s[0][1]), fmaxf(s[1][0], s[1][1]));
  float m1 = fmaxf(fmaxf(s[0][2], s[0][3]), fmaxf(s[1][2], s[1][3]));
  m0 = quad_max(m0);
  m1 = quad_max(m1);
  if (t == 0) {
    sm.red[wid][g] = m0;
    sm.red[wid][g + 8] = m1;
  }
  __syncthreads();
  if (tid < HG) {
    float m = NEG_BIG;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) m = fmaxf(m, sm.red[i][tid]);
    sm.m[tid] = m;
  }
  __syncthreads();
  float l[2] = {0.f, 0.f}, am[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int hi = j >> 1, p = p0 + 8 * nt + 2 * t + (j & 1);
      if (p < n) {
        const float e = expf(s[nt][j] - sm.m[g + 8 * hi]);
        l[hi] += e;
        if (p != wl) am[hi] = fmaxf(am[hi], e * sm.ls[p]);
      }
    }
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    l[hi] = quad_sum(l[hi]);
    am[hi] = quad_max(am[hi]);
  }
  if (t == 0) {
    sm.red[wid][g] = l[0];
    sm.red[wid][g + 8] = l[1];
    sm.red2[wid][g] = am[0];
    sm.red2[wid][g + 8] = am[1];
  }
  __syncthreads();
  if (tid < HG && h0 + tid < a.H) {
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) {
      lt += sm.red[i][tid];
      at = fmaxf(at, sm.red2[i][tid]);
    }
    float* st = a.st + ((size_t)b * a.nsplit + z) * 3 * a.H + h0 + tid;
    st[0] = sm.m[tid];
    st[a.H] = lt;
    st[2 * a.H] = at;
  }
}

// ---------------------------------------------------------------------------
// pass 2: p8 with the group's scale, and the split's P.V

// the 16-byte chunk slot of chunk `ch` of key `p` in the PV tile: bits 1-2
// XOR (p / 4) % 4, so that the transposing loads (four keys, eight column
// quads) hit 32 banks
__device__ __forceinline__ int swz(int p, int ch) { return ch ^ (((p >> 2) & 3) << 1); }

__device__ __forceinline__ void cp_wait_stage(int ks) {
  // stage ks has landed once at most STAGES - 1 - ks groups are pending
  if (ks == 0) cp_wait<STAGES - 1>();
  else if (ks == 1) cp_wait<STAGES - 2>();
  else if (ks == 2) cp_wait<STAGES - 3>();
  else cp_wait<0>();
}

template <bool PAGED, bool REQUANT>
__global__ void __launch_bounds__(THREADS) mla_pv_kernel(const Args a) {
  static_assert(STAGES == 4, "cp_wait_stage counts four stages");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PvSmem& sm = *reinterpret_cast<PvSmem*>(smem_raw);
  const LatentCache& c = a.c;
  const int z = blockIdx.x, b = blockIdx.y, h0 = blockIdx.z * HG;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  pdl_launch_dependents();
  const Split sp = row_split(a, b, z);
  if (sp.n <= 0) return;
  const int n = sp.n, wl = sp.wl, k0 = sp.k0;
  const int nlive = sp.we / CH + 1;  // the row's splits that hold keys
  const int row = a.rows[b];
  resolve_homes<PAGED>(c, a.layer, row, k0, n, sm.home);
  __syncthreads();

  // the latent tile in four 32-key stages, a commit group each (a key row a
  // warp instruction, 16 bytes a lane)
#pragma unroll
  for (int stg = 0; stg < STAGES; ++stg) {
#pragma unroll
    for (int r = 0; r < 32 * 32 / THREADS; ++r) {
      const int idx = tid + THREADS * r, p = stg * 32 + idx / 32, ch = idx % 32;
      const int8_t* src = nullptr;
      if (p < n && p != wl) {
        const Tok k = key_tok<PAGED>(c, sm.home, a.layer, row, k0, k0 + p);
        src = (k.pool ? c.plq : c.lq) + k.t * R + ch * 16;
      }
      cp16(sm.lat + p * R + swz(p, ch) * 16, src, c.lq);
    }
    cp_commit();
  }
  if (tid < CH) {
    float lsc = 0.f;
    if (tid < n && tid != wl) {
      const Tok k = key_tok<PAGED>(c, sm.home, a.layer, row, k0, k0 + tid);
      lsc = __bfloat162float((k.pool ? c.pls : c.ls)[k.t]);
    }
    sm.ls[tid] = lsc;
  }

  // what the score pass wrote: this split's scores (8 keys a thread, a
  // head per 16 threads), the row max M and, for a group that spans
  // splits, its max of p * ls over them (kept relative to the largest m
  // among them, ms, while the splits are read)
  pdl_wait();
  const int hl = tid >> 4, l16 = tid & 15, pk = l16 * 8;
  const bool hv = h0 + hl < a.H;
  const float* sc = a.sc + ((size_t)b * a.H + h0 + hl) * a.SP + k0 + pk;
  const float4 s0 = hv ? *reinterpret_cast<const float4*>(sc) : make_float4(0, 0, 0, 0);
  const float4 s1 = hv ? *reinterpret_cast<const float4*>(sc + 4) : make_float4(0, 0, 0, 0);
  const float* st = a.st + (size_t)b * a.nsplit * 3 * a.H + h0 + hl;
  const size_t sstr = (size_t)3 * a.H;
  const bool local = local_group(a.group);
  const bool span = REQUANT && !local;
  int zlo = 0, zhi = nlive;  // the whole row
  if (span && a.group < c.S) {  // a multiple of CH: its splits
    zlo = k0 / a.group * (a.group / CH);
    zhi = min(zlo + a.group / CH, nlive);
  }
  float M = NEG_BIG, ms = NEG_BIG, as = 0.f;
  if (hv)
    for (int zz = l16; zz < nlive; zz += 16) {
      const float m = st[zz * sstr];
      M = fmaxf(M, m);
      if (span && zz >= zlo && zz < zhi) {
        const float av = st[zz * sstr + 2 * a.H];
        if (m > ms) {
          as *= expf(ms - m);
          ms = m;
        }
        as = fmaxf(as, av * expf(m - ms));
      }
    }
  M = half_max(M);
  const float gs = half_max(as * expf(ms - M));
  __syncthreads();  // ls

  // p * ls of 8 keys a thread, then p8 (or f32 p * ls in the exact arm)
  {
    const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    float pv[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int p = pk + e;
      pv[e] = (hv && p < n && p != wl) ? expf(sv[e] - M) * sm.ls[p] : 0.f;
    }
    if constexpr (REQUANT) {
      float gmax = gs;
      if (local) {
        gmax = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) gmax = fmaxf(gmax, pv[e]);
        for (int o = 1; o < a.group / 8; o <<= 1)
          gmax = fmaxf(gmax, __shfl_xor_sync(0xffffffffu, gmax, o));
      }
      const float psc = fmaxf(gmax * INV127, 1e-30f);
      unsigned w8[2] = {0u, 0u};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int q = min((int)rintf(pv[e] / psc), 127);
        w8[e / 4] |= ((unsigned)q & 0xffu) << (8 * (e % 4));
      }
      *reinterpret_cast<uint2*>(sm.a.p8 + hl * P8STR + pk) = make_uint2(w8[0], w8[1]);
      if (local ? pk % a.group == 0 : pk == 0) sm.psc[hl][local ? pk / a.group : 0] = psc;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) sm.a.pf[(pk + e) * HG + hl] = pv[e];
    }
  }

  const int nks = (n + 31) / 32;
  float* part = a.part + ((size_t)b * a.nsplit + z) * a.H * R;
  if constexpr (REQUANT) {
    // a warp 64 columns: quads m = 0, 1 of 32, n-tile (m, e) holds columns
    // 64 wid + 32 m + 4 n + e for n = 0..7
    const int g = lane >> 2, t = lane & 3;
    const int gl = local ? a.group : CH;  // keys of a group inside this split
    float acc[2][4][4] = {};
    int ai[2][4][4] = {};
#pragma unroll
    for (int ks = 0; ks < STAGES; ++ks) {
      cp_wait_stage(ks);
      __syncthreads();
      if (ks < nks) {
        unsigned af[4];
        a_frag(af, reinterpret_cast<const unsigned char*>(sm.a.p8) + ks * 32 + 4 * t, P8STR, g);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int cw = wid * 16 + m * 8 + g;  // this lane's column quad
          unsigned bt[2][4];
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            unsigned wv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int kr = ks * 32 + 16 * hf + 4 * t + i;
              wv[i] = ld32(sm.lat + kr * R + swz(kr, cw >> 2) * 16 + (cw & 3) * 4);
            }
            transpose4(wv, bt[hf]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) mma_s8(ai[m][e], af, bt[0][e], bt[1][e]);
        }
      }
      if (((ks + 1) * 32) % gl == 0 || ks == STAGES - 1) {  // a group's end: apply its psc
        const int lg = local ? ks * 32 / gl : 0;
        const float ps0 = sm.psc[g][lg], ps1 = sm.psc[g + 8][lg];
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              acc[m][e][j] += (float)ai[m][e][j] * (j < 2 ? ps0 : ps1);
              ai[m][e][j] = 0;
            }
      }
    }
    // c fragment j of n-tile (m, e): head g + 8 (j / 2), column
    // 64 wid + 32 m + 8 t + 4 (j % 2) + e
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int hh = h0 + g + 8 * hi;
        if (hh >= a.H) continue;
        float* o = part + (size_t)hh * R + wid * 64 + m * 32 + 8 * t;
        *reinterpret_cast<float4*>(o) = make_float4(acc[m][0][2 * hi], acc[m][1][2 * hi],
                                                    acc[m][2][2 * hi], acc[m][3][2 * hi]);
        *reinterpret_cast<float4*>(o + 4) = make_float4(
            acc[m][0][2 * hi + 1], acc[m][1][2 * hi + 1], acc[m][2][2 * hi + 1],
            acc[m][3][2 * hi + 1]);
      }
  } else {
    // a thread two columns of all 16 heads, f32 FMA over the shared tile
    const int c0 = 2 * tid;
    float acc[HG][2] = {};
#pragma unroll
    for (int ks = 0; ks < STAGES; ++ks) {
      cp_wait_stage(ks);
      __syncthreads();
      const int pend = min(n, ks * 32 + 32);
      for (int p = ks * 32; p < pend; ++p) {
        const unsigned short v = ld16(sm.lat + p * R + swz(p, c0 >> 4) * 16 + (c0 & 15));
        const float x0 = (float)(int8_t)(v & 0xff), x1 = (float)(int8_t)(v >> 8);
        const float4* pf = reinterpret_cast<const float4*>(sm.a.pf + p * HG);
#pragma unroll
        for (int q = 0; q < HG / 4; ++q) {
          const float4 pq = pf[q];
          const float ph[4] = {pq.x, pq.y, pq.z, pq.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[4 * q + i][0] = fmaf(ph[i], x0, acc[4 * q + i][0]);
            acc[4 * q + i][1] = fmaf(ph[i], x1, acc[4 * q + i][1]);
          }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < HG; ++h)
      if (h0 + h < a.H)
        *reinterpret_cast<float2*>(part + (size_t)(h0 + h) * R + c0) =
            make_float2(acc[h][0], acc[h][1]);
  }
}

// ---------------------------------------------------------------------------
// pass 3: a row's partials in split order, p_w * c_new, over l

__global__ void __launch_bounds__(COMBINE_THREADS) mla_combine_kernel(const Args a) {
  constexpr int CW = COMBINE_THREADS / 32;
  constexpr int U = 8;  // partials a thread has in flight
  __shared__ float red[2][CW];
  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, wid = tid >> 5;
  const Split sp = row_split(a, b, 0);
  const int nlive = sp.we / CH + 1;
  const int col = tid * 4;
  const __nv_bfloat162* c2 = reinterpret_cast<const __nv_bfloat162*>(a.cnew + (size_t)b * R + col);
  const float2 c01 = __bfloat1622float2(c2[0]), c23 = __bfloat1622float2(c2[1]);
  pdl_wait();
  // M and l over the row's splits, a split a thread
  const size_t sstr = (size_t)3 * a.H;
  const float* st = a.st + (size_t)b * a.nsplit * sstr + h;
  const float pwl = a.sc[((size_t)b * a.H + h) * a.SP + sp.we];
  float m = NEG_BIG;
  for (int zz = tid; zz < nlive; zz += COMBINE_THREADS) m = fmaxf(m, st[zz * sstr]);
  m = warp_max(m);
  if (lane == 0) red[0][wid] = m;
  __syncthreads();
  float M = red[0][0];
#pragma unroll
  for (int i = 1; i < CW; ++i) M = fmaxf(M, red[0][i]);
  float l = 0.f;
  for (int zz = tid; zz < nlive; zz += COMBINE_THREADS)
    l += expf(st[zz * sstr] - M) * st[zz * sstr + a.H];
  l = warp_sum(l);
  if (lane == 0) red[1][wid] = l;
  // the partials, summed in split order
  const float* pp = a.part + ((size_t)b * a.nsplit * a.H + h) * R + col;
  const size_t pstr = (size_t)a.H * R;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  int zz = 0;
  for (; zz + U <= nlive; zz += U) {
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = *reinterpret_cast<const float4*>(pp + (zz + u) * pstr);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      acc.x += v[u].x;
      acc.y += v[u].y;
      acc.z += v[u].z;
      acc.w += v[u].w;
    }
  }
  for (; zz < nlive; ++zz) {
    const float4 v = *reinterpret_cast<const float4*>(pp + zz * pstr);
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  __syncthreads();
  float L = 0.f;
#pragma unroll
  for (int i = 0; i < CW; ++i) L += red[1][i];
  const float pw = expf(pwl - M);
  const float v[4] = {acc.x, acc.y, acc.z, acc.w};
  const float cn[4] = {c01.x, c01.y, c23.x, c23.y};
  bf16* o = a.out + ((size_t)b * a.H + h) * R + col;
#pragma unroll
  for (int e = 0; e < 4; ++e) o[e] = __float2bfloat16((v[e] + pw * cn[e]) / L);
}

// A group the split can keep: exact (0), the whole row, whole splits, or
// whole groups of at least 32 keys (an mma k-step) inside a split.
bool group_splits(int group, int S) {
  return group == 0 || group >= S || group % CH == 0 || (group >= 32 && CH % group == 0);
}

// Launch `kernel` so that it may start while the stream's previous kernel
// runs (programmatic dependent launch); it waits for that kernel's writes
// itself (pdl_wait).
cudaError_t launch_after(void (*kernel)(Args), dim3 grid, int threads, size_t smem,
                         cudaStream_t st, const Args& a) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

template <bool PAGED, bool REQUANT>
int launch_arm(const Args& a, int Ba, cudaStream_t st) {
  const dim3 grid(a.nsplit, Ba, (a.H + HG - 1) / HG);
  cudaError_t e = cudaFuncSetAttribute(mla_score_kernel<PAGED, REQUANT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)sizeof(ScoreSmem));
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(mla_pv_kernel<PAGED, REQUANT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(PvSmem));
  if (e != cudaSuccess) return (int)e;
  mla_score_kernel<PAGED, REQUANT><<<grid, THREADS, sizeof(ScoreSmem), st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if ((e = launch_after(mla_pv_kernel<PAGED, REQUANT>, grid, THREADS, sizeof(PvSmem), st, a)) !=
      cudaSuccess)
    return (int)e;
  return (int)launch_after(mla_combine_kernel, dim3(Ba, a.H), COMBINE_THREADS, 0, st, a);
}

template <bool PAGED>
int launch(const bf16* qt, const bf16* qr, const bf16* cnew, const bf16* rnew,
           const LatentCache& c, const int* lengths, const int* rows, bf16* out, float* ws,
           int layer, int Ba, int H, int Rr, int dr, int group, int split, float scale,
           void* stream) {
  if (Rr != R || dr != DR || split != CH || H < 1 || Ba < 1 || c.S < 1 || group < 0 ||
      !group_splits(group, c.S) || ws == nullptr)
    return (int)cudaErrorInvalidValue;
  const int nsplit = (c.S + CH - 1) / CH;
  const int SP = nsplit * CH;
  float* part = ws;  // first: its float4 stores want 16-byte alignment
  float* sc = part + (size_t)Ba * nsplit * H * R;
  float* st = sc + (size_t)Ba * H * SP;
  const Args a{qt, qr, cnew, rnew, c, lengths, rows, out, sc, st, part,
               layer, H, group, nsplit, SP, scale};
  cudaStream_t s = (cudaStream_t)stream;
  return group > 0 ? launch_arm<PAGED, true>(a, Ba, s) : launch_arm<PAGED, false>(a, Ba, s);
}

}  // namespace

extern "C" int decode_attend_q8_mla(const void* qt, const void* qr, const void* cnew,
                                    const void* rnew, const void* lat_q, const void* lat_s,
                                    const void* rop_q, const void* rop_s, const void* lengths,
                                    const void* rows, void* out, void* ws, int layer, int B,
                                    int Ba, int H, int S, int R_, int dr, int group, int split,
                                    float scale, void* stream) {
  const LatentCache c{(const int8_t*)lat_q, (const bf16*)lat_s, (const int8_t*)rop_q,
                      (const bf16*)rop_s, nullptr, nullptr, nullptr, nullptr, nullptr,
                      B, S, 0, 0, 0};
  return launch<false>((const bf16*)qt, (const bf16*)qr, (const bf16*)cnew, (const bf16*)rnew,
                       c, (const int*)lengths, (const int*)rows, (bf16*)out, (float*)ws, layer,
                       Ba, H, R_, dr, group, split, scale, stream);
}

extern "C" int decode_attend_q8_mla_paged(
    const void* qt, const void* qr, const void* cnew, const void* rnew, const void* lat_q,
    const void* lat_s, const void* rop_q, const void* rop_s, const void* lengths,
    const void* rows, const void* tbl, const void* plat_q, const void* plat_s,
    const void* prop_q, const void* prop_s, void* out, void* ws, int layer, int B, int Ba,
    int H, int S, int R_, int dr, int group, int split, int nbs, int bt, int pxb, float scale,
    void* stream) {
  if (nbs <= 0 || bt <= 0 || nbs * bt != S || pxb <= 0) return (int)cudaErrorInvalidValue;
  const LatentCache c{(const int8_t*)lat_q, (const bf16*)lat_s, (const int8_t*)rop_q,
                      (const bf16*)rop_s, (const int*)tbl, (const int8_t*)plat_q,
                      (const bf16*)plat_s, (const int8_t*)prop_q, (const bf16*)prop_s,
                      B, S, nbs, bt, pxb};
  return launch<true>((const bf16*)qt, (const bf16*)qr, (const bf16*)cnew, (const bf16*)rnew,
                      c, (const int*)lengths, (const int*)rows, (bf16*)out, (float*)ws, layer,
                      Ba, H, R_, dr, group, split, scale, stream);
}
