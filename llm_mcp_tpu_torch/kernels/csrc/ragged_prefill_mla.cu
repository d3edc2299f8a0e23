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
//   (a) its row's cached prefix [0, min(starts[r], S)): score
//       ((q̃ . lat) * ls + (qr . rop) * rs) * scale, value lat * ls;
//   (b) the chunk's own keys of its row at packed index <= t: score
//       (q̃ . c + qr . kr) * scale, value c (exact, not quantized);
// with one online softmax over both, no requantization; a row that attends
// nothing emits 0. Pads (rowid R) attend earlier pads.
//
// Bound on the H100: operations, 2 * (R + dr) + 2 * R = 2176 flops per
// (query, key, head), so both products run on the bf16 tensor cores
// (`wgmma.mma_async`, sm_90a), bf16 in and f32 out. The absorbed form is
// MQA-shaped: every head of a token scores against the same latent + rope
// row, and the value is that same latent row. So:
//   - A CTA owns 64 query rows, 64 consecutive (token, head) pairs of the
//     [T * H] rows of qt/qr (64 / H tokens; H divides 64). Q = [q̃ | qr]
//     sits in shared memory once, 64 x 576 bf16 (72 KB), in nine 64-column
//     atoms of the 128-byte swizzled K-major layout.
//   - A key tile is 32 keys x 576 columns of bf16 (36 KB, nine atoms of
//     32 rows) and serves both products: the K-major B operand of
//     S = Q.K^T over all 576 columns, and its first 512 columns the MN-major
//     B operand of O += P.V. Each latent row enters shared memory once.
//   - Tiles fill a ring of two stages with `cp.async` (16 bytes a copy,
//     keys past the tile's count zero-filled, so no stale value meets a
//     zero p), so the copy of tile i+1 is in flight while tile i is
//     multiplied. Before the copies, 32 threads resolve each key's latent
//     row, rope row, two scales and descriptor row into a table slot: that
//     is where a paged arm follows its table, once per key (a tile may
//     straddle blocks of any bt). The slots run one tile further ahead than
//     the copies, so the resolving warp's loads hide under tile i's S.
//   - Two consumer warpgroups, 256 threads. Warpgroup w owns output columns
//     [256w, 256w + 256): O is 64 x 256 f32 in registers, 128 a thread.
//     Each warpgroup computes the whole S itself with the same m64n32k16
//     chain over the same shared memory, so both hold the same scores,
//     (m, l) and P and exchange nothing. S is two accumulators: on an int8
//     prefix tile S_lat (columns 0-511, 32 k-steps) and S_rop (512-575,
//     4 k-steps), the score (S_lat * ls + S_rop * rs) * scale after the
//     products, the order of JAX and the plain version; on a bf16 tile
//     (ls = rs = 1) the two halves of the 36 k-steps, summed: one long
//     chain on the tensor cores sums less exactly than f32 FMA, and the
//     V2-Lite 2-layer check in chip_smoke.py saw it.
//   - P stays in registers, in the accumulator layout, as the A operand of
//     m64n256k16. p * ls enters as PT = 3 bf16 terms, each the bf16 of what
//     the terms before leave (about 24 bits, as f32): one term fails
//     |err| <= 1e-3 + 1e-2*|ref| on rows of few keys (tile_attention.cuh
//     takes two), and two still moved the V2-Lite 2-layer check's logits
//     past its cosine bound through the MoE routing; l sums the bare p.
//   - int8 latents arrive in an int8 staging ring (two 18 KB stages, two
//     tiles ahead); tile i+1 is widened to bf16 (exact, by integer ops)
//     into the other bf16 stage while tile i's S runs. The chunk's own keys
//     are bf16 in every arm, so the prefix segments and the self segment
//     each run the ring with one kind of tile: it drains at a segment's end.
//   - Passes, per CTA: (a) every descriptor row with tokens in the tile
//     streams its prefix, masked to that row's query rows; (b) the chunk's
//     keys from offsets[rowid(first token)] to the tile's last token,
//     masked by row and packed index <= the query's token. Pads form one
//     more segment from offsets[R]. CTAs start from the buffer's end: the
//     later tokens attend more keys, so the long CTAs go first.
// Shared memory: Q 72 KB + two bf16 stages 72 KB + two int8 stages 36 KB +
// four table slots + alignment, 188,928 bytes: one CTA an SM (ptxas: 255
// registers, no spill). A third bf16 stage (NST = 3, 225,792 bytes)
// measured 0.1-0.9 % slower on an H100, so the ring keeps two.
//
// Left for later: the redundant S (each warpgroup issues the whole score
// chain, about a quarter of the tensor work issued; one warpgroup could
// score and pass P through shared memory, or the contraction could be
// split), TMA copies, and warp specialization (a producer warp, S of tile
// i+1 overlapping the softmax of tile i; the registers are full).
//
// Layouts: qt [T, H, R], qr [T, H, dr], c_self [T, R], kr_self [T, dr]
// bf16; latents [L, B, 1, S, R] bf16 or {int8 q, bf16 s [L, B, 1, S]},
// rope keys [L, B, 1, S, dr] likewise; pools [L, pxb, 1, bt, ...]; rowids
// [T], offsets [R+1], slots/starts [R] int32; tables [R, nbs] (gathered to
// the descriptor rows by the wrapper); out [T, H, R] bf16. R = 512, dr = 64.

#include "paged.cuh"
#include "tile_attention.cuh"

namespace {

constexpr int RL = 512;  // kv_lora_rank
constexpr int DR = 64;   // qk_rope_head_dim
constexpr int D = RL + DR;
constexpr int BQ = 64;        // query rows a CTA: (token, head) pairs
constexpr int BK = 32;        // keys a tile
constexpr int THREADS = 256;  // two warpgroups
constexpr int CH = D / 8;     // 16-byte bf16 chunks of a row (72)
constexpr int CH8 = D / 16;   // 16-byte int8 chunks of a row (36)
constexpr int Q_ATOM = BQ * 128;  // one 64-column atom of Q (bytes)
constexpr int K_ATOM = BK * 128;  // one 64-column atom of a key tile
constexpr int K_BYTES = (D / 64) * K_ATOM;
constexpr int K8_BYTES = BK * D;
// bf16 terms p enters P.V as (their sum carries about 8 * PT bits of p)
constexpr int PT = 3;
// Stages of the bf16 key ring. An int8 segment copies into two int8 stages, two tiles
// ahead, and widens tile i + 1 into bf16 stage (i + 1) % 2 while tile i is
// multiplied. Table slots cover the tiles in flight and one more, so a
// tile's keys resolve while an earlier tile is multiplied.
constexpr int NST = 2;
constexpr int AHEAD8 = 2;  // int8 tiles issued ahead of the one multiplied
constexpr int NT = NST + 1 > AHEAD8 + 2 ? NST + 1 : AHEAD8 + 2;
// byte offsets from the 1024-aligned base
constexpr int Q_OFF = 0;
constexpr int K_OFF = Q_OFF + (D / 64) * Q_ATOM;
constexpr int K8_OFF = K_OFF + NST * K_BYTES;
constexpr int TABLE_OFF = K8_OFF + AHEAD8 * K8_BYTES;
constexpr int TABLE_BYTES = NT * BK * (8 + 8 + 4 + 4 + 4);  // lat, rop, ls, rs, tag
constexpr size_t SMEM_BYTES = TABLE_OFF + TABLE_BYTES + 1024;  // + alignment slack
static_assert(NST >= 2 && SMEM_BYTES <= 232448, "shared memory of one CTA");

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

// Where a key of a tile comes from, and the descriptor row the self mask
// reads.
struct Key {
  const void* lat;
  const void* rop;
  float ls;
  float rs;
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
  __device__ unsigned char* k(int st) const { return base + K_OFF + st * K_BYTES; }
  __device__ int8_t* k8(int st) const {
    return reinterpret_cast<int8_t*>(base + K8_OFF + st * K8_BYTES);
  }
  // table slot ts (0 <= ts < NT)
  __device__ const void** lat(int ts) const {
    return reinterpret_cast<const void**>(base + TABLE_OFF) + ts * BK;
  }
  __device__ const void** rop(int ts) const {
    return reinterpret_cast<const void**>(base + TABLE_OFF) + (NT + ts) * BK;
  }
  __device__ float* ls(int ts) const {
    return reinterpret_cast<float*>(base + TABLE_OFF + 2 * NT * BK * 8) + ts * BK;
  }
  __device__ float* rs(int ts) const {
    return reinterpret_cast<float*>(base + TABLE_OFF + 2 * NT * BK * 8) + (NT + ts) * BK;
  }
  __device__ int* tag(int ts) const {
    return reinterpret_cast<int*>(base + TABLE_OFF + 2 * NT * BK * 8) + (2 * NT + ts) * BK;
  }
};

// Thread (warpgroup w, warp v, lane) holds query rows 16v + lane/4 and that
// + 8, and output columns 256w + 8j + 2(lane%4) + {0, 1}: o[4j + 2i + c].
struct State {
  float o[128];
  float m[2];
  float l[2];
};

// Byte offset of 16-byte chunk c (0..71) of row r in a tile of 64-column
// atoms `atom` bytes apart (row r's chunk c of an atom at r*128 +
// ((c ^ r%8) * 16)).
__device__ __forceinline__ int swz(int atom, int r, int c) {
  return (c >> 3) * atom + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// K-major operand (Q or a key tile): k-step kk covers columns 16kk..16kk+15;
// 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_kmajor(const unsigned char* t, int atom, int kk) {
  return tile::desc(t + (kk >> 2) * atom + (kk & 3) * 32, 16, 1024);
}

// MN-major B operand of P.V: keys 16kk..16kk+15 of the key tile, the 256
// columns of atoms 4w..4w+3 (K_ATOM apart), 8-key groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_v(const unsigned char* t, int w, int kk) {
  return tile::desc(t + 4 * w * K_ATOM + kk * 16 * 128, K_ATOM, 1024);
}

// S (+)= Q.K^T for 64 rows x 32 keys x 16 columns, both from shared memory.
__device__ __forceinline__ void mma_s(float (&d)[16], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// O += P.V for 64 rows x 256 columns x 16 keys, P in registers (the A
// fragment of four bf16 pairs), V from shared memory (transposed).
__device__ __forceinline__ void mma_o(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// -- loads ----------------------------------------------------------------------

// Keys of tile i of a segment of n keys (a prefix of its 32).
__device__ __forceinline__ int tile_keys(int n, int i) { return min(BK, n - i * BK); }

// Resolve the keys of tile i into table slot i % NT (32 threads, one key
// each; keys past the tile's count get no rows and zero scales).
template <class Prep>
__device__ __forceinline__ void resolve(const Smem& s, int i, int n, Prep prep) {
  const int kk = threadIdx.x;
  if (kk >= BK) return;
  const Key key = kk < tile_keys(n, i) ? prep(i, kk) : Key{nullptr, nullptr, 0.f, 0.f, -2};
  const int ts = i % NT;
  s.lat(ts)[kk] = key.lat;
  s.rop(ts)[kk] = key.rop;
  s.ls(ts)[kk] = key.ls;
  s.rs(ts)[kk] = key.rs;
  s.tag(ts)[kk] = key.tag;
}

// Issue the copies of tile i (its table resolved): bf16 rows into bf16
// stage i % NST (swizzled), or int8 rows into int8 staging i % AHEAD8
// ([32][576]).
template <bool Q8>
__device__ __forceinline__ void issue(const Smem& s, int i) {
  const int tid = threadIdx.x;
  const int st = i % (Q8 ? AHEAD8 : NST);
  const void* const* lat = s.lat(i % NT);
  const void* const* rop = s.rop(i % NT);
  if constexpr (Q8) {
    for (int c = tid; c < BK * CH8; c += THREADS) {
      const int r = c / CH8;
      const int ch = c % CH8;
      const int8_t* src = static_cast<const int8_t*>(ch < RL / 16 ? lat[r] : rop[r]);
      cp16(s.k8(st) + r * D + ch * 16,
           src != nullptr ? src + (ch < RL / 16 ? ch : ch - RL / 16) * 16 : nullptr, s.any);
    }
  } else {
#pragma unroll
    for (int j = 0; j < BK * CH / THREADS; ++j) {
      const int c = j * THREADS + tid;
      const int r = c / CH;
      const int ch = c % CH;
      const bf16* src = static_cast<const bf16*>(ch < RL / 8 ? lat[r] : rop[r]);
      cp16(s.k(st) + swz(K_ATOM, r, ch),
           src != nullptr ? src + (ch < RL / 8 ? ch : ch - RL / 8) * 8 : nullptr, s.any);
    }
  }
}

// Four int8 (one word, element 0 in the low byte) as four bf16 (two
// words), exactly and without int-to-float conversions: each byte, biased
// to unsigned, becomes the low mantissa byte of 2^23 (0x4B0000uu);
// subtracting 2^23 + 128 leaves the value, whose f32 top half is its bf16
// (|x| <= 128 needs 8 significant bits).
__device__ __forceinline__ void widen4(uint32_t x, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = x ^ 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    f[k] = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + k)) - 8388736.f);
  lo = __byte_perm(f[0], f[1], 0x7632);
  hi = __byte_perm(f[2], f[3], 0x7632);
}

// int8 tile i (staging i % AHEAD8) -> bf16 stage kv, swizzled (16 int8 a
// job, two 16-byte bf16 chunks out).
__device__ __forceinline__ void widen(const Smem& s, int i, int kv) {
  unsigned char* dst = s.k(kv);
  const int8_t* src = s.k8(i % AHEAD8);
  for (int c = threadIdx.x; c < BK * CH8; c += THREADS) {
    const int r = c / CH8;
    const int ch = c % CH8;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + r * D + ch * 16);
    uint32_t w[8];
    widen4(raw.x, w[0], w[1]);
    widen4(raw.y, w[2], w[3]);
    widen4(raw.z, w[4], w[5]);
    widen4(raw.w, w[6], w[7]);
    *reinterpret_cast<int4*>(dst + swz(K_ATOM, r, 2 * ch)) = make_int4(w[0], w[1], w[2], w[3]);
    *reinterpret_cast<int4*>(dst + swz(K_ATOM, r, 2 * ch + 1)) = make_int4(w[4], w[5], w[6], w[7]);
  }
}

// -- one key tile ---------------------------------------------------------------

// Scores, online softmax and P.V of key tile ti, whose rows sit in bf16
// stage kv and whose table sits in slot ts. mask(ti, i, kk, tag) says
// whether this thread's query row r0 + 8i may attend key kk (kk < nkeys).
// Q8: the tile's scales multiply the scores and the probabilities (an int8
// prefix tile); else they are 1. `during()` runs while S is on the tensor
// cores.
template <bool Q8, class Mask, class During>
__device__ __forceinline__ void step(const Smem& s, State& S_, int ti, int kv, int ts,
                                     int nkeys, float scale, Mask mask, During during) {
  const int w = threadIdx.x >> 7;
  const int c0 = 2 * (threadIdx.x & 3);
  const unsigned char* kt = s.k(kv);  // the ring stage read
  float sl[16], sr[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) sl[e] = sr[e] = 0.f;
  tile::hold(sl);
  tile::hold(sr);
  tile::wg_fence();
  // Q8: sl = q̃ . lat, sr = qr . rop (each takes its own scale); else
  // the two halves of the 36 k-steps: the tensor cores' f32 sums lose
  // more along one long chain, and the outputs then round away from the
  // plain version's more often
  constexpr int SPLIT = Q8 ? RL / 16 : 16;
#pragma unroll
  for (int kk = 0; kk < SPLIT; ++kk)
    mma_s(sl, desc_kmajor(s.q(), Q_ATOM, kk), desc_kmajor(kt, K_ATOM, kk), kk);
#pragma unroll
  for (int kk = SPLIT; kk < D / 16; ++kk)
    mma_s(sr, desc_kmajor(s.q(), Q_ATOM, kk), desc_kmajor(kt, K_ATOM, kk), kk - SPLIT);
  tile::wg_commit();
  during();
  tile::wg_wait();
  tile::hold(sl);
  tile::hold(sr);

  const float* lss = s.ls(ts);
  const float* rss = s.rs(ts);
  const int* tag = s.tag(ts);
  uint32_t ok = 0;
  float mx[2] = {NEG_BIG, NEG_BIG};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int kk = 8 * j + c0 + c;
      const bool live = kk < nkeys;
      const int tg = tag[kk];
      float ls = 1.f, rs = 1.f;
      if constexpr (Q8) {
        ls = lss[kk];
        rs = rss[kk];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = 4 * j + 2 * i + c;
        const float v = Q8 ? (sl[e] * ls + sr[e] * rs) * scale : (sl[e] + sr[e]) * scale;
        const bool a = live && mask(ti, i, kk, tg);
        ok |= (uint32_t)a << e;
        sl[e] = a ? v : NEG_BIG;
        mx[i] = fmaxf(mx[i], sl[e]);
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
  // takes sl[8kk2 .. 8kk2 + 7] as registers {0,1}, {2,3}, {4,5}, {6,7};
  // pt[0] the high bf16 terms, pt[t] bf16 of what the terms before leave.
  // A masked key's p is 0 (not exp(NEG - NEG) = 1 on a row that has
  // attended nothing yet).
  uint32_t pt[PT][2][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float pv[4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 4 * j + 2 * i + c;
        const bool a = (ok >> e) & 1u;
        const float p = a ? __expf(sl[e] - m_new[i]) : 0.f;
        sum[i] += p;
        float pp = p;
        if constexpr (Q8) pp = a ? p * lss[8 * j + c0 + c] : 0.f;  // value-side dequant
        pv[2 * i + c] = pp;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float2 rest = make_float2(pv[2 * i], pv[2 * i + 1]);
#pragma unroll
      for (int t = 0; t < PT; ++t) {
        __nv_bfloat162 h = __floats2bfloat162_rn(rest.x, rest.y);
        pt[t][j >> 1][(j & 1) * 2 + i] = *reinterpret_cast<uint32_t*>(&h);
        const float2 back = __bfloat1622float2(h);
        rest.x -= back.x;  // exact: what bf16 rounding left
        rest.y -= back.y;
      }
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
  for (int j = 0; j < 32; ++j) {
    S_.o[4 * j + 0] *= alpha[0];
    S_.o[4 * j + 1] *= alpha[0];
    S_.o[4 * j + 2] *= alpha[1];
    S_.o[4 * j + 3] *= alpha[1];
  }
  tile::hold(S_.o);
  tile::wg_fence();
#pragma unroll
  for (int kk2 = 0; kk2 < BK / 16; ++kk2)
#pragma unroll
    for (int t = 0; t < PT; ++t) mma_o(S_.o, pt[t][kk2], desc_v(kt, w, kk2));
  tile::wg_commit();
  tile::wg_wait();
  tile::hold(S_.o);
}

// A segment of n keys in 32-key tiles: prep(i, kk) resolves key kk of
// tile i, mask(ti, i, kk, tag) masks. All 256 threads call it; the ring is
// empty and the tables free on entry and exit. Tile i + AHEAD is copied
// while tile i is multiplied, and tile i + AHEAD + 1 resolved while its S
// runs; an int8 segment also widens tile i + 1 then.
template <bool Q8, class Prep, class Mask>
__device__ __forceinline__ void run(const Smem& s, State& S_, int n, Prep prep, Mask mask,
                                    float scale) {
  if (n <= 0) return;
  constexpr int AHEAD = Q8 ? AHEAD8 : NST - 1;
  constexpr int NKV = Q8 ? 2 : NST;  // bf16 stages the products read
  const int ntiles = (n + BK - 1) / BK;
  for (int j = 0; j <= AHEAD && j < ntiles; ++j) resolve(s, j, n, prep);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < AHEAD; ++j) {
    if (j < ntiles) issue<Q8>(s, j);
    cp_commit();
  }
  if constexpr (Q8) {
    cp_wait<AHEAD - 1>();  // tile 0 (and the queries) landed
    __syncthreads();
    widen(s, 0, 0);
  }
  for (int i = 0; i < ntiles; ++i) {
    if (i + AHEAD < ntiles) issue<Q8>(s, i + AHEAD);
    cp_commit();
    if constexpr (!Q8) cp_wait<AHEAD>();  // tile i (and the queries) landed
    tile::fence_async();
    __syncthreads();
    step<Q8>(s, S_, i, i % NKV, i % NT, tile_keys(n, i), scale, mask, [&] {
      if (i + AHEAD + 1 < ntiles) resolve(s, i + AHEAD + 1, n, prep);
      if constexpr (Q8) {
        cp_wait<AHEAD - 1>();  // tile i + 1 landed
        __syncthreads();
        if (i + 1 < ntiles) widen(s, i + 1, (i + 1) % NKV);
      }
    });
    __syncthreads();  // the stage and the table slot are free again
  }
}

template <class T, bool PAGED>
__global__ void __launch_bounds__(THREADS, 1)
ragged_prefill_mla_kernel(const bf16* __restrict__ qt, const bf16* __restrict__ qr,
                          const bf16* __restrict__ cs, const bf16* __restrict__ krs, Past<T> c,
                          const int* __restrict__ rowids, const int* __restrict__ offsets,
                          const int* __restrict__ slots, const int* __restrict__ starts,
                          bf16* __restrict__ out, int layer, int T_, int R, int H, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const Smem s(smem_raw, qt);
  constexpr bool Q8 = sizeof(T) == 1;
  const int tid = threadIdx.x;
  // the last tile first: later tokens attend more keys (causal), so the
  // longest CTAs start first and the short ones fill the tail
  const int blk = gridDim.x - 1 - blockIdx.x;
  const int TQ = BQ / H;  // tokens a CTA
  const int t0 = blk * TQ;
  const size_t g0 = (size_t)blk * BQ;  // first (token, head) row
  const size_t TH = (size_t)T_ * H;
  // Q = [q̃ | qr], rows past the end zero-filled, as one copy group; the
  // first tile's wait covers it
#pragma unroll
  for (int i = 0; i < BQ * CH / THREADS; ++i) {
    const int ci = i * THREADS + tid;
    const int r = ci / CH;
    const int ch = ci % CH;
    const size_t g = g0 + r;
    const bf16* src = g >= TH ? nullptr
                      : ch < RL / 8 ? qt + g * RL + ch * 8
                                    : qr + g * DR + (ch - RL / 8) * 8;
    cp16(s.q() + swz(Q_ATOM, r, ch), src, s.any);
  }
  cp_commit();
  // this thread's query rows r0 and r0 + 8: packed token (-1: none) and
  // descriptor row (R: pad, -1: none)
  const int r0 = ((tid >> 5) & 3) * 16 + ((tid & 31) >> 2);
  int tok[2], rid[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = t0 + (r0 + 8 * i) / H;
    tok[i] = t < T_ ? t : -1;
    rid[i] = t < T_ ? rowids[t] : -1;
  }
  State st;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    st.m[i] = NEG_BIG;
    st.l[i] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < 128; ++j) st.o[j] = 0.f;

  const int t_last = min(t0 + TQ, T_) - 1;
  // (a) the cached prefix of every row with tokens in this tile
  for (int r = 0; r < R; ++r) {
    const int lo = offsets[r];
    const int hi = offsets[r + 1];
    const int start = min(starts[r], c.S);
    if (hi <= lo || lo > t_last || hi <= t0 || start <= 0) continue;
    const int srow = slots[r];
    run<Q8>(
        s, st, start,
        [&](int i, int kk) {
          const int pos = i * BK + kk;
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
          Key key{(pool ? c.plat : c.lat) + tk * RL, (pool ? c.prop : c.rop) + tk * DR, 1.f, 1.f,
                  r};
          if constexpr (Q8) {
            key.ls = __bfloat162float((pool ? c.pls : c.ls)[tk]);
            key.rs = __bfloat162float((pool ? c.prs : c.rs)[tk]);
          }
          return key;
        },
        [&](int, int i, int, int) { return rid[i] == r; }, scale);
  }
  // (b) the chunk's own keys: from the first row's start up to the tile's
  // last token, same row and packed index <= the query's
  const int rid0 = t0 < T_ ? rowids[t0] : R;
  const int u_lo = offsets[min(max(rid0, 0), R)];
  run<false>(
      s, st, t_last + 1 - u_lo,
      [&](int i, int kk) {
        const int u = u_lo + i * BK + kk;
        return Key{cs + (size_t)u * RL, krs + (size_t)u * DR, 1.f, 1.f, rowids[u]};
      },
      [&](int ti, int i, int kk, int tg) {
        return tok[i] >= u_lo + ti * BK + kk && tg == rid[i];
      },
      scale);

  cp_wait<0>();
  const int w = tid >> 7;
  const int c0 = 2 * (tid & 3);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (tok[i] < 0) continue;
    bf16* o = out + (g0 + r0 + 8 * i) * RL + 256 * w + c0;
    const float inv = st.l[i] > 0.f ? 1.f / st.l[i] : 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) =
          __floats2bfloat162_rn(st.o[4 * j + 2 * i] * inv, st.o[4 * j + 2 * i + 1] * inv);
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
  const int blocks = (int)(((size_t)T_ * H + BQ - 1) / BQ);
  if (blocks == 0) return (int)cudaSuccess;
  ragged_prefill_mla_kernel<T, PAGED><<<blocks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
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
