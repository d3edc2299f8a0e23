// flash_prefill_attention at head_dim 256 (Gemma-2-9B: 16 query heads over
// 8 KV heads, a 4096-token window on alternate layers, score softcap 50,
// scale 224**-0.5): a kernel of its own for Hopper (sm_90a).
//
// Replaces: llm_mcp_tpu/kernels/attention.py `_flash_prefill_kernel`, which
// JAX runs at any head_dim that is a multiple of 128 (`pallas_supported`):
// causal, length- and window-masked GQA attention (KV head h / G), the
// scores scaled, then softcapped (tanh(s / cap) * cap), then masked; a row
// that sees no key emits 0.
//
// Bound on the H100: operations. Each query row meets its keys in two
// products of 256-deep rows (S = Q.K^T, O += P.V); at an 8192-token prompt
// that is about 0.4 ms of the bf16 tensor-core peak, against 64 MB of q, k
// and v to read. The design keeps the tensor cores fed:
//
//   - A CTA is three warpgroups (384 threads). Warpgroups 0 and 1 consume:
//     each owns 64 query rows and all 256 output columns (O is 64 x 256 f32,
//     128 registers a thread), so each query row's Q.K^T is computed once.
//     With G = H / Hkv even (Gemma-2: 2) the two are heads 2j and 2j + 1 of
//     one KV head at the same 64 positions: they share every K/V tile and
//     every mask. With G odd they are one head at two consecutive 64-row
//     tiles; the CTA then walks the union of their key ranges and a tile
//     outside one consumer's range masks to nothing there.
//   - Warpgroup 2 produces: one thread keeps K and V tiles (64 keys x 256
//     columns, 32 KB each) in flight by TMA into a ring of two stages,
//     with a full and an empty mbarrier for each K and each V stage; Q (both
//     consumers' 32 KB tiles) arrives once on its own barrier. TMA writes
//     the 128-byte swizzled layout `wgmma` reads (boxes of 64 columns x 64
//     rows, four a tile) and zero-fills rows past S. `setmaxnreg` gives the
//     producer 24 registers a thread and the consumers 240.
//   - The consumers take turns on two named barriers: a warpgroup issues its
//     Q.K^T only in its turn and hands the turn on once it is issued, so
//     one warpgroup's softmax runs while the other's products occupy the
//     tensor cores.
//   - The grid is 1-D with the query tile slowest and descending: the tiles
//     that see the most keys start first. Under a window a tile walks only
//     the key tiles the window reaches.
//   - S = Q.K^T is m64n64k16 x 16 (Q and the key tile from shared memory);
//     O += P.V is m64n256k16 x 4, the value tile read MN-major. P.V takes p
//     as two bf16 terms, hi = bf16(p) and lo = bf16(p - hi) (8 products a
//     tile, not 4): p rounded once (2^-9 relative) misses |err| <= 1e-3 +
//     1e-2*|ref| on rows that attend a few keys and whose output cancels.
//     l sums the f32 probabilities. Interior tiles (every key visible to
//     every row) skip the masks.
//   - Registers bound the consumer: O takes 128 of its 240, the scores 32,
//     and it compiles to 236 with no spill. The two p terms as P.V's A
//     operand in registers would take 32 more, so each term goes to shared
//     memory as soon as it is made (`stmatrix`, in the swizzled layout of a
//     K-major operand) and P.V reads both operands there. A `__trap` in
//     any wait loop (a guard against a lost arrival) made ptxas allocate
//     the consumers within the launch's 168 registers instead, spill and
//     serialize the products: the waits have no such guard.
//
// Shared memory: Q 2 x 32 KB + two stages of K and V 128 KB + the p terms
// 32 KB + the barriers: SMEM_BYTES, one CTA an SM.

#include <cuda.h>

#include "common.cuh"

namespace {

constexpr int HD = 256;
constexpr int BQ = 64;                    // query rows a consumer warpgroup owns
constexpr int BK = 64;                    // keys a tile
constexpr int NST = 2;                    // stages of the K and V rings
constexpr int THREADS = 384;  // two consumer warpgroups + the producer
constexpr int BOX_BYTES = 64 * 128;       // one TMA box: 64 rows x 64 bf16 columns
constexpr int TILE_BYTES = 4 * BOX_BYTES; // 64 rows x 256 columns
constexpr int Q_OFF = 0;                  // consumer w's queries at + w tiles
constexpr int K_OFF = 2 * TILE_BYTES;     // stage s at + s tiles
constexpr int V_OFF = K_OFF + NST * TILE_BYTES;
constexpr int P_OFF = V_OFF + NST * TILE_BYTES;  // consumer w's term t (hi 0, lo 1) at + (2w + t) boxes
constexpr int BAR_OFF = P_OFF + 4 * BOX_BYTES;
constexpr int NBAR = 1 + 4 * NST;  // q_full, k_full[NST], v_full[NST], k_empty[NST], v_empty[NST]
constexpr int SMEM_BYTES = 230472;
static_assert(SMEM_BYTES == BAR_OFF + 8 * NBAR + 1024, "the layout plus 1024-byte alignment slack");
static_assert(SMEM_BYTES <= 232448, "the H100's shared memory a block");
constexpr int TURN = 1;     // named barriers TURN + w: consumer w's turn at the tensor cores
constexpr int P_READY = 3;  // named barriers P_READY + w: consumer w's p terms written
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t q_full(uint32_t bars) { return bars; }
__device__ __forceinline__ uint32_t k_full(uint32_t bars, int s) { return bars + 8 * (1 + s); }
__device__ __forceinline__ uint32_t v_full(uint32_t bars, int s) { return bars + 8 * (1 + NST + s); }
__device__ __forceinline__ uint32_t k_empty(uint32_t bars, int s) { return bars + 8 * (1 + 2 * NST + s); }
__device__ __forceinline__ uint32_t v_empty(uint32_t bars, int s) { return bars + 8 * (1 + 3 * NST + s); }

// -- mbarriers, TMA and named barriers ----------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// arrive and expect `bytes` of TMA writes before the phase completes
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed. (No trap after a
// bound on the polls: a trap block behind the consumers' loop makes ptxas
// allocate them within the launch's 168 registers, not setmaxnreg's 240,
// and then spill and serialize the products.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one 64 x 64 box of a [planes][S][256] bf16 tensor: columns c, rows r,
// plane p; rows past S arrive as zeros
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c,
                                        int r, int p) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(r), "r"(p)
      : "memory");
}

// a 64-row x 256-column tile: four boxes
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar, int r,
                                         int p) {
#pragma unroll
  for (int j = 0; j < 4; ++j) tma_box(dst + j * BOX_BYTES, map, bar, 64 * j, r, p);
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// the 128 threads of one warpgroup
__device__ __forceinline__ void bar_sync_wg(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// four 8 x 8 bf16 matrices to shared memory, lane i giving the address of
// row i % 8 of matrix i / 8; register m holds this lane's pair of matrix m
// in the mma fragment layout (row lane / 4, columns 2(lane % 4) + {0, 1})
__device__ __forceinline__ void stsm_x4(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// make this thread's shared-memory writes visible to wgmma (async proxy)
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// -- wgmma ----------------------------------------------------------------------

// Descriptor of a 128-byte-swizzled operand at shared address `a`
// (1024-aligned atoms): lbo/sbo in bytes.
__device__ __forceinline__ uint64_t desc(uint32_t a, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)1 << 62);
}

// K-major operand (a Q or K tile): k-step kk covers columns 16kk..16kk+15,
// in box kk / 4; 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_k(uint32_t t, int kk) {
  return desc(t + (kk >> 2) * BOX_BYTES + (kk & 3) * 32, 16, 1024);
}

// MN-major B operand (a V tile [keys][256]): k-step kk covers keys
// 16kk..16kk+15 of all four 64-column boxes (BOX_BYTES apart); 8-key
// groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_v(uint32_t t, int kk) {
  return desc(t + kk * 16 * 128, BOX_BYTES, 1024);
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

// S = Q.K^T over 64 keys: m64n64k16; the first k-step writes d, the others
// add to it
__device__ __forceinline__ void mma_qk_first(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

__device__ __forceinline__ void mma_qk(float (&d)[32], uint64_t da, uint64_t db) {
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
      : "l"(da), "l"(db), "r"(1));
}

// O += P.V over all 256 columns: m64n256k16, a p term (K-major) and V
// (MN-major) from shared memory
__device__ __forceinline__ void mma_pv(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(1));
}

// -- the kernel -------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS, 1)
flash_prefill_hd256_kernel(__grid_constant__ const CUtensorMap tq,
                           __grid_constant__ const CUtensorMap tk,
                           __grid_constant__ const CUtensorMap tv, const int* __restrict__ lengths,
                           bf16* __restrict__ out, int B, int H, int Hkv, int S, int window,
                           float softcap, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(sm);
  const uint32_t bars = base + BAR_OFF;

  // The CTA's two (head, first query row) items, consumer 0's and 1's.
  const int G = H / Hkv;
  const int nq = (S + BQ - 1) / BQ;
  int b, h0, h1, qa, qb;
  if (G % 2 == 0) {  // heads 2j, 2j + 1 of one KV head, one query tile
    const int fast = B * (H / 2);
    const int qt = nq - 1 - (int)blockIdx.x / fast;
    const int r = (int)blockIdx.x % fast;
    b = r / (H / 2);
    h0 = 2 * (r % (H / 2));
    h1 = h0 + 1;
    qa = qb = qt * BQ;
  } else {  // one head, query tiles 2t and 2t + 1
    const int fast = B * H;
    const int qt = (nq + 1) / 2 - 1 - (int)blockIdx.x / fast;
    const int r = (int)blockIdx.x % fast;
    b = r / H;
    h0 = h1 = r % H;
    qa = 2 * qt * BQ;
    qb = qa + BQ;
  }
  const int hk = h0 / G;
  const int len = lengths[b];
  // keys the CTA walks: the union of the two items' [kmin, kmax]
  int kmin = S, kmax = -1;
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    const int q0 = w ? qb : qa;
    if (q0 >= S) continue;
    kmax = max(kmax, min(min(q0 + BQ - 1, len - 1), S - 1));
    kmin = min(kmin, window > 0 ? max(0, q0 - window + 1) : 0);
  }
  const int kstart = (kmin / BK) * BK;
  const int ntiles = kmax >= kstart ? (kmax - kstart) / BK + 1 : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full(bars), 1);
#pragma unroll
    for (int s = 0; s < NST; ++s) {
      mbar_init(k_full(bars, s), 1);
      mbar_init(v_full(bars, s), 1);
      mbar_init(k_empty(bars, s), 8);  // lane 0 of each consumer warp
      mbar_init(v_empty(bars, s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, broadcast from lane 0 so that the compiler knows it is
  // the same across a warp (its values then live in uniform registers)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  if (wg == 2) {
    // -- the producer: one thread issues every copy --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x != 256 || ntiles == 0) return;
    mbar_expect(q_full(bars), 2 * TILE_BYTES);
    tma_tile(base + Q_OFF, &tq, q_full(bars), qa, b * H + h0);
    tma_tile(base + Q_OFF + TILE_BYTES, &tq, q_full(bars), qb, b * H + h1);
    const int plane = b * Hkv + hk;
    for (int i = 0; i < ntiles; ++i) {
      const int s = i & (NST - 1);
      const uint32_t ph = (i / NST) & 1;
      const int key = kstart + i * BK;
      mbar_wait(k_empty(bars, s), ph ^ 1);
      mbar_expect(k_full(bars, s), TILE_BYTES);
      tma_tile(base + K_OFF + s * TILE_BYTES, &tk, k_full(bars, s), key, plane);
      mbar_wait(v_empty(bars, s), ph ^ 1);
      mbar_expect(v_full(bars, s), TILE_BYTES);
      tma_tile(base + V_OFF + s * TILE_BYTES, &tv, v_full(bars, s), key, plane);
    }
    return;
  }

  // -- a consumer: 64 query rows of head hw from row qw, all 256 columns --
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int hw = wg ? h1 : h0;
  const int qw = wg ? qb : qa;
  // A thread holds rows r0 and r0 + 8 of the tile and columns 8j + c0 +
  // {0, 1} of each 8-column block (the wgmma accumulator layout, S's and
  // O's alike): r0(), c0() from the thread index where they are needed, so
  // that no register holds them across the loop (registers bound it).
  const auto r0 = [] { return ((threadIdx.x & 127) >> 5) * 16 + ((threadIdx.x & 31) >> 2); };
  const auto c0 = [] { return 2 * (threadIdx.x & 3); };
  const uint32_t qt = base + Q_OFF + wg * TILE_BYTES;
  const uint32_t pt = base + P_OFF + 2 * wg * BOX_BYTES;  // this consumer's hi term; lo after it
  // the scores are scaled once: by scale / softcap before tanh, or by scale
  const float s_in = softcap > 0.f ? scale / softcap : scale;
  float o[128];
#pragma unroll
  for (int j = 0; j < 128; ++j) o[j] = 0.f;
  float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.f, 0.f};

  if (ntiles > 0) {
    mbar_wait(q_full(bars), 0);
    if (wg == 1) bar_arrive(TURN);  // consumer 0 takes the first turn
  }
  for (int i = 0; i < ntiles; ++i) {
    const int s = i & (NST - 1);
    const uint32_t ph = (i / NST) & 1;
    const int kt0 = kstart + i * BK;
    const uint32_t kt = base + K_OFF + s * TILE_BYTES;
    const uint32_t vt = base + V_OFF + s * TILE_BYTES;
    float sc[BK / 2];
    mbar_wait(k_full(bars, s), ph);
    bar_sync(TURN + wg);
    wg_fence();
    mma_qk_first(sc, desc_k(qt, 0), desc_k(kt, 0));
#pragma unroll
    for (int kk = 1; kk < HD / 16; ++kk) mma_qk(sc, desc_k(qt, kk), desc_k(kt, kk));
    wg_commit();
    // hand the turn on (consumer 1's last turn has no successor)
    if (wg == 0 || i + 1 < ntiles) bar_arrive(TURN + (wg ^ 1));
    wg_wait();
    hold(sc);
    if ((threadIdx.x & 31) == 0) mbar_arrive(k_empty(bars, s));  // Q.K^T has read K of stage s

    // scale, softcap, masks
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      float v = sc[e] * s_in;
      if (softcap > 0.f) v = tanhf(v) * softcap;
      sc[e] = v;
    }
    const bool interior = kt0 + BK - 1 <= qw && kt0 + BK - 1 < len &&
                          (window <= 0 || qw + BQ - 1 - kt0 < window);
    uint32_t ok = 0xffffffffu;
    if (!interior) {
      ok = 0;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kp = kt0 + 8 * j + c0() + c;
#pragma unroll
          for (int i2 = 0; i2 < 2; ++i2) {
            const int e = 4 * j + 2 * i2 + c;
            const int qp = qw + r0() + 8 * i2;
            const bool a = kp <= qp && kp < len && (window <= 0 || qp - kp < window);
            ok |= (uint32_t)a << e;
            if (!a) sc[e] = NEG_BIG;
          }
        }
      }
    }
    float mx[2] = {NEG_BIG, NEG_BIG};
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
    float alpha[2], mb[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      mx[i2] = fmaxf(mx[i2], __shfl_xor_sync(0xffffffffu, mx[i2], 1));
      mx[i2] = fmaxf(mx[i2], __shfl_xor_sync(0xffffffffu, mx[i2], 2));
      const float m_new = fmaxf(m[i2], mx[i2]);
      alpha[i2] = ex2((m[i2] - m_new) * LOG2E);
      mb[i2] = m_new * LOG2E;
      m[i2] = m_new;
      l[i2] *= alpha[i2];
    }
    // O, ahead of this tile's P.V (the last one has completed)
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      o[4 * j + 0] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
    // probabilities as bf16 pairs in the A layout of P.V, k-step by k-step:
    // sc[8kk2 .. 8kk2 + 7] make registers {0,1}, {2,3}, {4,5}, {6,7} of the
    // hi term and of the lo term, stored at once
#pragma unroll
    for (int kk2 = 0; kk2 < BK / 16; ++kk2) {
      uint32_t hi4[4], lo4[4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * kk2 + jj;
#pragma unroll
        for (int i2 = 0; i2 < 2; ++i2) {
          float pv[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 4 * j + 2 * i2 + c;
            const float p = (ok >> e) & 1u ? ex2(fmaf(sc[e], LOG2E, -mb[i2])) : 0.f;
            sum[i2] += p;
            pv[c] = p;
          }
          __nv_bfloat162 hi = __floats2bfloat162_rn(pv[0], pv[1]);
          const float2 back = __bfloat1622float2(hi);
          __nv_bfloat162 lo = __floats2bfloat162_rn(pv[0] - back.x, pv[1] - back.y);
          hi4[jj * 2 + i2] = *reinterpret_cast<uint32_t*>(&hi);
          lo4[jj * 2 + i2] = *reinterpret_cast<uint32_t*>(&lo);
        }
      }
      // stmatrix: lane gives row 8 (lane / 8 % 2) + lane % 8 of its warp's
      // 16 rows, 16-byte chunk 2 kk2 + lane / 16, 128-byte swizzled
      const uint32_t lane = threadIdx.x & 31;
      const uint32_t prow = ((threadIdx.x & 127) >> 5) * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
      const uint32_t at = pt + prow * 128 + (((2 * kk2 + (lane >> 4)) ^ (lane & 7)) << 4);
      stsm_x4(at, hi4);
      stsm_x4(at + BOX_BYTES, lo4);
    }
    fence_async();
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      sum[i2] += __shfl_xor_sync(0xffffffffu, sum[i2], 1);
      sum[i2] += __shfl_xor_sync(0xffffffffu, sum[i2], 2);
      l[i2] += sum[i2];
    }

    bar_sync_wg(P_READY + wg);  // every warp's p terms are written
    mbar_wait(v_full(bars, s), ph);
    hold(o);
    wg_fence();
#pragma unroll
    for (int kk2 = 0; kk2 < BK / 16; ++kk2) {
      mma_pv(o, desc_k(pt, kk2), desc_v(vt, kk2));
      mma_pv(o, desc_k(pt + BOX_BYTES, kk2), desc_v(vt, kk2));
    }
    wg_commit();
    wg_wait();  // P.V has read V of stage s
    hold(o);
    if ((threadIdx.x & 31) == 0) mbar_arrive(v_empty(bars, s));
  }

  // the normalized rows r0 and r0 + 8, all 256 columns
  bf16* obase = out + ((size_t)b * H + hw) * (size_t)S * HD;
#pragma unroll
  for (int i2 = 0; i2 < 2; ++i2) {
    const int row = qw + r0() + 8 * i2;
    if (row >= S) continue;
    const float inv = l[i2] > 0.f ? 1.f / l[i2] : 0.f;
    bf16* dst = obase + (size_t)row * HD + c0();
#pragma unroll
    for (int j = 0; j < 32; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * i2] * inv, o[4 * j + 2 * i2 + 1] * inv);
  }
}

// -- the launch ------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// a [planes][S][256] bf16 tensor in 64 x 64 boxes, 128-byte swizzled
bool tensor_map(CUtensorMap* map, const void* ptr, int S, int planes) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr || (reinterpret_cast<uintptr_t>(ptr) & 15) != 0) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)HD, (cuuint64_t)S, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)HD * 2, (cuuint64_t)S * HD * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t estride[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
            estride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" int flash_prefill_bf16_hd256(const void* q, const void* k, const void* v,
                                        const void* lengths, void* out, int B, int H,
                                        int Hkv, int S, int hd, int window,
                                        float softcap, float scale, void* stream) {
  if (hd != HD || B < 0 || S < 0 || Hkv < 1 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return (int)cudaSuccess;
  CUtensorMap mq, mk, mv;
  if (!tensor_map(&mq, q, S, B * H) || !tensor_map(&mk, k, S, B * Hkv) ||
      !tensor_map(&mv, v, S, B * Hkv))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(flash_prefill_hd256_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const int G = H / Hkv;
  const int nq = (S + BQ - 1) / BQ;
  const long long grid = G % 2 == 0 ? (long long)B * (H / 2) * nq : (long long)B * H * ((nq + 1) / 2);
  flash_prefill_hd256_kernel<<<(unsigned)grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      mq, mk, mv, (const int*)lengths, (bf16*)out, B, H, Hkv, S, window, softcap, scale);
  return (int)cudaGetLastError();
}
