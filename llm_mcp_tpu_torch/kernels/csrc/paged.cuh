// Block-indirect KV addressing, shared by the paged attention kernels
// (the physical layout of `llm_mcp_tpu_torch/executor/physical.py`), and
// the addressing of the fused int8 cache, paged or not.
//
// A table row holds nbs physical block ids, one per bt-token block of a
// row's sequence. An id below pool_base = B * nbs is an arena home: block
// (id % nbs) of cache row (id / nbs), which may be another slot's row. An
// id at or above pool_base is row (id - pool_base) of the prefix pool.
// Out-of-range ids are clamped as `paged_gather`'s plain version clamps
// them, so a kernel and its plain version agree on every table.
//
// Offsets are computed in size_t: an [L, B, Hkv, S, hd] arena passes 2^31
// elements at 16 slots of Llama-3.1-8B at S = 4096.

#pragma once

#include "common.cuh"

struct PagedKV {
  const int* tbl;  // table rows, nbs ids each
  const bf16* pk;  // prefix pool K [L, pxb, Hkv, bt, hd]
  const bf16* pv;  // prefix pool V
  int nbs;         // blocks per row (S / bt)
  int bt;          // tokens per block
  int pxb;         // pool rows
};

// Where key position `pos` of table row `trow` lives: arena row `row` at
// token `t` of its S, or (pool) pool row `row` at token `t` of its bt.
struct KeyHome {
  bool pool;
  int row;
  int t;
};

__device__ __forceinline__ KeyHome paged_home(const int* tbl, int nbs, int bt, int pxb, int B,
                                              int trow, int pos) {
  const int j = pos / bt;
  const int t = pos - j * bt;
  const int phys = tbl[(size_t)trow * nbs + j];
  const int pool_base = B * nbs;
  if (phys < pool_base) {
    const int a = max(phys, 0);
    return {false, a / nbs, (a % nbs) * bt + t};
  }
  return {true, min(phys - pool_base, pxb - 1), t};
}

// Point kp/vp at the hd-long K and V vectors of key position `pos` of
// table row `trow`, for layer `layer` and KV head `h`. ck/cv are the arena
// [L, B, Hkv, S, hd].
__device__ __forceinline__ void paged_row(const PagedKV& pg, const bf16* ck, const bf16* cv,
                                          int layer, int B, int Hkv, int h, int S, int hd,
                                          int trow, int pos, const bf16*& kp,
                                          const bf16*& vp) {
  const KeyHome k = paged_home(pg.tbl, pg.nbs, pg.bt, pg.pxb, B, trow, pos);
  const size_t off = k.pool ? (((size_t)layer * pg.pxb + k.row) * Hkv + h) * (size_t)pg.bt * hd +
                                  (size_t)k.t * hd
                            : (((size_t)layer * B + k.row) * Hkv + h) * (size_t)S * hd +
                                  (size_t)k.t * hd;
  kp = (k.pool ? pg.pk : ck) + off;
  vp = (k.pool ? pg.pv : cv) + off;
}

// The fused int8 cache (models/llama.py:init_kv_cache(quantized=True)) and,
// for the paged kernels, its prefix pool and tables. Payload heads
// [0, Hkv) are K, [Hkv, 2*Hkv) V, head 2*Hkv (when Hf = 2*Hkv + 1) the
// position's 2*Hkv bf16 scales bit-packed little-endian; "s" holds the same
// scales as plain [L, rows, 2*Hkv, tokens].
struct FusedQ8 {
  const int8_t* q;   // arena payload [L, B, Hf, S, hd]
  const bf16* s;     // arena scales [L, B, 2*Hkv, S]
  const int* tbl;    // paged: table rows, nbs ids each
  const int8_t* pq;  // paged: pool payload [L, pxb, Hf, bt, hd]
  const bf16* ps;    // paged: pool scales [L, pxb, 2*Hkv, bt]
  int B, Hf, Hs, S, hd;
  int nbs, bt, pxb;  // paged only
};

template <bool PAGED>
__device__ __forceinline__ KeyHome q8_home(const FusedQ8& c, int trow, int pos) {
  if constexpr (PAGED) return paged_home(c.tbl, c.nbs, c.bt, c.pxb, c.B, trow, pos);
  return {false, trow, pos};
}

// The hd int8 values of payload head `head` at a key's home, layer `layer`.
__device__ __forceinline__ const int8_t* q8_payload(const FusedQ8& c, const KeyHome& k,
                                                    int layer, int head) {
  if (k.pool)
    return c.pq + ((((size_t)layer * c.pxb + k.row) * c.Hf + head) * c.bt + k.t) * c.hd;
  return c.q + ((((size_t)layer * c.B + k.row) * c.Hf + head) * c.S + k.t) * c.hd;
}

// Where the plain scale of head `head` (0 <= head < 2*Hkv) at a key's home
// lives; the next keys of its block follow.
__device__ __forceinline__ const bf16* q8_scale_ptr(const FusedQ8& c, const KeyHome& k,
                                                    int layer, int head) {
  if (k.pool) return c.ps + (((size_t)layer * c.pxb + k.row) * c.Hs + head) * c.bt + k.t;
  return c.s + (((size_t)layer * c.B + k.row) * c.Hs + head) * c.S + k.t;
}

// Plain scale of head `head` (0 <= head < 2*Hkv) at a key's home.
__device__ __forceinline__ float q8_scale(const FusedQ8& c, const KeyHome& k, int layer,
                                          int head) {
  return __bfloat162float(*q8_scale_ptr(c, k, layer, head));
}
