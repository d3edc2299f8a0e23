// Block-indirect KV addressing, shared by the paged attention kernels
// (the physical layout of `llm_mcp_tpu_torch/executor/physical.py`).
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

// Point kp/vp at the hd-long K and V vectors of key position `pos` of
// table row `trow`, for layer `layer` and KV head `h`. ck/cv are the arena
// [L, B, Hkv, S, hd].
__device__ __forceinline__ void paged_row(const PagedKV& pg, const bf16* ck, const bf16* cv,
                                          int layer, int B, int Hkv, int h, int S, int hd,
                                          int trow, int pos, const bf16*& kp,
                                          const bf16*& vp) {
  const int j = pos / pg.bt;
  const int t = pos - j * pg.bt;
  const int phys = pg.tbl[(size_t)trow * pg.nbs + j];
  const int pool_base = B * pg.nbs;
  if (phys < pool_base) {
    const int a = max(phys, 0);
    const size_t off = (((size_t)layer * B + a / pg.nbs) * Hkv + h) * (size_t)S * hd +
                       ((size_t)(a % pg.nbs) * pg.bt + t) * hd;
    kp = ck + off;
    vp = cv + off;
  } else {
    const int prow = min(phys - pool_base, pg.pxb - 1);
    const size_t off =
        (((size_t)layer * pg.pxb + prow) * Hkv + h) * (size_t)pg.bt * hd + (size_t)t * hd;
    kp = pg.pk + off;
    vp = pg.pv + off;
  }
}
