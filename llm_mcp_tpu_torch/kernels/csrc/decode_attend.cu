// decode_attend_bf16: one-position GQA decode attention over the
// PRE-append bf16 cache (flash-decoding).
//
// Replaces: llm_mcp_tpu/kernels/attention.py `_attend_bf16_kernel` (whole-S
// arm) and `_attend_bf16_blocked_kernel` (blocked arm), both behind
// `decode_attend_bf16`. The Pallas wrapper picks between the two arms at
// run time because a whole row may not fit VMEM; that split has no Hopper
// counterpart. This kernel reads only the attended prefix [0, w] of every
// row, whatever its length.
//
// Bound on the H100: bytes. Each row reads (w+1)*Hkv*hd values of K and of
// V once and does 4*G flops per value read (G = 4 for Llama-3.1-8B), far
// below the ~295 flops per byte where compute would bind. So the design has
// one job: keep enough bytes in flight and touch each of them once.
//
//   - One CTA (four warps) per (row, KV head, split of `chunk` keys of
//     [0, w]); splits past w exit at once. The G query heads of a KV head
//     share every key.
//   - K and V stay bf16. They reach shared memory through a ring of NST = 3
//     stages of SK = 32 keys (16 KB a stage, 48 KB a CTA), as 16-byte
//     `cp.async.cg` copies, one commit group a stage: two stages are in
//     flight while the third is consumed, and the copies hold no register.
//   - Each warp copies and consumes its own 8 keys of a stage, and a lane
//     reads back exactly the 16 bytes it copied: half-warp `half` takes
//     keys 2j + half, lane chunk c (16 lanes x 16 bytes cover one 256-byte
//     row). So the key loop needs `cp.async.wait_group` and `__syncwarp`,
//     and no block-wide barrier.
//   - A lane holds its 8 dims of the G scaled queries and of the G
//     accumulators in f32 registers, arrays of GM heads with G a run-time
//     argument: GM = 4 serves G <= 4 in about 128 registers, so four CTAs
//     fit an SM (registers, not the ring, set the occupancy: at GM = 8 it
//     is two). A score is 8 f32 products reduced over the half-warp with
//     shuffles. Each half-warp keeps its own online softmax (m, l) and
//     rescales once a stage. At the end of the split the two half-warps
//     merge through shuffles and the four warps through shared memory (the
//     ring, reused), and the CTA writes the split's (m, l, acc) partial.
//   - A second kernel combines the splits, a CTA per (row, KV head, query
//     head) with the splits spread over its threads, so its loads are in
//     flight together (a combine of one thread a dim walking every split of
//     every head in turn grows with S / chunk).
//   - A key past the split's end inside a stage copies nothing: its slot
//     is zero-filled (src-size 0), its score is NEG_BIG and its
//     probability exactly 0, so no stale value reaches a sum.
//
// Position w takes this step's exact new_k/new_v (the cache does not hold
// them yet): its copy reads them in place of the cache row. A row parked
// at w >= S attends its new vectors alone (w is clamped to 0) and reads no
// cache.
//
// Fused append (`append`, the pre-append arms): the CTA whose split holds
// w also writes head h's new K and V rows into the cache at (layer,
// slot_ids[b], h, w), the bytes `append_kv_bf16` (append_kv.cu, which
// replaces `_append_bf16_kernel`) would write for this layer after the
// step, with 16-byte stores once its own copies have landed. No CTA of the
// call reads position w from the cache (its score and value come from
// new_k/new_v), so the write races with nothing, and a decode step pays no
// launch, stack or copy for its append. A parked row writes nothing.
//
// Paged arm (`decode_attend_bf16_paged`). Replaces
// `_attend_bf16_paged_kernel` (same file), whose Pallas body streams each
// bt-token block with its own DMA, resolved through the row's block table
// to an arena home or a prefix-pool row. Here the kernel is the same with
// one change: a lane resolves each of its keys once a stage through
// tbl[row * nbs + p / bt] (paged.cuh), so any block size works (a stage
// may span blocks or sit inside one), and blocks may live in other slots'
// arena homes or in the pool. The override at w holds in whichever block w
// lives. The read is the same bytes as the contiguous arm plus one 4-byte
// table entry per key (L1-resident), so the bound is unchanged.
//
// Post-append arm (`decode_attention_bf16`). Replaces
// `_decode_attn_kernel` (behind `decode_attention`), the legacy whole-S
// decode body, which no served path calls: the cache already holds this
// step's K/V, so every key, position w included, comes from the cache
// [B, Hkv, S, hd] (no layer axis, rows are the batch). Its mask is
// inclusive, keys at pos <= lengths[b]: lengths[b] >= S attends all S, and
// lengths[b] < 0 masks every key with the finite -1e30, so JAX's softmax
// weighs all S keys alike and the row is the mean of V over S; here such a
// row attends all S with every score set to 0, the same average. There is
// no parked row. Bound: bytes, as the pre-append arm.
//
// head_dim 64 (Llama-3.2-1B at G = 4, Qwen2.5-0.5B at G = 7; the library
// decode_attend_hd64.cu, DECODE_HD 64): a row is 128 bytes, 8 lanes x 16
// bytes, so a warp reads four rows at once in four lane groups (lane group
// `half` takes keys 4j + half) and a score is reduced over 8 lanes. A
// stage holds SK = 64 keys, so it keeps the 128 arm's 16 KB and each lane
// group's 4 keys a stage (the registers of the 128 arm). At the end of the
// split the lane groups merge in two shuffle rounds (16 lanes apart, then
// 8); the CTA's 128 threads then write dims tid % 64 of heads tid / 64, +2,
// ..., and the combine runs 64 threads, one an output dim.
//
// Layouts: q [Ba, Hkv, G, hd]; new_k/new_v [Ba, Hkv, hd];
// cache [L, B, Hkv, S, hd]; lengths/slot_ids [Ba] int32; out like q;
// paged: tbl [B, nbs] int32, pool [L, PXB, Hkv, bt, hd]. The int8 arms
// (decode_attend.cuh, after the bf16 ones) read the fused cache {q [L, B,
// 2*Hkv + p, S, hd] int8, s [L, B, 2*Hkv, S] bf16} and its pool {[L, PXB,
// 2*Hkv + p, bt, hd], [L, PXB, 2*Hkv, bt]}.
//
// The kernels live in decode_attend.cuh. This library is the head_dim-128
// arm; decode_attend_hd64.cu is the same kernels built for 64.

#include "decode_attend.cuh"

extern "C" int decode_attend_bf16(const void* q, const void* nk, const void* nv,
                                  const void* ck, const void* cv,
                                  const void* lengths, const void* slot_ids,
                                  void* pm, void* pl, void* pacc, void* out,
                                  int layer, int B, int Ba, int Hkv, int G,
                                  int S, int hd, int chunk, int nsplit,
                                  float scale, int append, void* stream) {
  return launch<false>(q, nk, nv, ck, cv, lengths, slot_ids, pm, pl, pacc, out, layer, B,
                       Ba, Hkv, G, S, hd, chunk, nsplit, scale, PagedKV{}, append != 0, stream);
}

extern "C" int decode_attention_bf16(const void* q, const void* ck, const void* cv,
                                     const void* lengths, void* pm, void* pl, void* pacc,
                                     void* out, int B, int Hkv, int G, int S, int hd, int chunk,
                                     int nsplit, float scale, void* stream) {
  return launch<false, true>(q, q, q, ck, cv, lengths, nullptr, pm, pl, pacc, out,
                             0, B, B, Hkv, G, S, hd, chunk, nsplit, scale, PagedKV{}, false,
                             stream);
}

extern "C" int decode_attend_bf16_paged(const void* q, const void* nk, const void* nv,
                                        const void* ck, const void* cv,
                                        const void* lengths, const void* slot_ids,
                                        const void* tbl, const void* pool_k,
                                        const void* pool_v, void* pm, void* pl,
                                        void* pacc, void* out, int layer, int B, int Ba,
                                        int Hkv, int G, int S, int hd, int chunk,
                                        int nsplit, int nbs, int bt, int pxb,
                                        float scale, int append, void* stream) {
  if (nbs <= 0 || bt <= 0 || nbs * bt != S || pxb <= 0) return (int)cudaErrorInvalidValue;
  const PagedKV pg{(const int*)tbl, (const bf16*)pool_k, (const bf16*)pool_v, nbs, bt, pxb};
  return launch<true>(q, nk, nv, ck, cv, lengths, slot_ids, pm, pl, pacc, out, layer, B,
                      Ba, Hkv, G, S, hd, chunk, nsplit, scale, pg, append != 0, stream);
}

// rs: the whole-row arm's workspace, f32 [Ba, Hkv, nsplit, G, 2] (else
// null); append: write this step's K/V row into cq/cs (the fused append)
extern "C" int decode_attend_q8(const void* q, const void* nk, const void* nv,
                                void* cq, void* cs, const void* lengths,
                                const void* slot_ids, void* pm, void* pl, void* pacc,
                                void* out, int layer, int B, int Ba, int Hkv, int Hf, int G,
                                int S, int hd, int chunk, int nsplit, int group, float scale,
                                void* rs, int append, void* stream) {
  const FusedQ8 c{(const int8_t*)cq, (const bf16*)cs, nullptr, nullptr, nullptr,
                  B, Hf, 2 * Hkv, S, hd, 0, 0, 0};
  const Q8Append ap{append ? (int8_t*)cq : nullptr, append ? (bf16*)cs : nullptr};
  return launch_q8<false>(q, nk, nv, c, lengths, slot_ids, pm, pl, pacc, out, layer, Ba, Hkv,
                          G, hd, chunk, nsplit, group, scale, (float*)rs, ap, stream);
}

extern "C" int decode_attend_q8_paged(const void* q, const void* nk, const void* nv,
                                      void* cq, void* cs, const void* lengths,
                                      const void* slot_ids, const void* tbl,
                                      const void* pool_q, const void* pool_s, void* pm,
                                      void* pl, void* pacc, void* out, int layer, int B,
                                      int Ba, int Hkv, int Hf, int G, int S, int hd,
                                      int chunk, int nsplit, int nbs, int bt, int pxb,
                                      float scale, int append, void* stream) {
  if (nbs <= 0 || bt <= 0 || nbs * bt != S || pxb <= 0) return (int)cudaErrorInvalidValue;
  const FusedQ8 c{(const int8_t*)cq, (const bf16*)cs, (const int*)tbl, (const int8_t*)pool_q,
                  (const bf16*)pool_s, B, Hf, 2 * Hkv, S, hd, nbs, bt, pxb};
  // the append writes the arena row (the slot's own home), as append_kv_q8
  const Q8Append ap{append ? (int8_t*)cq : nullptr, append ? (bf16*)cs : nullptr};
  // the paged arm requantizes per block, as `_attend_q8_paged_kernel`
  return launch_q8<true>(q, nk, nv, c, lengths, slot_ids, pm, pl, pacc, out, layer, Ba, Hkv,
                         G, hd, chunk, nsplit, bt, scale, nullptr, ap, stream);
}
