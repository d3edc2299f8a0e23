// append_kv_bf16: write one decode step's K/V, for every layer, into the
// bf16 cache in place.
//
// Replaces: llm_mcp_tpu/kernels/attention.py `_append_bf16_kernel` (behind
// `append_kv_bf16`). The Pallas kernel rewrites the 16-row tile that holds
// position w, because a TPU store works on whole (sublane, lane) tiles;
// here a store is 16 bytes, so the kernel writes exactly the new rows.
//
// Bound on the H100: bytes. It reads L*Ba*Hkv*hd values of each of K and V
// and writes as many; there is no arithmetic. One CTA per (layer, batch
// row) copies that row's Hkv*hd values with 16-byte loads and stores, so
// every access is a full, aligned vector. Rows parked at w >= S (the
// engine's convention for free slots) write nothing.
//
// Layouts: cache [L, B, Hkv, S, hd]; new_k/new_v [L, Ba, Hkv, hd];
// lengths/slot_ids [Ba] int32.
//
// The decode step does not launch it: each decode call writes its layer's
// rows itself (decode_attend.cu, `append`), with the same bytes.

#include "common.cuh"

__global__ void append_kv_kernel(bf16* __restrict__ ck, bf16* __restrict__ cv,
                                 const bf16* __restrict__ nk,
                                 const bf16* __restrict__ nv,
                                 const int* __restrict__ lengths,
                                 const int* __restrict__ slot_ids, int B, int Ba,
                                 int Hkv, int S, int hd) {
  const int l = blockIdx.x;
  const int b = blockIdx.y;
  const int w = lengths[b];
  if (w < 0 || w >= S) return;  // parked row: no write
  const int row = slot_ids[b];
  const int per_head = hd / 8;  // 16-byte chunks per head row
  const int n = Hkv * per_head;
  const uint4* srck =
      reinterpret_cast<const uint4*>(nk + ((size_t)l * Ba + b) * Hkv * hd);
  const uint4* srcv =
      reinterpret_cast<const uint4*>(nv + ((size_t)l * Ba + b) * Hkv * hd);
  uint4* dk = reinterpret_cast<uint4*>(ck);
  uint4* dv = reinterpret_cast<uint4*>(cv);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int h = i / per_head;
    const int c = i % per_head;
    const size_t dst =
        ((((size_t)l * B + row) * Hkv + h) * S + w) * per_head + c;
    dk[dst] = srck[i];
    dv[dst] = srcv[i];
  }
}

extern "C" int append_kv_bf16(void* ck, void* cv, const void* nk, const void* nv,
                              const void* lengths, const void* slot_ids, int L,
                              int B, int Ba, int Hkv, int S, int hd,
                              void* stream) {
  dim3 grid(L, Ba);
  append_kv_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
      (bf16*)ck, (bf16*)cv, (const bf16*)nk, (const bf16*)nv,
      (const int*)lengths, (const int*)slot_ids, B, Ba, Hkv, S, hd);
  return (int)cudaGetLastError();
}
