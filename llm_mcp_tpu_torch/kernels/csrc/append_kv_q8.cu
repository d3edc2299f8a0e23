// append_kv_q8: quantize one decode step's K/V, for every layer, and write
// it into the fused int8 cache in place.
//
// Replaces: llm_mcp_tpu/kernels/attention.py `_append_q8_kernel` together
// with the plain-JAX half of its wrapper `append_kv_q8`: the quantization
// (`models/llama.py:quantize_kv`), the concatenation of K and V heads, the
// scale packing (`models/quant.py:pack_scales`) and the aliased in-place
// tile rewrite. On the TPU the body only selects rows, because a store is a
// whole (sublane, lane) tile and the packing's bitcasts had no proven
// in-kernel form; here a CTA writes exactly the new bytes of its rows.
//
// It must write what JAX writes, bit for bit:
//   s = max|x| * (1/127 in f32)  (XLA compiles the jitted `amax / 127.0` to
//                                 this multiplication)
//   q = rint(x / max(s, 1e-30))  (IEEE division: this source is built
//                                 without --use_fast_math; rint rounds half
//                                 to even as jnp.round), 0 where s == 0
//   stored scale = round-to-nearest-even bf16 of that f32 s, and the packed
//   pseudo-head row holds those bf16 bits, little-endian, K scales then V
//   scales, then zero bytes up to head_dim.
//
// Bound on the H100: bytes. It reads 2*L*Ba*Hkv*hd bf16 and writes
// L*Ba*(Hf*hd + 2*Hkv*2) bytes, a few hundred KB a step. One CTA per
// (layer, batch row), one warp per head row: a lane holds 4 of the 128
// values, the warp reduces max|x|, and each lane writes its 4 int8 as one
// 32-bit store. Rows parked at w outside [0, S) write nothing.
//
// Layouts: cache q [L, B, Hf, S, hd] int8 (Hf = 2*Hkv + p), s [L, B, 2*Hkv, S]
// bf16; new_k/new_v [L, Ba, Hkv, hd] bf16; lengths/slot_ids [Ba] int32.
//
// The decode step does not launch it: each decode call writes its layer's
// rows itself (decode_attend.cu, `append`), with the same bytes.

#include "common.cuh"

namespace {

constexpr int HD = 128;
constexpr int THREADS = 256;
constexpr float INV127 = 1.0f / 127.0f;

__global__ void __launch_bounds__(THREADS)
append_kv_q8_kernel(int8_t* __restrict__ cq, bf16* __restrict__ cs,
                    const bf16* __restrict__ nk, const bf16* __restrict__ nv,
                    const int* __restrict__ lengths, const int* __restrict__ slot_ids, int B,
                    int Ba, int Hkv, int Hf, int S) {
  extern __shared__ unsigned short sbits[];  // [2*Hkv] the stored bf16 scales
  const int l = blockIdx.x;
  const int b = blockIdx.y;
  const int w = lengths[b];
  if (w < 0 || w >= S) return;  // parked row: no write
  const int row = slot_ids[b];
  const int Hs = 2 * Hkv;
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  for (int hh = wid; hh < Hs; hh += THREADS / 32) {
    const bf16* src = hh < Hkv ? nk + (((size_t)l * Ba + b) * Hkv + hh) * HD
                               : nv + (((size_t)l * Ba + b) * Hkv + hh - Hkv) * HD;
    float f[4];
    float amax = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      f[e] = __bfloat162float(src[lane * 4 + e]);
      amax = fmaxf(amax, fabsf(f[e]));
    }
    amax = warp_max(amax);
    const float s = amax * INV127;
    const float d = fmaxf(s, 1e-30f);
    unsigned packed = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qv = s > 0.f ? (int)rintf(__fdiv_rn(f[e], d)) : 0;
      packed |= ((unsigned)qv & 0xffu) << (8 * e);
    }
    const size_t base = ((size_t)l * B + row) * Hf + hh;
    *reinterpret_cast<unsigned*>(cq + (base * S + w) * HD + lane * 4) = packed;
    if (lane == 0) {
      const bf16 sb = __float2bfloat16_rn(s);
      cs[(((size_t)l * B + row) * Hs + hh) * S + w] = sb;
      sbits[hh] = __bfloat16_as_ushort(sb);
    }
  }
  if (Hf == Hs) return;  // no packed pseudo-head in this layout
  __syncthreads();
  int8_t* dst = cq + ((((size_t)l * B + row) * Hf + Hs) * S + w) * HD;
  for (int i = threadIdx.x; i < HD; i += THREADS) {
    const unsigned short bits = i < 2 * Hs ? sbits[i >> 1] : 0;
    dst[i] = (int8_t)((i & 1) ? (bits >> 8) : (bits & 0xff));
  }
}

}  // namespace

extern "C" int append_kv_q8(void* cq, void* cs, const void* nk, const void* nv,
                            const void* lengths, const void* slot_ids, int L, int B, int Ba,
                            int Hkv, int Hf, int S, void* stream) {
  const int Hs = 2 * Hkv;
  if (Hkv < 1 || (Hf != Hs && Hf != Hs + 1) || (Hf > Hs && 2 * Hs > HD))
    return (int)cudaErrorInvalidValue;
  append_kv_q8_kernel<<<dim3(L, Ba), THREADS, Hs * sizeof(unsigned short),
                        (cudaStream_t)stream>>>(
      (int8_t*)cq, (bf16*)cs, (const bf16*)nk, (const bf16*)nv, (const int*)lengths,
      (const int*)slot_ids, B, Ba, Hkv, Hf, S);
  return (int)cudaGetLastError();
}
