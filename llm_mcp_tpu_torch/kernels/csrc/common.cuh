// Helpers shared by the port's attention kernels (sm_90a, plain C ABI).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

// Large finite negative used for masked scores: exp(NEG - m) underflows to
// 0 without the inf - inf = NaN of a true -inf (the Pallas kernels use the
// same -1e30).
#define NEG_BIG (-1e30f)

// 8 consecutive bf16 values (16 bytes) as floats. `p` must be 16-byte
// aligned: every row the kernels read starts at a multiple of head_dim
// elements, and head_dim is a multiple of 8.
__device__ __forceinline__ void load8(const bf16* p, float* out) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h2[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Reductions over the 16 lanes of a half-warp (the lanes that share a row
// in the prefill tile).
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// -- cp.async: 16-byte copies global -> shared that bypass the registers ------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when `src` is nullptr
// (`fallback`, a global address, is then read by no one).
__device__ __forceinline__ void cp16(void* dst, const void* src, const void* fallback) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src != nullptr ? src : fallback), "r"(src != nullptr ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// -- int8 tensor-core helpers (mma.sync m16n8k32 s8, m16n8k16 bf16) -------

__device__ __forceinline__ unsigned ld32(const void* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ unsigned short ld16(const void* p) {
  return *reinterpret_cast<const unsigned short*>(p);
}

// four 8 x 8 b16 tiles of shared memory, lane i giving the address of row
// i % 8 of tile i / 8: the A fragment of m16n8k32 s8 (a0..a3) in one
// instruction
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// two int8 (low byte first) as a bf16x2 register, exactly
__device__ __forceinline__ unsigned i8x2_bf16x2(unsigned short v) {
  const __nv_bfloat162 h =
      __floats2bfloat162_rn((float)(int8_t)(v & 0xff), (float)(int8_t)(v >> 8));
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the 4 x 4 byte transpose: out[e] byte i = in[i] byte e. s8 mma.sync takes
// its operands only K-major, so an int8 tile stored with the keys (its K)
// outermost, as V and the MLA latents are, is transposed in registers:
// four keys' words of one column quad in, four columns' words of four
// keys out.
__device__ __forceinline__ void transpose4(const unsigned (&w)[4], unsigned (&o)[4]) {
  const unsigned a_lo = __byte_perm(w[0], w[1], 0x5140), a_hi = __byte_perm(w[0], w[1], 0x7362);
  const unsigned b_lo = __byte_perm(w[2], w[3], 0x5140), b_hi = __byte_perm(w[2], w[3], 0x7362);
  o[0] = __byte_perm(a_lo, b_lo, 0x5410);
  o[1] = __byte_perm(a_lo, b_lo, 0x7632);
  o[2] = __byte_perm(a_hi, b_hi, 0x5410);
  o[3] = __byte_perm(a_hi, b_hi, 0x7632);
}
