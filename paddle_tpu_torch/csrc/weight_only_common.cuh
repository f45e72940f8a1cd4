// Code dequantization shared by the weight-only kernels (weight_only.cu's
// weight_only_mma_kernel, weight_only_gemm.cu's weight_only_gemm_kernel):
// int8 or fp8 (e4m3) codes to float, and 16 codes (or a pair) times their
// channel's scale rounded to bf16.  Both kernels round every weight here, so a
// prompt (the GEMM) and a decode tick (the narrow kernel) multiply by the
// same bf16 weights, those of the plain version (`dequantize(q, s)` in
// bf16, then the product).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace ptt {

// Four codes of a 32-bit word (lowest byte first) as floats.
template <int QT>
__device__ __forceinline__ void wo_codes4(uint32_t w, float* f);

template <>
__device__ __forceinline__ void wo_codes4<0>(uint32_t w, float* f) {
  // int8: 0x4B000000 | (b ^ 0x80) is the float 2^23 + b + 128, exactly
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
}

template <>
__device__ __forceinline__ void wo_codes4<1>(uint32_t w, float* f) {
  // fp8 e4m3: the hardware's pairwise conversion to half, exact
  const __half2 lo(__nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(w & 0xFFFFu), __NV_E4M3));
  const __half2 hi(__nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(w >> 16), __NV_E4M3));
  const float2 a = __half22float2(lo), b = __half22float2(hi);
  f[0] = a.x;
  f[1] = a.y;
  f[2] = b.x;
  f[3] = b.y;
}

// 16 codes -> 16 weights float(code) * s rounded to bf16, packed in pairs
// (the lower k in the low half, as mma.sync reads them).
template <int QT>
__device__ __forceinline__ void wo_dequant_bf16(const uint4& c, float s,
                                                uint32_t* b) {
  const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float f[4];
    wo_codes4<QT>(w[i], f);
    const __nv_bfloat162 p0 = __floats2bfloat162_rn(f[0] * s, f[1] * s);
    const __nv_bfloat162 p1 = __floats2bfloat162_rn(f[2] * s, f[3] * s);
    b[2 * i] = *reinterpret_cast<const uint32_t*>(&p0);
    b[2 * i + 1] = *reinterpret_cast<const uint32_t*>(&p1);
  }
}

// The two codes in bytes h, h + 1 of w (h 0 or 2) -> bf16(float(code) * s)
// packed, the lower byte in the low half: wo_dequant_bf16's rounding, one
// pair at a time (a register fragment's pair of k).
template <int QT>
__device__ __forceinline__ uint32_t wo_pair_bf16(uint32_t w, int h, float s);

template <>
__device__ __forceinline__ uint32_t wo_pair_bf16<0>(uint32_t w, int h,
                                                    float s) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + h)) - 8388736.f;
  const float f1 =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541 + h)) - 8388736.f;
  const __nv_bfloat162 p = __floats2bfloat162_rn(f0 * s, f1 * s);
  return *reinterpret_cast<const uint32_t*>(&p);
}

template <>
__device__ __forceinline__ uint32_t wo_pair_bf16<1>(uint32_t w, int h,
                                                    float s) {
  const __half2 v(__nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(w >> (8 * h)), __NV_E4M3));
  const float2 f = __half22float2(v);
  const __nv_bfloat162 p = __floats2bfloat162_rn(f.x * s, f.y * s);
  return *reinterpret_cast<const uint32_t*>(&p);
}

}  // namespace ptt
