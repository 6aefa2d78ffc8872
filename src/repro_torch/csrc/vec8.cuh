// Eight consecutive values of a float32, bfloat16 or float16 buffer, as
// floats, with 16-byte loads and stores: one for eight two-byte values, two
// for eight floats. Shared by masked Adam (masked_adam.cu) and the gradient
// norm (grad_norm.cu), whose buffers are laid out in rows of 128 by
// repro_torch.kernels.stacking, so every index is a multiple of 8 and every
// access 16-byte aligned.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace vec8 {

constexpr int kVec = 8;

enum Dtype : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ void load8(const void* base, int dt, long long i,
                                      float (&x)[kVec]) {
  if (dt == kF32) {
    const float4* p = reinterpret_cast<const float4*>(
        static_cast<const float*>(base) + i);
    float4 a = p[0], b = p[1];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  } else if (dt == kBF16) {
    uint4 r = *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(base) + i);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&r);
#pragma unroll
    for (int j = 0; j < kVec; ++j) x[j] = __bfloat162float(h[j]);
  } else {
    uint4 r = *reinterpret_cast<const uint4*>(
        static_cast<const __half*>(base) + i);
    const __half* h = reinterpret_cast<const __half*>(&r);
#pragma unroll
    for (int j = 0; j < kVec; ++j) x[j] = __half2float(h[j]);
  }
}

__device__ __forceinline__ void store8(void* base, int dt, long long i,
                                       const float (&x)[kVec]) {
  if (dt == kF32) {
    float4* p = reinterpret_cast<float4*>(static_cast<float*>(base) + i);
    p[0] = make_float4(x[0], x[1], x[2], x[3]);
    p[1] = make_float4(x[4], x[5], x[6], x[7]);
  } else if (dt == kBF16) {
    uint4 r;
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&r);
#pragma unroll
    for (int j = 0; j < kVec; ++j) h[j] = __float2bfloat16_rn(x[j]);
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(base) + i) = r;
  } else {
    uint4 r;
    __half* h = reinterpret_cast<__half*>(&r);
#pragma unroll
    for (int j = 0; j < kVec; ++j) h[j] = __float2half_rn(x[j]);
    *reinterpret_cast<uint4*>(static_cast<__half*>(base) + i) = r;
  }
}

// x rounded to the buffer type dt and back to float32 (what a store and a
// load would give), round to nearest even.
__device__ __forceinline__ float round_to(float x, int dt) {
  if (dt == kBF16) return __bfloat162float(__float2bfloat16_rn(x));
  if (dt == kF16) return __half2float(__float2half_rn(x));
  return x;
}

}  // namespace vec8
