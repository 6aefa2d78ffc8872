// Fused masked-Adam step for a stack of B sessions (Algorithm 2, lines 8-13).
//
// Replaces: src/repro/kernels/masked_adam/masked_adam.py
//   masked_adam_stacked_3d (and masked_adam_2d, its B=1 form).
//
// What it computes, per coordinate of session b, in float32:
//   m' = b1*m + (1-b1)*g
//   v' = b2*v + (1-b2)*(g*g)
//   u  = bc[b]*m' / sqrt(v' + eps)
//   p' = p - u*mask
// p, g, m and v may each be float32, bfloat16 or float16 (the step is
// computed in float32 and stored back in each tensor's own type); the mask
// is one byte per coordinate; u is always float32.
//
// What bounds it on an H100: bytes. It does ~10 float operations for
// every 33 bytes it moves (f32 p/g/m/v read, 1-byte mask read, p/m/v/u
// written), so device memory bandwidth is the limit: B=8 x 334,405
// coordinates move 88.3 MB, ~26 us at 3.35 TB/s.
//
// What the design does about it: one pass, every byte touched once. Each
// thread handles 8 consecutive coordinates with 16-byte loads and stores
// (one for 8 two-byte values, two for 8 floats, one 8-byte load for the
// mask), neighbouring threads on neighbouring addresses. The grid is
// (ceil(n/(256*8)), B); each block reads its session's bc once. The
// buffers come from `repro_torch.kernels.stacking`: rows of 128, so n is
// a multiple of 8 and there is no ragged tail. The arithmetic uses the
// IEEE-rounded intrinsics in the plain version's order (and the library
// is built with -fmad=false), so the kernel equals its plain PyTorch
// version bit for bit.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
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

struct Args {
  const void* p; const void* g; const void* m; const void* v;
  const uint8_t* mask; const float* bc;
  void* p_out; void* m_out; void* v_out; float* u_out;
  long long n;  // coordinates per session (a multiple of kVec)
  int p_dt, g_dt, m_dt, v_dt;
  float b1, omb1, b2, omb2, eps;
};

__global__ void __launch_bounds__(kThreads) masked_adam_kernel(Args a) {
  const long long i = (static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x) * kVec;
  if (i >= a.n) return;
  const long long s = static_cast<long long>(blockIdx.y) * a.n;  // session
  const long long at = s + i;
  const float bc = a.bc[blockIdx.y];

  float p[kVec], g[kVec], m[kVec], v[kVec], u[kVec], mf[kVec];
  load8(a.p, a.p_dt, at, p);
  load8(a.g, a.g_dt, at, g);
  load8(a.m, a.m_dt, at, m);
  load8(a.v, a.v_dt, at, v);
  uint2 mb = *reinterpret_cast<const uint2*>(a.mask + at);
  const uint8_t* mbytes = reinterpret_cast<const uint8_t*>(&mb);

#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    mf[j] = mbytes[j] ? 1.0f : 0.0f;
    m[j] = __fadd_rn(__fmul_rn(a.b1, m[j]), __fmul_rn(a.omb1, g[j]));
    v[j] = __fadd_rn(__fmul_rn(a.b2, v[j]),
                     __fmul_rn(a.omb2, __fmul_rn(g[j], g[j])));
    u[j] = __fdiv_rn(__fmul_rn(bc, m[j]), __fsqrt_rn(__fadd_rn(v[j], a.eps)));
    p[j] = __fsub_rn(p[j], __fmul_rn(u[j], mf[j]));
  }
  store8(a.p_out, a.p_dt, at, p);
  store8(a.m_out, a.m_dt, at, m);
  store8(a.v_out, a.v_dt, at, v);
  store8(a.u_out, kF32, at, u);
}

}  // namespace

extern "C" {

// Pointers are device pointers to (B, n) contiguous buffers, 16-byte
// aligned; dtype codes are 0 float32, 1 bfloat16, 2 float16. Launches on
// `stream` of CUDA device `device` and returns the launch's cudaError_t
// (0 on success).
int masked_adam_3d(const void* p, int p_dt, const void* g, int g_dt,
                   const void* m, int m_dt, const void* v, int v_dt,
                   const void* mask, const void* bc,
                   void* p_out, void* m_out, void* v_out, void* u_out,
                   long long n, int B, float b1, float omb1, float b2,
                   float omb2, float eps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a{p, g, m, v, static_cast<const uint8_t*>(mask),
         static_cast<const float*>(bc), p_out, m_out, v_out,
         static_cast<float*>(u_out), n, p_dt, g_dt, m_dt, v_dt,
         b1, omb1, b2, omb2, eps};
  const long long per_block = static_cast<long long>(kThreads) * kVec;
  dim3 grid(static_cast<unsigned>((n + per_block - 1) / per_block),
            static_cast<unsigned>(B));
  masked_adam_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
