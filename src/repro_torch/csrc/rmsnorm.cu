// Gemma-style RMSNorm over the rows of an (R, d) matrix.
//
// Replaces: src/repro/kernels/rmsnorm/rmsnorm.py rms_norm_2d.
//
// What it computes, per row x of length d, in float32:
//   out = x * rsqrt(mean(x*x) + eps) * (1 + w)
// stored back in x's type. x is float32 or bfloat16; w (d,) is float32 or
// bfloat16 and is read as float32.
//
// What bounds it on an H100: bytes. It does ~4 float operations per
// element and moves 2*sizeof(x) bytes per element (x read once, out
// written once), so device memory bandwidth is the limit: the Gemma-2 9B
// prefill's 16,000 rows of 3,584 bf16 move 229 MB, ~68 us at 3.35 TB/s.
//
// What the design does about it: one block per row, sized so that every
// thread holds at most kCache chunks of the row in registers; a chunk is
// one 16-byte load (8 bf16 or 4 float32) when the rows are 16-byte
// aligned, else one element. The block reads the row once, reduces the
// sum of squares in float32 (warp shuffles, then one value per warp in
// shared memory), and writes the scaled row from its registers. Rows too
// long for the registers of 1,024 threads read their remaining chunks a
// second time (from L2). Short rows get one warp.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kCache = 4;       // chunks per thread kept in registers
constexpr int kMaxThreads = 1024;

enum Dtype : int { kF32 = 0, kBF16 = 1 };

template <typename T, int VEC>
__device__ __forceinline__ void load_chunk(const T* p, float (&x)[VEC]) {
  if constexpr (VEC == 1) {
    if constexpr (sizeof(T) == 4) x[0] = *reinterpret_cast<const float*>(p);
    else x[0] = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
  } else {
    uint4 r = *reinterpret_cast<const uint4*>(p);
    if constexpr (sizeof(T) == 4) {
      const float* f = reinterpret_cast<const float*>(&r);
#pragma unroll
      for (int j = 0; j < VEC; ++j) x[j] = f[j];
    } else {
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&r);
#pragma unroll
      for (int j = 0; j < VEC; ++j) x[j] = __bfloat162float(h[j]);
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_chunk(T* p, const float (&x)[VEC]) {
  if constexpr (VEC == 1) {
    if constexpr (sizeof(T) == 4) *reinterpret_cast<float*>(p) = x[0];
    else *reinterpret_cast<__nv_bfloat16*>(p) = __float2bfloat16_rn(x[0]);
  } else {
    uint4 r;
    if constexpr (sizeof(T) == 4) {
      float* f = reinterpret_cast<float*>(&r);
#pragma unroll
      for (int j = 0; j < VEC; ++j) f[j] = x[j];
    } else {
      __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&r);
#pragma unroll
      for (int j = 0; j < VEC; ++j) h[j] = __float2bfloat16_rn(x[j]);
    }
    *reinterpret_cast<uint4*>(p) = r;
  }
}

__device__ __forceinline__ float load_w(const void* w, int w_dt, long long i) {
  return w_dt == kF32 ? static_cast<const float*>(w)[i]
                      : __bfloat162float(static_cast<const __nv_bfloat16*>(w)[i]);
}

template <int VEC>
__device__ __forceinline__ void scale_chunk(float (&x)[VEC], float r,
                                            const void* w, int w_dt,
                                            long long i0) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float one_w = __fadd_rn(1.0f, load_w(w, w_dt, i0 + j));
    x[j] = __fmul_rn(__fmul_rn(x[j], r), one_w);
  }
}

// `nchunks` = d / VEC chunks per row.
template <typename T, int VEC>
__global__ void rms_norm_kernel(const T* __restrict__ x,
                                const void* __restrict__ w, int w_dt,
                                T* __restrict__ out, long long d,
                                long long nchunks, float eps) {
  __shared__ float warp_sums[kMaxThreads / 32];
  const T* xr = x + static_cast<long long>(blockIdx.x) * d;
  T* orow = out + static_cast<long long>(blockIdx.x) * d;
  const int nt = blockDim.x;

  float cache[kCache][VEC];
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < kCache; ++i) {
    const long long c = threadIdx.x + static_cast<long long>(i) * nt;
    if (c < nchunks) {
      load_chunk<T, VEC>(xr + c * VEC, cache[i]);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        ss = __fadd_rn(ss, __fmul_rn(cache[i][j], cache[i][j]));
    }
  }
  for (long long c = threadIdx.x + static_cast<long long>(kCache) * nt;
       c < nchunks; c += nt) {
    float v[VEC];
    load_chunk<T, VEC>(xr + c * VEC, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) ss = __fadd_rn(ss, __fmul_rn(v[j], v[j]));
  }

  // block sum of squares: shuffles within each warp, then warp 0
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    const int nw = nt / 32;
    float t = lane < nw ? warp_sums[lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      t = __fadd_rn(t, __shfl_xor_sync(0xffffffffu, t, off));
    if (lane == 0) warp_sums[0] = t;
  }
  __syncthreads();
  const float var = __fdiv_rn(warp_sums[0], static_cast<float>(d));
  const float r = rsqrtf(__fadd_rn(var, eps));

#pragma unroll
  for (int i = 0; i < kCache; ++i) {
    const long long c = threadIdx.x + static_cast<long long>(i) * nt;
    if (c < nchunks) {
      scale_chunk<VEC>(cache[i], r, w, w_dt, c * VEC);
      store_chunk<T, VEC>(orow + c * VEC, cache[i]);
    }
  }
  for (long long c = threadIdx.x + static_cast<long long>(kCache) * nt;
       c < nchunks; c += nt) {
    float v[VEC];
    load_chunk<T, VEC>(xr + c * VEC, v);
    scale_chunk<VEC>(v, r, w, w_dt, c * VEC);
    store_chunk<T, VEC>(orow + c * VEC, v);
  }
}

template <typename T, int VEC>
void launch(const void* x, const void* w, int w_dt, void* out, long long R,
            long long d, float eps, cudaStream_t stream) {
  const long long nchunks = d / VEC;
  long long per_thread = (nchunks + kCache - 1) / kCache;
  long long threads = (per_thread + 31) / 32 * 32;
  if (threads < 32) threads = 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  rms_norm_kernel<T, VEC><<<static_cast<unsigned>(R),
                            static_cast<unsigned>(threads), 0, stream>>>(
      static_cast<const T*>(x), w, w_dt, static_cast<T*>(out), d, nchunks,
      eps);
}

}  // namespace

extern "C" {

// x, out: device pointers to (R, d) contiguous buffers of dtype x_dt;
// w: (d,) of dtype w_dt (0 float32, 1 bfloat16). R < 2^31. Rows are read
// with 16-byte loads when x and out are 16-byte aligned and a row is a
// whole number of 16-byte chunks, else element by element. Launches on
// `stream` of CUDA device `device` and returns the launch's cudaError_t
// (0 on success).
int rms_norm(const void* x, int x_dt, const void* w, int w_dt, void* out,
             long long R, long long d, float eps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long elem = x_dt == kF32 ? 4 : 2;
  const bool vec = (d * elem) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (x_dt == kF32) {
    if (vec) launch<float, 4>(x, w, w_dt, out, R, d, eps, s);
    else launch<float, 1>(x, w, w_dt, out, R, d, eps, s);
  } else {
    if (vec) launch<__nv_bfloat16, 8>(x, w, w_dt, out, R, d, eps, s);
    else launch<__nv_bfloat16, 1>(x, w, w_dt, out, R, d, eps, s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
