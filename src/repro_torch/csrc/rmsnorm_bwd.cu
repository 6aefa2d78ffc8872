// Backward of RMSNorm, for the LLM trainer: dx and dw of
//   y = x * r * (1 + w),   r = rsqrt(mean(x^2) + eps)
// over the last axis of x (rows, d).
//
// Replaces: the gradient of src/repro/kernels/rmsnorm/rmsnorm.py
//   rms_norm_2d (its pallas_call at :32). The JAX package has no backward
//   Pallas kernel: it differentiates models/layers.rms_norm with
//   jax.value_and_grad. This is that gradient as a kernel, the backward of
//   rmsnorm.cu:
//   dx = r (1 + w) dy - x r^3 mean((1 + w) dy x)     (stored in x's type)
//   dw = sum over rows of dy x r                     (stored in w's type)
// in float32 from float32 or bfloat16 x, dy and w.
//
// What bounds it on an H100: bytes. It must read x and dy and write dx
// (and read w, write dw: d values): at the Gemma-2B trainer's shape (4,096
// rows of 2,048, bf16) 50.3 MB, 0.015 ms at 3.35 TB/s. Its operations are
// a few per element.
//
// Design, two launches on one stream, no atomics (the result is the same
// bit for bit run to run):
//
// * rms_norm_bwd_kernel: min(rows, 256) blocks of 256 threads; block i
//   takes rows i, i + grid, ... Per row, one pass sums x^2 and (1 + w) dy x
//   (block reduction in a fixed order), a second pass (x and dy again, now
//   from L1/L2) writes dx and adds dy x r to the block's float32 dw
//   partial, a row of d floats in shared memory, each column owned by one
//   thread. The partials go out as (blocks, d) float32.
// * rms_norm_dw_kernel: one thread per column sums the blocks' partials in
//   block order and stores dw.
//
// Loads are one element a thread, neighbouring threads on neighbouring
// columns (coalesced, not 16-byte vectors): simple first.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 256;  // row blocks, so dw partials are (<= 256, d)

__device__ __forceinline__ float ld(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, long long i, float x) { p[i] = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, long long i, float x) {
  p[i] = __float2bfloat16_rn(x);
}

// The sum of v over the block, every thread gets it; warps, then the warp
// sums in warp order. `red` holds kThreads / 32 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // red is free
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) s += red[i];
  return s;
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads) rms_norm_bwd_kernel(
    const TX* __restrict__ x, const TW* __restrict__ w, const TX* __restrict__ dy,
    TX* __restrict__ dx, float* __restrict__ part, long long rows, int d, float eps) {
  extern __shared__ float dw_acc[];  // d floats
  __shared__ float red[kThreads / 32];
  for (int c = threadIdx.x; c < d; c += kThreads) dw_acc[c] = 0.0f;
  const float inv_d = 1.0f / static_cast<float>(d);
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const TX* xr = x + row * d;
    const TX* gr = dy + row * d;
    float ss = 0.0f, sg = 0.0f;
    for (int c = threadIdx.x; c < d; c += kThreads) {
      const float xv = ld(xr, c);
      const float gv = (1.0f + ld(w, c)) * ld(gr, c);
      ss = __fmaf_rn(xv, xv, ss);
      sg = __fmaf_rn(gv, xv, sg);
    }
    ss = block_sum(ss, red);
    sg = block_sum(sg, red);
    const float r = 1.0f / sqrtf(ss * inv_d + eps);
    const float cr = r * r * r * (sg * inv_d);
    TX* dxr = dx + row * d;
    for (int c = threadIdx.x; c < d; c += kThreads) {
      const float xv = ld(xr, c), gy = ld(gr, c);
      const float gv = (1.0f + ld(w, c)) * gy;
      st(dxr, c, r * gv - xv * cr);
      dw_acc[c] += gy * xv * r;
    }
  }
  for (int c = threadIdx.x; c < d; c += kThreads)
    part[static_cast<long long>(blockIdx.x) * d + c] = dw_acc[c];
}

template <typename TW>
__global__ void __launch_bounds__(kThreads) rms_norm_dw_kernel(
    const float* __restrict__ part, TW* __restrict__ dw, int blocks, int d) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= d) return;
  float s = 0.0f;
  for (int b = 0; b < blocks; ++b) s += part[static_cast<long long>(b) * d + c];
  st(dw, c, s);
}

template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* w, const void* dy, void* dx, void* dw,
                   void* part, long long rows, int d, float eps, cudaStream_t stream) {
  const int blocks = static_cast<int>(rows < kMaxBlocks ? rows : kMaxBlocks);
  const size_t smem = sizeof(float) * static_cast<size_t>(d);
  auto kern = rms_norm_bwd_kernel<TX, TW>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<blocks, kThreads, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w), static_cast<const TX*>(dy),
      static_cast<TX*>(dx), static_cast<float*>(part), rows, d, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  rms_norm_dw_kernel<TW><<<(d + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<TW*>(dw), blocks, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The number of row blocks (and rows of the float32 dw partials) that
// rms_norm_bwd uses for `rows` rows.
int rms_norm_bwd_blocks(long long rows) {
  return static_cast<int>(rows < kMaxBlocks ? rows : kMaxBlocks);
}

// x, dy, dx: (rows, d) contiguous, x_dt (0 float32, 1 bfloat16); w, dw:
// (d,) contiguous, w_dt; part: rms_norm_bwd_blocks(rows) x d float32
// scratch. Launches two kernels on `stream` of CUDA device `device` and
// returns the first cudaError_t that is not 0 (0 on success).
int rms_norm_bwd(const void* x, int x_dt, const void* w, int w_dt, const void* dy,
                 void* dx, void* dw, void* part, long long rows, int d, float eps,
                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows == 0 || d == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dt == 0 && w_dt == 0) err = launch<float, float>(x, w, dy, dx, dw, part, rows, d, eps, s);
  else if (x_dt == 0 && w_dt == 1)
    err = launch<float, __nv_bfloat16>(x, w, dy, dx, dw, part, rows, d, eps, s);
  else if (x_dt == 1 && w_dt == 0)
    err = launch<__nv_bfloat16, float>(x, w, dy, dx, dw, part, rows, d, eps, s);
  else if (x_dt == 1 && w_dt == 1)
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, w, dy, dx, dw, part, rows, d, eps, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
