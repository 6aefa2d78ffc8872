// Global L2 norm of a model's gradients, for the trainer's global-norm clip.
//
// Replaces no TPU kernel: the JAX trainer (src/repro/launch/train.py:59-60)
// writes the norm as jnp and leaves it to XLA. The port's trainer keeps its
// gradients in a few flat buffers (core/masked_adam.FlatMaskedAdam, one per
// dtype group), and this kernel reads them once; masked Adam (masked_adam.cu)
// then takes the norm's device pointer and applies the clip as it steps.
//
// What it computes: gn = sqrt(sum_j sum_i float(g_j[i])^2) over up to
// kMaxBufs buffers of float32, bfloat16 or float16 values, rounded to
// float32. Each 8-value vector's squares are summed in float32 (a pairwise
// tree); each thread adds its vectors' sums in float64, buffer by buffer,
// in grid-stride order; a block adds its threads' sums by a fixed
// warp-shuffle tree; the last block to finish adds the blocks' partials in
// block order, again by a fixed tree. The order depends only on the sizes
// and the grid, never on scheduling, and there are no float atomics, so
// two calls give the same bits. The float64 sum is rounded to float32
// before the square root (a sum of squares beyond float32's range gives an
// infinite norm, as the plain float32 version's does).
//
// What bounds it on an H100: bytes. It reads every gradient byte once and
// does ~2 operations a byte: Gemma 2B's 2,506,172,416 bf16 gradients are
// 5.0 GB, ~1.50 ms at 3.35 TB/s.
//
// What the design does about it: 16-byte loads (vec8.cuh), neighbouring
// threads on neighbouring addresses, a grid the wrapper sizes to fill every
// SM (kernels/grad_norm/ops.launch_blocks), and kUnroll independent loads in
// flight a thread. The partials go to a float64 workspace; one unsigned
// counter, zeroed by a memset before the launch, finds the last block, so
// the norm takes one kernel launch and no host sync.
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "vec8.cuh"

namespace {

using vec8::kVec;
using vec8::load8;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBufs = 8;
constexpr int kUnroll = 4;

struct Bufs {
  const void* ptr[kMaxBufs];
  long long vecs[kMaxBufs];  // 8-value vectors in each buffer
  int dt[kMaxBufs];
  int count;
};

__device__ __forceinline__ float sum_sq8(const float (&x)[kVec]) {
  float s[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) s[j] = __fmul_rn(x[j], x[j]);
  return __fadd_rn(__fadd_rn(__fadd_rn(s[0], s[1]), __fadd_rn(s[2], s[3])),
                   __fadd_rn(__fadd_rn(s[4], s[5]), __fadd_rn(s[6], s[7])));
}

// The block's sum of x in a fixed order; valid in thread 0.
__device__ __forceinline__ double block_sum(double x, double* warp_sums) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  __syncthreads();  // warp_sums may still be read from an earlier call
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x < 32) {
    x = threadIdx.x < kWarps ? warp_sums[threadIdx.x] : 0.0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  }
  return x;
}

__global__ void __launch_bounds__(kThreads)
grad_norm_kernel(Bufs b, double* partials, unsigned* done, float* gn) {
  __shared__ double warp_sums[kWarps];
  __shared__ bool last;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  double acc = 0.0;
  for (int j = 0; j < b.count; ++j) {
    const void* base = b.ptr[j];
    const int dt = b.dt[j];
    const long long n = b.vecs[j];
    long long v = t;
    for (; v + (kUnroll - 1) * stride < n; v += kUnroll * stride) {
      float x[kUnroll][kVec];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) load8(base, dt, (v + k * stride) * kVec, x[k]);
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) acc += static_cast<double>(sum_sq8(x[k]));
    }
    for (; v < n; v += stride) {
      float x[kVec];
      load8(base, dt, v * kVec, x);
      acc += static_cast<double>(sum_sq8(x));
    }
  }
  const double block = block_sum(acc, warp_sums);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = block;
    __threadfence();  // the partial is visible before the count says so
    last = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  double s = 0.0;
  for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += kThreads)
    s += __ldcg(partials + i);  // from L2: other blocks wrote them
  s = block_sum(s, warp_sums);
  if (threadIdx.x == 0) *gn = __fsqrt_rn(__double2float_rn(s));
}

}  // namespace

extern "C" {

// `count` (at most 8) contiguous, 16-byte aligned device buffers: ptrs[j]
// holds vecs[j] * 8 values of dtype dts[j] (0 float32, 1 bfloat16, 2
// float16). `partials` is a device workspace of `blocks` doubles, `done`
// one device unsigned (zeroed here), `gn` one device float (the result).
// Launches `blocks` blocks of 256 threads on `stream` of CUDA device
// `device` and returns the first cudaError_t met (0 on success).
int grad_norm(const void* const* ptrs, const long long* vecs, const int* dts, int count,
              void* partials, void* done, void* gn, int blocks, int device,
              void* stream) {
  if (count < 1 || count > kMaxBufs || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const DeviceGuard guard(device);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return static_cast<int>(err);
  Bufs b{};
  for (int j = 0; j < count; ++j) {
    b.ptr[j] = ptrs[j];
    b.vecs[j] = vecs[j];
    b.dt[j] = dts[j];
  }
  b.count = count;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(done, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  grad_norm_kernel<<<blocks, kThreads, 0, s>>>(b, static_cast<double*>(partials),
                                               static_cast<unsigned*>(done),
                                               static_cast<float*>(gn));
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
