// Exact top-k threshold bits per session, by binary search over the
// float32 bit space.
//
// Replaces: src/repro/kernels/topk_mask/topk_mask.py
//   topk_threshold_bits_3d.
//
// What it computes: for each session b of a (B, n) buffer of |u| float32
// bit patterns (sign cleared, zero-padded), the bit pattern of the k-th
// largest value, sort(|u|)[n_valid - k], exactly. Non-negative floats
// order as their bit patterns, so bits 30..0 are decided one at a time:
// keep candidate `thr | 1<<bit` when at least k values are >= it. Bit 31
// is the sign and stays clear. Zero padding never counts, since every
// candidate is >= 1. The caller turns the bits back into a float and
// builds the masks with a float `|u| >= thr` compare, so the masks equal
// the sort path's, NaN included.
//
// What bounds it on an H100: bytes, at one 4-byte read per coordinate in
// the least case (B=8 x 334,405 coordinates are 10.7 MB, ~3.2 us at
// 3.35 TB/s). This design is further from that bound than the masked
// Adam: one session's 1.34 MB of bits does not fit in a block's 227 KB of
// shared memory, so it is re-read on each of the 31 passes.
//
// What the design does about it: it stays simple and exact. One block of
// 1024 threads per session counts with 16-byte loads and a warp-shuffle
// block reduction; the re-reads hit the 50 MB L2, which holds a B=8 stack
// (10.7 MB) whole. It occupies B of the 132 SMs. A multi-block radix
// select (a few digit passes with global histograms) is the later design.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__global__ void __launch_bounds__(kThreads)
topk_threshold_kernel(const uint32_t* bits, long long n, long long k,
                      uint32_t* out) {
  __shared__ int warp_counts[kWarps];
  __shared__ int total;
  const uint4* base = reinterpret_cast<const uint4*>(
      bits + static_cast<long long>(blockIdx.x) * n);
  const long long n4 = n / 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t thr = 0;
  for (int bit = 30; bit >= 0; --bit) {
    const uint32_t cand = thr | (1u << bit);
    int cnt = 0;
    for (long long i = threadIdx.x; i < n4; i += kThreads) {
      const uint4 q = base[i];
      cnt += (q.x >= cand) + (q.y >= cand) + (q.z >= cand) + (q.w >= cand);
    }
    cnt = warp_sum(cnt);
    if (lane == 0) warp_counts[warp] = cnt;
    __syncthreads();
    if (warp == 0) {
      int c = warp_sum(lane < kWarps ? warp_counts[lane] : 0);
      if (lane == 0) total = c;
    }
    __syncthreads();
    if (total >= k) thr = cand;  // the same decision in every thread
    __syncthreads();             // before warp_counts/total are reused
  }
  if (threadIdx.x == 0) out[blockIdx.x] = thr;
}

}  // namespace

extern "C" {

// `bits`: device pointer to a (B, n) contiguous uint32 buffer, 16-byte
// aligned, n a multiple of 4 and below 2^31; `out`: (B,) uint32. Launches
// on `stream` of CUDA device `device` and returns the launch's
// cudaError_t (0 on success).
int topk_threshold_bits(const void* bits, long long n, long long k, int B,
                        void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_threshold_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bits), n, k, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
