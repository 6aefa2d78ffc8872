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
// A decode step's 2 rows move 36 KB, ~0.01 us: there the cost is the
// chain of latencies from launch to store, which the design keeps to one
// trip to memory, one reduction and one store.
//
// What the design does about it. w is read as whole chunks, with 16-byte
// loads where it is aligned, issued together with the first loads of x,
// and its type is a template parameter. The C entry point picks one of
// three variants from R, d and the alignment (not a knob):
//   - warp per row (many rows: R >= kManyRowsPerSM * SMs, enough for
//     two blocks of 8 rows on every SM; rows of at most 32 * kLaneChunks
//     16-byte chunks). A lane keeps its chunks of the row packed in
//     registers (14 x 16 bytes at d = 3584 bf16) and the warp reduces with
//     shuffles only: no __syncthreads on a row. Each block of 8 rows puts
//     1 + w in shared memory as float32 once, split into 16-byte halves
//     per chunk so that a warp's reads hit every bank once; 16 warps per
//     SM keep ~7 KB each in flight. One row per warp, one block per 8
//     rows, so the hardware's block scheduler balances the SMs row by row.
//     A persistent grid (SMs x occupancy blocks, each warp walking rows
//     with a grid stride) was slower at the prefill's shape on an H100:
//     its SMs finish their last rows unevenly, and prefetching the next
//     row into registers (fewer warps) or into L2 did not make up for it.
//   - block per row, split (few rows, such as a decode step's 2): each
//     thread loads one 16-byte chunk of x and the matching chunk of w, so
//     the critical path is one trip to memory, one block reduction (one
//     __syncthreads) and one store.
//   - block per row, cached (what neither takes: a d that is not a whole
//     number of 16-byte chunks, or an x that is not 16-byte aligned, goes
//     element by element; a row too long for the registers of 1,024
//     threads re-reads its remaining chunks, and their w, from L2).
// Sums are float32 with IEEE intrinsics (no contraction; -fmad=false);
// the order of the sum differs between variants and from the plain
// version, which the stated tolerance covers.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

enum Dtype : int { kF32 = 0, kBF16 = 1 };
enum Variant : int { kBlockRow = 0, kSplitRow = 1, kWarpRow = 2 };

constexpr int kMaxThreads = 1024;
constexpr int kCache = 4;          // chunks per thread kept in registers (block variant)
constexpr int kWarpThreads = 256;  // threads per block of the warp variant
constexpr int kWarpsPerBlock = kWarpThreads / 32;
constexpr int kLaneChunks = 16;    // 16-byte chunks a lane holds (warp variant)
constexpr int kManyRowsPerSM = 16; // rows per SM from which a warp per row pays

template <typename T>
__device__ __forceinline__ float to_float(T v) {
  if constexpr (sizeof(T) == 4) return v;
  else return __bfloat162float(v);
}

// VEC elements of type T from a 16-byte word (VEC = 16 / sizeof(T)).
template <typename T, int VEC>
__device__ __forceinline__ void unpack(const uint4& r, float (&x)[VEC]) {
  const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int j = 0; j < VEC; ++j) x[j] = to_float(e[j]);
}

template <typename T, int VEC>
__device__ __forceinline__ void load_chunk(const T* p, float (&x)[VEC]) {
  if constexpr (VEC == 1) {
    x[0] = to_float(*p);
  } else {
    unpack<T, VEC>(*reinterpret_cast<const uint4*>(p), x);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_chunk(T* p, const float (&x)[VEC]) {
  if constexpr (VEC == 1) {
    if constexpr (sizeof(T) == 4) *p = x[0];
    else *p = __float2bfloat16_rn(x[0]);
  } else {
    uint4 r;
    T* e = reinterpret_cast<T*>(&r);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      if constexpr (sizeof(T) == 4) e[j] = x[j];
      else e[j] = __float2bfloat16_rn(x[j]);
    }
    *reinterpret_cast<uint4*>(p) = r;
  }
}

// 1 + w[i .. i + VEC) as float32. VEC * sizeof(W) bytes: one or two
// 16-byte loads (or one 8-byte load) when `aligned`, else element by
// element.
template <typename W, int VEC>
__device__ __forceinline__ void load_one_plus_w(const W* w, long long i,
                                                bool aligned, float (&o)[VEC]) {
  constexpr int kBytes = VEC * static_cast<int>(sizeof(W));
  if (aligned && kBytes >= 8) {
    if constexpr (kBytes >= 16) {
      constexpr int per = 16 / sizeof(W);
#pragma unroll
      for (int j = 0; j < VEC; j += per) {
        const uint4 r = *reinterpret_cast<const uint4*>(w + i + j);
        const W* e = reinterpret_cast<const W*>(&r);
#pragma unroll
        for (int t = 0; t < per; ++t) o[j + t] = to_float(e[t]);
      }
    } else if constexpr (kBytes == 8) {
      const uint2 r = *reinterpret_cast<const uint2*>(w + i);
      const W* e = reinterpret_cast<const W*>(&r);
#pragma unroll
      for (int t = 0; t < VEC; ++t) o[t] = to_float(e[t]);
    }
  } else {
#pragma unroll
    for (int t = 0; t < VEC; ++t) o[t] = to_float(w[i + t]);
  }
#pragma unroll
  for (int t = 0; t < VEC; ++t) o[t] = __fadd_rn(1.0f, o[t]);
}

template <int VEC>
__device__ __forceinline__ float sum_squares(float ss, const float (&v)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) ss = __fadd_rn(ss, __fmul_rn(v[j], v[j]));
  return ss;
}

template <int VEC>
__device__ __forceinline__ void scale(float (&v)[VEC], float r,
                                      const float (&one_w)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) v[j] = __fmul_rn(__fmul_rn(v[j], r), one_w[j]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float inv_rms(float ss, long long d, float eps) {
  return rsqrtf(__fadd_rn(__fdiv_rn(ss, static_cast<float>(d)), eps));
}

// Sum of one value per thread over the block: shuffles in each warp, one
// __syncthreads, then every thread adds the warp sums in the same order.
__device__ __forceinline__ float block_sum(float v, float* warp_sums) {
  v = warp_sum(v);
  const int warp = threadIdx.x / 32, nw = (blockDim.x + 31) / 32;
  if (threadIdx.x % 32 == 0) warp_sums[warp] = v;
  __syncthreads();
  float t = 0.0f;
  for (int i = 0; i < nw; ++i) t = __fadd_rn(t, warp_sums[i]);
  return t;
}

// ---------------------------------------------------------------------------
// warp per row (many rows)
// ---------------------------------------------------------------------------

// Shared memory: 1 + w as float4 halves, ws[h * nchunks + c] = (1 + w)
// [VEC*c + 4h, VEC*c + 4h + 4). Lane l holds chunks l + 32 i of its row.
template <typename T, typename W>
__global__ void __launch_bounds__(kWarpThreads, 2)
rms_norm_kernel_warp(const T* __restrict__ x, const W* __restrict__ w,
                     bool w_aligned, T* __restrict__ out, long long R, int d,
                     int nchunks, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int H = VEC / 4;
  extern __shared__ float4 ws[];
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;

  uint4 xr[kLaneChunks];
  const uint4* xrow = reinterpret_cast<const uint4*>(x + row * d);
  if (row < R) {
#pragma unroll
    for (int i = 0; i < kLaneChunks; ++i)
      if (lane + 32 * i < nchunks) xr[i] = xrow[lane + 32 * i];
  }
  // 1 + w into shared memory, its loads in flight beside the row's
  for (int c = threadIdx.x; c < nchunks; c += kWarpThreads) {
    float o[VEC];
    load_one_plus_w<W, VEC>(w, static_cast<long long>(c) * VEC, w_aligned, o);
#pragma unroll
    for (int h = 0; h < H; ++h)
      ws[h * nchunks + c] = make_float4(o[4 * h], o[4 * h + 1], o[4 * h + 2], o[4 * h + 3]);
  }
  __syncthreads();
  if (row >= R) return;

  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < kLaneChunks; ++i) {
    if (lane + 32 * i < nchunks) {
      float v[VEC];
      unpack<T, VEC>(xr[i], v);
      ss = sum_squares<VEC>(ss, v);
    }
  }
  const float r = inv_rms(warp_sum(ss), d, eps);
  uint4* orow = reinterpret_cast<uint4*>(out + row * d);
#pragma unroll
  for (int i = 0; i < kLaneChunks; ++i) {
    const int c = lane + 32 * i;
    if (c < nchunks) {
      float v[VEC], one_w[VEC];
      unpack<T, VEC>(xr[i], v);
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const float4 q = ws[h * nchunks + c];
        one_w[4 * h] = q.x; one_w[4 * h + 1] = q.y;
        one_w[4 * h + 2] = q.z; one_w[4 * h + 3] = q.w;
      }
      scale<VEC>(v, r, one_w);
      store_chunk<T, VEC>(reinterpret_cast<T*>(orow + c), v);
    }
  }
}

// ---------------------------------------------------------------------------
// block per row, one chunk per thread (few rows)
// ---------------------------------------------------------------------------

template <typename T, typename W>
__global__ void __launch_bounds__(kMaxThreads) rms_norm_kernel_split(const T* __restrict__ x,
                                      const W* __restrict__ w, bool w_aligned,
                                      T* __restrict__ out, int d, int nchunks,
                                      float eps) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float warp_sums[kMaxThreads / 32];
  const long long base = static_cast<long long>(blockIdx.x) * d;
  const int c = threadIdx.x;
  float v[VEC], one_w[VEC];
  float ss = 0.0f;
  if (c < nchunks) {
    load_chunk<T, VEC>(x + base + c * VEC, v);
    load_one_plus_w<W, VEC>(w, static_cast<long long>(c) * VEC, w_aligned, one_w);
    ss = sum_squares<VEC>(ss, v);
  }
  const float r = inv_rms(block_sum(ss, warp_sums), d, eps);
  if (c < nchunks) {
    scale<VEC>(v, r, one_w);
    store_chunk<T, VEC>(out + base + c * VEC, v);
  }
}

// ---------------------------------------------------------------------------
// block per row, cached (scalar rows, and rows too long for the registers)
// ---------------------------------------------------------------------------

// `nchunks` = d / VEC chunks per row; the first kCache per thread stay in
// registers with their 1 + w, the rest are read again after the sum.
template <typename T, typename W, int VEC>
__global__ void __launch_bounds__(kMaxThreads) rms_norm_kernel_block(const T* __restrict__ x,
                                      const W* __restrict__ w, bool w_aligned,
                                      T* __restrict__ out, long long d,
                                      long long nchunks, float eps) {
  __shared__ float warp_sums[kMaxThreads / 32];
  const T* xr = x + static_cast<long long>(blockIdx.x) * d;
  T* orow = out + static_cast<long long>(blockIdx.x) * d;
  const int nt = blockDim.x;

  float cache[kCache][VEC], one_w[kCache][VEC];
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < kCache; ++i) {
    const long long c = threadIdx.x + static_cast<long long>(i) * nt;
    if (c < nchunks) {
      load_chunk<T, VEC>(xr + c * VEC, cache[i]);
      load_one_plus_w<W, VEC>(w, c * VEC, w_aligned, one_w[i]);
      ss = sum_squares<VEC>(ss, cache[i]);
    }
  }
  for (long long c = threadIdx.x + static_cast<long long>(kCache) * nt;
       c < nchunks; c += nt) {
    float v[VEC];
    load_chunk<T, VEC>(xr + c * VEC, v);
    ss = sum_squares<VEC>(ss, v);
  }
  const float r = inv_rms(block_sum(ss, warp_sums), d, eps);

#pragma unroll
  for (int i = 0; i < kCache; ++i) {
    const long long c = threadIdx.x + static_cast<long long>(i) * nt;
    if (c < nchunks) {
      scale<VEC>(cache[i], r, one_w[i]);
      store_chunk<T, VEC>(orow + c * VEC, cache[i]);
    }
  }
  for (long long c = threadIdx.x + static_cast<long long>(kCache) * nt;
       c < nchunks; c += nt) {
    float v[VEC], ow[VEC];
    load_chunk<T, VEC>(xr + c * VEC, v);
    load_one_plus_w<W, VEC>(w, c * VEC, w_aligned, ow);
    scale<VEC>(v, r, ow);
    store_chunk<T, VEC>(orow + c * VEC, v);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

int sm_count(int device) {
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) != cudaSuccess
      || n <= 0)
    return 132;
  return n;
}

bool is_aligned(const void* p, long long bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

struct Plan {
  int variant;
  bool vec;        // 16-byte chunks of x
  long long nchunks;
  bool w_aligned;  // w loads of a whole chunk
};

Plan plan(const void* x, int x_dt, const void* w, int w_dt, const void* out,
          long long R, long long d, int device) {
  const long long elem = x_dt == kF32 ? 4 : 2;
  const long long welem = w_dt == kF32 ? 4 : 2;
  Plan p;
  p.vec = (d * elem) % 16 == 0 && is_aligned(x, 16) && is_aligned(out, 16);
  const long long vec = p.vec ? 16 / elem : 1;
  p.nchunks = d / vec;
  const long long wbytes = vec * welem;
  p.w_aligned = is_aligned(w, wbytes < 16 ? wbytes : 16);
  if (!p.vec)
    p.variant = kBlockRow;
  else if (p.nchunks <= 32 * kLaneChunks &&
           R >= static_cast<long long>(kManyRowsPerSM) * sm_count(device))
    p.variant = kWarpRow;
  else if (p.nchunks <= kMaxThreads)
    p.variant = kSplitRow;
  else
    p.variant = kBlockRow;
  return p;
}

template <typename T, typename W>
cudaError_t launch_warp(const void* x, const void* w, const Plan& p, void* out,
                        long long R, long long d, float eps, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const size_t smem = static_cast<size_t>(p.nchunks) * VEC * sizeof(float);
  const long long blocks = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  rms_norm_kernel_warp<T, W><<<static_cast<unsigned>(blocks), kWarpThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), p.w_aligned,
      static_cast<T*>(out), R, static_cast<int>(d), static_cast<int>(p.nchunks), eps);
  return cudaGetLastError();
}

template <typename T, typename W>
cudaError_t launch_split(const void* x, const void* w, const Plan& p, void* out,
                         long long R, long long d, float eps, cudaStream_t s) {
  const unsigned threads = static_cast<unsigned>((p.nchunks + 31) / 32 * 32);
  rms_norm_kernel_split<T, W><<<static_cast<unsigned>(R), threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), p.w_aligned,
      static_cast<T*>(out), static_cast<int>(d), static_cast<int>(p.nchunks), eps);
  return cudaGetLastError();
}

template <typename T, typename W, int VEC>
cudaError_t launch_block(const void* x, const void* w, const Plan& p, void* out,
                         long long R, long long d, float eps, cudaStream_t s) {
  long long per_thread = (p.nchunks + kCache - 1) / kCache;
  long long threads = (per_thread + 31) / 32 * 32;
  if (threads < 32) threads = 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  rms_norm_kernel_block<T, W, VEC><<<static_cast<unsigned>(R),
                                     static_cast<unsigned>(threads), 0, s>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), p.w_aligned,
      static_cast<T*>(out), d, p.nchunks, eps);
  return cudaGetLastError();
}

template <typename T, typename W>
cudaError_t run(const void* x, const void* w, void* out, const Plan& p,
                long long R, long long d, float eps, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  switch (p.variant) {
    case kWarpRow: return launch_warp<T, W>(x, w, p, out, R, d, eps, s);
    case kSplitRow: return launch_split<T, W>(x, w, p, out, R, d, eps, s);
    default:
      return p.vec ? launch_block<T, W, VEC>(x, w, p, out, R, d, eps, s)
                   : launch_block<T, W, 1>(x, w, p, out, R, d, eps, s);
  }
}

}  // namespace

extern "C" {

// Which variant `rms_norm` launches for these arguments: 0 block per row
// (cached; scalar or very long rows), 1 block per row split one chunk per
// thread (few rows), 2 warp per row (many rows).
// Returns a negative value if the device cannot be queried.
int rms_norm_variant(const void* x, int x_dt, const void* w, int w_dt,
                     const void* out, long long R, long long d, int device) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return -1;
  return plan(x, x_dt, w, w_dt, out, R, d, device).variant;
}

// x, out: device pointers to (R, d) contiguous buffers of dtype x_dt;
// w: (d,) of dtype w_dt (0 float32, 1 bfloat16). R < 2^31, d < 2^31.
// Rows are read with 16-byte loads when x and out are 16-byte aligned and
// a row is a whole number of 16-byte chunks, else element by element.
// Launches on `stream` of CUDA device `device` and returns the launch's
// cudaError_t (0 on success).
int rms_norm(const void* x, int x_dt, const void* w, int w_dt, void* out,
             long long R, long long d, float eps, int device, void* stream) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p = plan(x, x_dt, w, w_dt, out, R, d, device);
  if (x_dt == kF32) {
    err = w_dt == kF32 ? run<float, float>(x, w, out, p, R, d, eps, s)
                       : run<float, __nv_bfloat16>(x, w, out, p, R, d, eps, s);
  } else {
    err = w_dt == kF32
              ? run<__nv_bfloat16, float>(x, w, out, p, R, d, eps, s)
              : run<__nv_bfloat16, __nv_bfloat16>(x, w, out, p, R, d, eps, s);
  }
  return static_cast<int>(err);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
