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
// bit for bit run to run): a row pass that writes dx and one float32 dw
// partial row per block, (blocks, d), then rms_norm_dw_kernel, which sums
// the partials of each column in a fixed order (8 threads a column, each
// over every 8th row, then their sums in order). The C entry point picks
// the row pass's variant from the shape and the alignment (not a knob;
// rms_norm_bwd_variant names it):
//
// * warp per row (rows of whole 16-byte chunks, 16-byte aligned x, dy and
//   dx, at most 32 * kLaneChunks chunks: d <= 2,048 in bf16, 1,024 in
//   float32): one block of 8 warps per SM, each warp walking rows with a
//   grid stride. A lane loads its chunks of x and dy with 16-byte loads and
//   keeps them in registers, so x and dy are read from memory once; the
//   two row sums are warp shuffles, no __syncthreads. The lane's dw columns
//   are the same on every row, so it accumulates them in registers over its
//   rows; at the end the 8 warps' sums go through shared memory and are
//   added in warp order into the block's partial. 1 + w sits in shared
//   memory as float32, as in the forward's warp variant. At the trainer's
//   shape chip_smoke measured 0.0256 ms (NVIDIA H100 80GB HBM3, 700 W;
//   59% of the bound; autograd through F.rms_norm 0.0401), against
//   0.0585-0.0604 when every shape took the block per row.
// * block per row (ragged or unaligned rows, and rows too long for the
//   registers, such as 16,384): min(rows, 256) blocks of 256 threads, block
//   i taking rows i, i + grid, ...; per row one pass sums x^2 and
//   (1 + w) dy x (block reductions in a fixed order), a second pass (x and
//   dy again, from L1/L2) writes dx and adds dy x r to the block's dw
//   partial in shared memory. One element a thread, coalesced.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 256;  // row blocks of the block variant
constexpr int kWarps = kThreads / 32;
constexpr int kLaneChunks = 8;   // 16-byte chunks of a row a lane holds (warp variant)
constexpr int kDwCols = 32, kDwGroups = kThreads / kDwCols;  // the column sum's block
enum Variant : int { kBlockRow = 0, kWarpRow = 1 };

__device__ __forceinline__ float ld(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, long long i, float x) { p[i] = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, long long i, float x) {
  p[i] = __float2bfloat16_rn(x);
}

// ---------------------------------------------------------------------------
// block per row
// ---------------------------------------------------------------------------

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

// dw: the partials' column sums in a fixed order. A block takes kDwCols
// columns; its kDwGroups groups of threads each sum every kDwGroups-th
// partial row (group k rows k, k + kDwGroups, ...), then the group sums
// are added in group order. More loads in flight than one thread a column
// walking all the rows.
template <typename TW>
__global__ void __launch_bounds__(kThreads) rms_norm_dw_kernel(
    const float* __restrict__ part, TW* __restrict__ dw, int blocks, int d) {
  __shared__ float red[kDwGroups][kDwCols];
  const int lc = threadIdx.x % kDwCols, grp = threadIdx.x / kDwCols;
  const int c = blockIdx.x * kDwCols + lc;
  float s = 0.0f;
  if (c < d)
    for (int b = grp; b < blocks; b += kDwGroups) s += part[static_cast<long long>(b) * d + c];
  red[grp][lc] = s;
  __syncthreads();
  if (grp == 0 && c < d) {
    float t = 0.0f;
#pragma unroll
    for (int k = 0; k < kDwGroups; ++k) t += red[k][lc];
    st(dw, c, t);
  }
}

// ---------------------------------------------------------------------------
// warp per row
// ---------------------------------------------------------------------------

// the VEC = 16 / sizeof(T) elements of a 16-byte word as float32
template <typename T, int VEC>
__device__ __forceinline__ void unpack(const uint4& r, float (&v)[VEC]) {
  const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int j = 0; j < VEC; ++j) v[j] = ld(e, j);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 1 + w of chunk c from shared memory, where it is kept as float4 halves,
// ws[h * nchunks + c] = (1 + w)[VEC c + 4h, VEC c + 4h + 4): a warp's
// reads of chunks l + 32 i hit every bank once.
template <int VEC>
__device__ __forceinline__ void one_plus_w(const float4* ws, int nchunks, int c,
                                           float (&o)[VEC]) {
#pragma unroll
  for (int h = 0; h < VEC / 4; ++h) {
    const float4 q = ws[h * nchunks + c];
    o[4 * h] = q.x;
    o[4 * h + 1] = q.y;
    o[4 * h + 2] = q.z;
    o[4 * h + 3] = q.w;
  }
}

// Shared memory: 1 + w as float4 halves (d floats), then the warps' dw
// sums (kWarps x d floats). Lane l holds chunks l + 32 i of its rows.
template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads, 1) rms_norm_bwd_warp_kernel(
    const TX* __restrict__ x, const TW* __restrict__ w, const TX* __restrict__ dy,
    TX* __restrict__ dx, float* __restrict__ part, long long rows, int d, int nchunks,
    float eps) {
  constexpr int VEC = 16 / sizeof(TX);
  extern __shared__ float4 ws[];
  float* red = reinterpret_cast<float*>(ws) + d;  // (kWarps, d)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int c = threadIdx.x; c < nchunks; c += kThreads)
#pragma unroll
    for (int h = 0; h < VEC / 4; ++h) {
      const int e = VEC * c + 4 * h;
      ws[h * nchunks + c] = make_float4(1.0f + ld(w, e), 1.0f + ld(w, e + 1),
                                        1.0f + ld(w, e + 2), 1.0f + ld(w, e + 3));
    }
  __syncthreads();

  float dwa[kLaneChunks][VEC];
#pragma unroll
  for (int i = 0; i < kLaneChunks; ++i)
#pragma unroll
    for (int j = 0; j < VEC; ++j) dwa[i][j] = 0.0f;
  const float inv_d = 1.0f / static_cast<float>(d);
  for (long long row = static_cast<long long>(blockIdx.x) * kWarps + warp; row < rows;
       row += static_cast<long long>(gridDim.x) * kWarps) {
    const uint4* xrow = reinterpret_cast<const uint4*>(x + row * d);
    const uint4* grow = reinterpret_cast<const uint4*>(dy + row * d);
    uint4 xr[kLaneChunks], gr[kLaneChunks];
#pragma unroll
    for (int i = 0; i < kLaneChunks; ++i)
      if (lane + 32 * i < nchunks) {
        xr[i] = xrow[lane + 32 * i];
        gr[i] = grow[lane + 32 * i];
      }
    float ss = 0.0f, sg = 0.0f;
#pragma unroll
    for (int i = 0; i < kLaneChunks; ++i) {
      const int c = lane + 32 * i;
      if (c < nchunks) {
        float xv[VEC], gv[VEC], ow[VEC];
        unpack<TX, VEC>(xr[i], xv);
        unpack<TX, VEC>(gr[i], gv);
        one_plus_w<VEC>(ws, nchunks, c, ow);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          ss = __fmaf_rn(xv[j], xv[j], ss);
          sg = __fmaf_rn(ow[j] * gv[j], xv[j], sg);
        }
      }
    }
    ss = warp_sum(ss);
    sg = warp_sum(sg);
    const float r = 1.0f / sqrtf(ss * inv_d + eps);
    const float cr = r * r * r * (sg * inv_d);
    uint4* dxrow = reinterpret_cast<uint4*>(dx + row * d);
#pragma unroll
    for (int i = 0; i < kLaneChunks; ++i) {
      const int c = lane + 32 * i;
      if (c < nchunks) {
        float xv[VEC], gv[VEC], ow[VEC];
        unpack<TX, VEC>(xr[i], xv);
        unpack<TX, VEC>(gr[i], gv);
        one_plus_w<VEC>(ws, nchunks, c, ow);
        uint4 out;
        TX* e = reinterpret_cast<TX*>(&out);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          st(e, j, r * (ow[j] * gv[j]) - xv[j] * cr);
          dwa[i][j] += gv[j] * xv[j] * r;
        }
        dxrow[c] = out;
      }
    }
  }

  // the block's partial: the warps' sums added in warp order
#pragma unroll
  for (int i = 0; i < kLaneChunks; ++i) {
    const int c = lane + 32 * i;
    if (c < nchunks)
#pragma unroll
      for (int j = 0; j < VEC; j += 4)
        *reinterpret_cast<float4*>(red + warp * d + c * VEC + j) =
            make_float4(dwa[i][j], dwa[i][j + 1], dwa[i][j + 2], dwa[i][j + 3]);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += kThreads) {
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) s += red[k * d + c];
    part[static_cast<long long>(blockIdx.x) * d + c] = s;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

int sm_count(int device) {
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      n <= 0)
    return 132;
  return n;
}

bool is_aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

struct Plan {
  int variant;
  int blocks;   // row blocks: rows of the dw partials
  int nchunks;  // 16-byte chunks of a row (warp variant)
};

Plan plan(const void* x, int x_dt, const void* dy, const void* dx, long long rows, int d,
          int device) {
  const int elem = x_dt == 0 ? 4 : 2;
  Plan p;
  p.nchunks = d * elem / 16;
  if ((d * elem) % 16 == 0 && p.nchunks <= 32 * kLaneChunks && is_aligned(x) &&
      is_aligned(dy) && is_aligned(dx)) {
    p.variant = kWarpRow;
    const long long need = (rows + kWarps - 1) / kWarps;
    const int sms = sm_count(device);
    p.blocks = static_cast<int>(need < sms ? need : sms);
  } else {
    p.variant = kBlockRow;
    p.blocks = static_cast<int>(rows < kMaxBlocks ? rows : kMaxBlocks);
  }
  return p;
}

template <typename TX, typename TW>
cudaError_t launch(const Plan& pl, const void* x, const void* w, const void* dy, void* dx,
                   void* dw, void* part, long long rows, int d, float eps,
                   cudaStream_t stream) {
  const TX* xt = static_cast<const TX*>(x);
  const TX* gt = static_cast<const TX*>(dy);
  float* pt = static_cast<float*>(part);
  cudaError_t err;
  if (pl.variant == kWarpRow) {
    const size_t smem = sizeof(float) * static_cast<size_t>(d) * (1 + kWarps);
    auto kern = rms_norm_bwd_warp_kernel<TX, TW>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kern<<<pl.blocks, kThreads, smem, stream>>>(xt, static_cast<const TW*>(w), gt,
                                                static_cast<TX*>(dx), pt, rows, d,
                                                pl.nchunks, eps);
  } else {
    const size_t smem = sizeof(float) * static_cast<size_t>(d);
    auto kern = rms_norm_bwd_kernel<TX, TW>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kern<<<pl.blocks, kThreads, smem, stream>>>(xt, static_cast<const TW*>(w), gt,
                                                static_cast<TX*>(dx), pt, rows, d, eps);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  rms_norm_dw_kernel<TW><<<(d + kDwCols - 1) / kDwCols, kThreads, 0, stream>>>(
      pt, static_cast<TW*>(dw), pl.blocks, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Which row-pass variant rms_norm_bwd takes for these arguments (0 block
// per row, 1 warp per row), and how many rows of float32 dw partials it
// writes (the `part` scratch the caller allocates).
int rms_norm_bwd_variant(const void* x, int x_dt, const void* dy, const void* dx,
                         long long rows, int d, int device) {
  return plan(x, x_dt, dy, dx, rows, d, device).variant;
}

int rms_norm_bwd_blocks(const void* x, int x_dt, const void* dy, const void* dx,
                        long long rows, int d, int device) {
  return plan(x, x_dt, dy, dx, rows, d, device).blocks;
}

// x, dy, dx: (rows, d) contiguous, x_dt (0 float32, 1 bfloat16); w, dw:
// (d,) contiguous, w_dt; part: rms_norm_bwd_blocks(...) x d float32
// scratch. Launches two kernels on `stream` of CUDA device `device` and
// returns the first cudaError_t that is not 0 (0 on success).
int rms_norm_bwd(const void* x, int x_dt, const void* w, int w_dt, const void* dy,
                 void* dx, void* dw, void* part, long long rows, int d, float eps,
                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows == 0 || d == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan pl = plan(x, x_dt, dy, dx, rows, d, device);
  if (x_dt == 0 && w_dt == 0)
    err = launch<float, float>(pl, x, w, dy, dx, dw, part, rows, d, eps, s);
  else if (x_dt == 0 && w_dt == 1)
    err = launch<float, __nv_bfloat16>(pl, x, w, dy, dx, dw, part, rows, d, eps, s);
  else if (x_dt == 1 && w_dt == 0)
    err = launch<__nv_bfloat16, float>(pl, x, w, dy, dx, dw, part, rows, d, eps, s);
  else if (x_dt == 1 && w_dt == 1)
    err = launch<__nv_bfloat16, __nv_bfloat16>(pl, x, w, dy, dx, dw, part, rows, d, eps, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
