// Forward flash attention with grouped KV heads, for prefill.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py
//   flash_attention_4d.
//
// What it computes, for every batch row b, query head h = kv*G + g and
// query position i (keys j of KV head kv = h / G, never repeated):
//   s_ij = (q_i . k_j) * hd^-0.5
//   s_ij = softcap * tanh(s_ij / softcap)            when softcap != 0
//   s_ij = -1e30 unless j < Skv, (i >= j if causal), (i - j < window if
//          window > 0)
//   o_i  = sum_j softmax_j(s_ij) v_j
// in float32 with float32 accumulation, out in q's type (float32 or
// bfloat16). The masked score is the finite -1e30 of both JAX versions,
// not -inf: a row whose first visited tile is fully masked gets
// m = -1e30 and p = exp(0) there, and the next live tile's correction
// exp(-1e30 - m) wipes that out (with -inf it would be exp(nan)).
//
// What bounds it on an H100: operations. At the Gemma-2 9B prefill shape
// (B=2, 16 q heads, 8 KV heads, S=8,000, head_dim 256) a global layer
// does 4*B*H*hd*S(S+1)/2 = 1.05 TFLOP, 1.06 ms at the 989 TFLOP/s bf16
// tensor-core rate; a local layer (window 4,096) 0.80 TFLOP. Each live
// score also needs a tanh and an exp.
//
// What the design does about it, for now: it is simple and right, on the
// CUDA cores in float32 (the tensor cores, wgmma and TMA are later work).
// One block of 256 threads per (q tile of 64 rows, q head, batch row),
// heaviest causal tiles first. The block keeps its q tile in shared
// memory, and walks only the kv tiles of 64 rows that the causal and
// window bounds leave live (the Pallas kernel's @pl.when(live)): each is
// staged in shared memory as float32 (K and V with 16-byte loads), the
// 64x64 scores are computed as 4x4 per thread with float4 reads laid out
// to avoid bank conflicts, the online softmax runs per row across the 16
// threads that share it (shuffles), and P goes through shared memory
// into P.V. The 64 x hd output accumulator lives in registers, 4 rows x
// hd/16 columns per thread. Shared memory is (2*64*(hd+4) + 64*hd +
// 64*80) floats, 219 KB at hd 256, above the 48 KB default, so every
// launch raises the kernel's dynamic shared-memory limit first. Ragged
// ends (S not a multiple of 64) load zeros and are masked or not stored.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;    // q rows per block
constexpr int kBK = 64;    // kv rows per tile
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

enum Dtype : int { kF32 = 0, kBF16 = 1 };

template <int HD>
struct Layout {              // shared memory, in floats
  static constexpr int kQS = HD + 4;    // row stride of Qs and Ks
  static constexpr int kPS = kBK + 16;  // row stride of Ps
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBQ * kQS;
  static constexpr int kV = kK + kBK * kQS;
  static constexpr int kP = kV + kBK * HD;
  static constexpr int kFloats = kP + kBQ * kPS;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

struct Params {
  const void* q; const void* k; const void* v; void* o;
  long long q_sb, q_ss, q_skv, q_sg;   // strides in elements
  long long k_sb, k_ss, k_skv;
  long long v_sb, v_ss, v_skv;
  long long o_sb, o_ss, o_skv, o_sg;
  int Sq, Skv, G;
  int causal, window;
  float softcap, scale;
};

template <typename T>
__device__ __forceinline__ void to_float(const uint4& raw,
                                         float (&x)[16 / sizeof(T)]) {
  if constexpr (sizeof(T) == 4) {
    const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = f[j];
  } else {
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = __bfloat162float(h[j]);
  }
}

// Rows [r0, r0+64) of an (S, HD) matrix with row stride `ss` (elements)
// into shared memory as float32 rows of stride `ds`; rows >= S are zeros.
// All loads are issued before any store, so they are in flight together.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          long long ss, int r0, int S,
                                          float* dst, int ds) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = HD / kVec;
  constexpr int kIters = 64 * kPerRow / kThreads;
  static_assert(64 * kPerRow % kThreads == 0, "tile must split evenly");
  uint4 raw[kIters];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int c = it * kThreads + threadIdx.x;
    const int r = c / kPerRow, d = (c % kPerRow) * kVec;
    raw[it] = r0 + r < S ? *reinterpret_cast<const uint4*>(
                               src + static_cast<long long>(r0 + r) * ss + d)
                         : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int c = it * kThreads + threadIdx.x;
    const int r = c / kPerRow, d = (c % kPerRow) * kVec;
    float x[kVec];
    to_float<T>(raw[it], x);
    float* o = dst + r * ds + d;
#pragma unroll
    for (int j = 0; j < kVec; j += 4)
      *reinterpret_cast<float4*>(o + j) =
          make_float4(x[j], x[j + 1], x[j + 2], x[j + 3]);
  }
}

__device__ __forceinline__ float comp(const float4& a, int u) {
  return u == 0 ? a.x : u == 1 ? a.y : u == 2 ? a.z : a.w;
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const float (&x)[4]) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    uint2 r;
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&r);
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __float2bfloat16_rn(x[j]);
    *reinterpret_cast<uint2*>(p) = r;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_kernel(Params p) {
  using L = Layout<HD>;
  constexpr int kNJ = HD / 64;  // float4 column groups per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qs = smem + L::kQ;
  float* Ks = smem + L::kK;
  float* Vs = smem + L::kV;
  float* Ps = smem + L::kP;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / p.G, g = h % p.G;
  const int q0 = qt * kBQ;
  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + kvh * p.q_skv +
                g * p.q_sg;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_skv;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_skv;
  T* ob = static_cast<T*>(p.o) + b * p.o_sb + kvh * p.o_skv + g * p.o_sg;

  load_tile<T, HD>(qb, p.q_ss, q0, p.Sq, Qs, L::kQS);

  // thread (ty, tx): q rows ty + 16i and, per tile, kv columns tx + 16j
  // (i, j < 4); output columns 4tx + 64jj .. +3 (jj < kNJ)
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[4][kNJ][4];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int jj = 0; jj < kNJ; ++jj)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][jj][c] = 0.0f;
  }

  // live kv tiles: [lo, hi)
  const int q_last = min(q0 + kBQ, p.Sq) - 1;
  int hi = (p.Skv + kBK - 1) / kBK, lo = 0;
  if (p.causal) hi = min(hi, q_last / kBK + 1);
  if (p.window > 0) {
    const int kmin = q0 - p.window + 1;  // first key any row here sees
    if (kmin > 0) lo = kmin / kBK;
  }

  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's Ks, Vs and Ps are read
    load_tile<T, HD>(kb, p.k_ss, k0, p.Skv, Ks, L::kQS);
    load_tile<T, HD>(vb, p.v_ss, k0, p.Skv, Vs, HD);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * L::kQS + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        c[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * L::kQS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = __fmaf_rn(a[i].x, c[j].x, s[i][j]);
          s[i][j] = __fmaf_rn(a[i].y, c[j].y, s[i][j]);
          s[i][j] = __fmaf_rn(a[i].z, c[j].z, s[i][j]);
          s[i][j] = __fmaf_rn(a[i].w, c[j].w, s[i][j]);
        }
    }

    // scale, softcap, mask, then the online softmax of each row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        float x = __fmul_rn(s[i][j], p.scale);
        if (p.softcap != 0.0f)
          x = __fmul_rn(p.softcap, tanhf(__fdiv_rn(x, p.softcap)));
        bool live = kj < p.Skv;
        if (p.causal) live = live && qi >= kj;
        if (p.window > 0) live = live && qi - kj < p.window;
        s[i][j] = live ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(__fsub_rn(m[i], m_new));
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(__fsub_rn(s[i][j], m_new));
        rs = __fadd_rn(rs, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs = __fadd_rn(rs, __shfl_xor_sync(0xffffffffu, rs, off));
      l[i] = __fadd_rn(__fmul_rn(l[i], corr), rs);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < kNJ; ++jj)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][jj][c] = __fmul_rn(acc[i][jj][c], corr);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ps[(ty + 16 * i) * L::kPS + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

    // acc += P . V
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pr[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * L::kPS + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = Vs + (kk + u) * HD + 4 * tx;
#pragma unroll
        for (int jj = 0; jj < kNJ; ++jj) {
          const float4 vv = *reinterpret_cast<const float4*>(vrow + 64 * jj);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pu = comp(pr[i], u);
            acc[i][jj][0] = __fmaf_rn(pu, vv.x, acc[i][jj][0]);
            acc[i][jj][1] = __fmaf_rn(pu, vv.y, acc[i][jj][1]);
            acc[i][jj][2] = __fmaf_rn(pu, vv.z, acc[i][jj][2]);
            acc[i][jj][3] = __fmaf_rn(pu, vv.w, acc[i][jj][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= p.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < kNJ; ++jj) {
      float x[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) x[c] = __fdiv_rn(acc[i][jj][c], denom);
      store4<T>(ob + static_cast<long long>(qi) * p.o_ss + 4 * tx + 64 * jj, x);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const Params& p, int B, int H, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Layout<HD>::kBytes));
  if (err != cudaSuccess) return err;
  dim3 grid((p.Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, Layout<HD>::kBytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int hd, int B, int H, cudaStream_t s) {
  switch (hd) {
    case 64: return launch<T, 64>(p, B, H, s);
    case 128: return launch<T, 128>(p, B, H, s);
    case 256: return launch<T, 256>(p, B, H, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, o: (B, Sq, KV, G, hd); k, v: (B, Skv, KV, hd); all of dtype `dt`
// (0 float32, 1 bfloat16), device pointers, 16-byte aligned, the last
// axis contiguous. `strides` holds 14 element strides: q's (b, s, kv, g),
// k's (b, s, kv), v's (b, s, kv), o's (b, s, kv, g); each a multiple of
// 16 bytes. hd is 64, 128 or 256. Launches on `stream` of CUDA device
// `device` and returns the launch's cudaError_t (0 on success).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dt, int hd, int B, int Sq, int Skv, int KV, int G,
                        const long long* strides, int causal, int window,
                        float softcap, float scale, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Sq == 0 || B == 0) return 0;
  const long long* st = strides;
  Params p{q, k, v, o,
           st[0], st[1], st[2], st[3],
           st[4], st[5], st[6],
           st[7], st[8], st[9],
           st[10], st[11], st[12], st[13],
           Sq, Skv, G, causal, window, softcap, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = dt == kF32 ? dispatch<float>(p, hd, B, KV * G, s)
                   : dispatch<__nv_bfloat16>(p, hd, B, KV * G, s);
  return static_cast<int>(err);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
