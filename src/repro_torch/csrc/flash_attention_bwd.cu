// Backward of flash attention with grouped KV heads: dQ, dK and dV, for
// the LLM trainer.
//
// Replaces: the gradient of src/repro/kernels/flash_attention/
//   flash_attention.py flash_attention_4d (its pallas_call at :110). The
//   JAX package has no backward Pallas kernel: it differentiates its plain
//   attention (models/attention.py) with jax.value_and_grad. This is that
//   gradient as a kernel, the backward of flash_attention.cu.
//
// What it computes, for batch row b, query head h = kv*G + g (keys of KV
// head kv), from the forward's output O and its row log-sum-exp L (written
// by flash_attention.cu when given a buffer):
//   s_ij  = (q_i . k_j) * scale;  t_ij = tanh(s_ij / c), s_ij = c t_ij
//           with a softcap c
//   P_ij  = exp(s_ij - L_i) on live (i, j) (j < Skv, causal, window), else 0
//   D_i   = sum_d dO_id O_id
//   dS_ij = P_ij (dO_i . v_j - D_i) (1 - t_ij^2 with a softcap)
//   dQ_i  = scale sum_j dS_ij k_j
//   dK_j  = scale sum_{g, i} dS_ij q_i,   dV_j = sum_{g, i} P_ij dO_i
// in float32 from bf16 or float32 inputs, each gradient stored in its
// input's type. It takes every option the forward takes: causal or not, a
// window, a softcap, G query heads per KV head by strides, Sq != Skv, head
// dims 64, 112, 128 and 256.
//
// What bounds it on an H100: operations. The function needs 5 products of
// Sq x Skv x hd per head (S, dP, dV, dK, dQ; half of them causal): at the
// Gemma-2B trainer's shape (B 2, S 2,048, 8 q heads over 1 KV head, hd
// 256, causal) 8.59e10 FLOP, 0.087 ms at the 989 TFLOP/s bf16 tensor-core
// rate. This first version runs on the CUDA cores in float32 (67 TFLOP/s
// at most: 1.3 ms for the same work) and recomputes S and dP in both
// passes (7 products): simple and right first; tensor cores (mma.sync or
// wgmma) are for a later change. Keeping P and dS in float32 keeps the
// gradients as close to float64 as the plain version's, which a bf16
// P and dS on the tensor cores would not.
//
// Design, three launches on one stream, no atomics (the result is the
// same bit for bit run to run):
//
// * flash_bwd_dq_kernel, one block of 256 threads per (64-row q tile, q
//   head, batch row): Q and dO of its rows stay in shared memory as
//   float32; its prologue computes D for those rows (written out for the
//   next launch, 4 threads a row in a fixed order). It walks the live kv
//   tiles of 32 rows (K and V staged in shared memory), computes S and dP
//   as 2 x 4 per thread, P and dS on the spot, dS through shared memory,
//   and accumulates dQ (64 x hd) in registers, 4 rows x hd/16 columns a
//   thread.
// * flash_bwd_dkdv_kernel, one block per (64-row kv tile, q head, batch
//   row): K and V resident, Q and dO streamed in tiles of 32 rows over the
//   live q tiles, S^T and dP^T, P and dS through shared memory, dK and dV
//   accumulated in registers. With G q heads per KV head each block writes
//   its head's dK and dV as float32 partials: at KV = 1 a grid over KV
//   heads alone would have 64 blocks for 132 SMs at the trainer's shape;
//   over q heads it has 512.
// * flash_bwd_reduce_kernel sums the G partials of each KV head in the
//   order g = 0, 1, ... and stores dK and dV in their type.
//
// Shared memory at hd 256: 2 x 64 + 2 x 32 rows of hd + 4 floats, and one
// (dQ) or two (dK/dV) 64 x 36 tiles: 209,408 and 218,368 bytes of the
// 232,448 a block may have. Rows past Sq or Skv load as zeros and are
// masked and not stored.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBR = 64;  // resident rows per block
constexpr int kBS = 32;  // streamed rows per tile
constexpr int kPP = kBS + 4;  // row stride of the P / dS tiles

template <typename T>
struct BwdParams {
  const T* q; const T* k; const T* v; const T* o; const T* dout;
  const float* lse;      // (B, H, Sq)
  float* delta;          // (B, H, Sq), D = rowsum(dO * O)
  T* dq;                 // laid out like o
  float* dk_part;        // (B, H, Skv, HD)
  float* dv_part;
  long long q_sb, q_ss, q_skv, q_sg;  // strides in elements
  long long k_sb, k_ss, k_skv;
  long long v_sb, v_ss, v_skv;
  long long o_sb, o_ss, o_skv, o_sg;  // o, dO and dq
  int Sq, Skv, G, H;
  int causal, window;
  float scale, softcap, inv_cap;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store4(float* dst, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float a, float b, float c,
                                       float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 r;
  r.x = *reinterpret_cast<uint32_t*>(&lo);
  r.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = r;
}

__device__ __forceinline__ float comp(const float4& a, int u) {
  return u == 0 ? a.x : u == 1 ? a.y : u == 2 ? a.z : a.w;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc = __fmaf_rn(a.x, b.x, acc);
  acc = __fmaf_rn(a.y, b.y, acc);
  acc = __fmaf_rn(a.z, b.z, acc);
  return __fmaf_rn(a.w, b.w, acc);
}

// Rows [r0, r0 + ROWS) of an (S, HD) matrix of T with row stride `ss`
// (elements) into shared memory as float32, row stride HD + 4; rows >= S
// are zeros. 16-byte loads.
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_rows(const T* __restrict__ src, long long ss, int r0,
                                          int S, float* dst) {
  constexpr int kE = 16 / static_cast<int>(sizeof(T));
  constexpr int kPerRow = HD / kE;
  for (int c = threadIdx.x; c < ROWS * kPerRow; c += kThreads) {
    const int r = c / kPerRow, d = (c % kPerRow) * kE;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S)
      raw = *reinterpret_cast<const uint4*>(src + static_cast<long long>(r0 + r) * ss + d);
    float* o = dst + r * (HD + 4) + d;
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<uint4*>(o) = raw;
    } else {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
      const float2 f2 = __bfloat1622float2(h[2]), f3 = __bfloat1622float2(h[3]);
      *reinterpret_cast<float4*>(o) = make_float4(f0.x, f0.y, f1.x, f1.y);
      *reinterpret_cast<float4*>(o + 4) = make_float4(f2.x, f2.y, f3.x, f3.y);
    }
  }
}

// The live test of score (qi, kj), as the forward's.
__device__ __forceinline__ bool live(int qi, int kj, int Sq, int Skv, int causal,
                                     int window) {
  bool ok = qi < Sq && kj < Skv;
  if (causal) ok = ok && qi >= kj;
  if (window > 0) ok = ok && qi - kj < window;
  return ok;
}

// S and dP of a 64 x 32 tile, 2 x 4 a thread: rows sy + 32i of R (and
// R2), columns sx + 8j of X (and X2); all four in shared memory with row
// stride HD + 4.
template <int HD>
__device__ __forceinline__ void tile_products(const float* R, const float* R2,
                                              const float* X, const float* X2, int sy,
                                              int sx, float (&s)[2][4], float (&dp)[2][4]) {
  constexpr int kKP = HD + 4;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 a[2], a2[2], c[4], c2[4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      a[i] = *reinterpret_cast<const float4*>(R + (sy + 32 * i) * kKP + d);
      a2[i] = *reinterpret_cast<const float4*>(R2 + (sy + 32 * i) * kKP + d);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      c[j] = *reinterpret_cast<const float4*>(X + (sx + 8 * j) * kKP + d);
      c2[j] = *reinterpret_cast<const float4*>(X2 + (sx + 8 * j) * kKP + d);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = dot4(a[i], c[j], s[i][j]);
        dp[i][j] = dot4(a2[i], c2[j], dp[i][j]);
      }
  }
}

// P and dS of one score from its raw product s and dP, the row's L and D.
__device__ __forceinline__ void p_and_ds(float s, float dp, float L, float D, bool ok,
                                         float scale, float softcap, float inv_cap,
                                         float& p, float& ds) {
  p = 0.0f;
  ds = 0.0f;
  if (!ok) return;
  float x = s * scale, t = 0.0f;
  if (softcap != 0.0f) {
    t = tanhf(x * inv_cap);
    x = softcap * t;
  }
  p = expf(x - L);
  ds = p * (dp - D);
  if (softcap != 0.0f) ds *= 1.0f - t * t;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq_kernel(BwdParams<T> p) {
  constexpr int kKP = HD + 4;
  constexpr int kNJ = (HD + 63) / 64;  // float4 column groups per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + kBR * kKP;
  float* Ks = dOs + kBR * kKP;
  float* Vs = Ks + kBS * kKP;
  float* dSs = Vs + kBS * kKP;
  float* Ls = dSs + kBR * kPP;
  float* Ds = Ls + kBR;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / p.G, g = h % p.G;
  const int q0 = qt * kBR;
  const T* qb = p.q + b * p.q_sb + kvh * p.q_skv + g * p.q_sg;
  const T* kb = p.k + b * p.k_sb + kvh * p.k_skv;
  const T* vb = p.v + b * p.v_sb + kvh * p.v_skv;
  const long long ob = b * p.o_sb + kvh * p.o_skv + g * p.o_sg;
  const long long rowb = (static_cast<long long>(b) * p.H + h) * p.Sq;

  load_rows<T, HD, kBR>(qb, p.q_ss, q0, p.Sq, Qs);
  load_rows<T, HD, kBR>(p.dout + ob, p.o_ss, q0, p.Sq, dOs);
  __syncthreads();
  {  // D = rowsum(dO * O), 4 threads a row, in a fixed order
    const int r = threadIdx.x / 4, part = threadIdx.x % 4;
    float acc = 0.0f;
    if (q0 + r < p.Sq) {
      const T* orow = p.o + ob + static_cast<long long>(q0 + r) * p.o_ss;
      for (int d = part; d < HD; d += 4) acc = __fmaf_rn(dOs[r * kKP + d], to_f(orow[d]), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      const bool in = q0 + r < p.Sq;
      Ds[r] = acc;
      Ls[r] = in ? p.lse[rowb + q0 + r] : 0.0f;
      if (in) p.delta[rowb + q0 + r] = acc;
    }
  }

  // live kv tiles: [lo, hi)
  const int q_last = min(q0 + kBR, p.Sq) - 1;
  int hi = (p.Skv + kBS - 1) / kBS, lo = 0;
  if (p.causal) hi = min(hi, q_last / kBS + 1);
  if (p.window > 0) {
    const int kmin = q0 - p.window + 1;  // first key any row here sees
    if (kmin > 0) lo = kmin / kBS;
  }

  const int sy = threadIdx.x / 8, sx = threadIdx.x % 8;    // score tile
  const int ay = threadIdx.x / 16, ax = threadIdx.x % 16;  // accumulator
  auto col_live = [&](int jj) { return HD % 64 == 0 || 64 * jj + 4 * ax < HD; };
  float acc[4][kNJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < kNJ; ++jj)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][jj][c] = 0.0f;

  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kBS;
    __syncthreads();  // the previous tile's Ks, Vs and dSs are read
    load_rows<T, HD, kBS>(kb, p.k_ss, k0, p.Skv, Ks);
    load_rows<T, HD, kBS>(vb, p.v_ss, k0, p.Skv, Vs);
    __syncthreads();

    float s[2][4], dp[2][4];
    tile_products<HD>(Qs, dOs, Ks, Vs, sy, sx, s, dp);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = sy + 32 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = sx + 8 * j;
        float pr, ds;
        p_and_ds(s[i][j], dp[i][j], Ls[r], Ds[r],
                 live(q0 + r, k0 + c, p.Sq, p.Skv, p.causal, p.window), p.scale,
                 p.softcap, p.inv_cap, pr, ds);
        dSs[r * kPP + c] = ds;
      }
    }
    __syncthreads();

    // dQ += dS K
#pragma unroll 2
    for (int kk = 0; kk < kBS; kk += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pr[i] = *reinterpret_cast<const float4*>(dSs + (ay + 16 * i) * kPP + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* krow = Ks + (kk + u) * kKP + 4 * ax;
#pragma unroll
        for (int jj = 0; jj < kNJ; ++jj) {
          if (!col_live(jj)) continue;
          const float4 kv = *reinterpret_cast<const float4*>(krow + 64 * jj);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float w = comp(pr[i], u);
            acc[i][jj][0] = __fmaf_rn(w, kv.x, acc[i][jj][0]);
            acc[i][jj][1] = __fmaf_rn(w, kv.y, acc[i][jj][1]);
            acc[i][jj][2] = __fmaf_rn(w, kv.z, acc[i][jj][2]);
            acc[i][jj][3] = __fmaf_rn(w, kv.w, acc[i][jj][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ay + 16 * i;
    if (qi >= p.Sq) continue;
    T* dst = p.dq + ob + static_cast<long long>(qi) * p.o_ss + 4 * ax;
#pragma unroll
    for (int jj = 0; jj < kNJ; ++jj) {
      if (!col_live(jj)) continue;
      store4(dst + 64 * jj, acc[i][jj][0] * p.scale, acc[i][jj][1] * p.scale,
             acc[i][jj][2] * p.scale, acc[i][jj][3] * p.scale);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkdv_kernel(BwdParams<T> p) {
  constexpr int kKP = HD + 4;
  constexpr int kNJ = (HD + 63) / 64;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kBR * kKP;
  float* Qs = Vs + kBR * kKP;
  float* dOs = Qs + kBS * kKP;
  float* Ps = dOs + kBS * kKP;
  float* dSs = Ps + kBR * kPP;
  float* Ls = dSs + kBR * kPP;
  float* Ds = Ls + kBS;

  const int kt = blockIdx.x;  // the first kv tiles see the most q rows
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / p.G, g = h % p.G;
  const int k0 = kt * kBR;
  const T* qb = p.q + b * p.q_sb + kvh * p.q_skv + g * p.q_sg;
  const T* kb = p.k + b * p.k_sb + kvh * p.k_skv;
  const T* vb = p.v + b * p.v_sb + kvh * p.v_skv;
  const long long ob = b * p.o_sb + kvh * p.o_skv + g * p.o_sg;
  const long long rowb = (static_cast<long long>(b) * p.H + h) * p.Sq;

  load_rows<T, HD, kBR>(kb, p.k_ss, k0, p.Skv, Ks);
  load_rows<T, HD, kBR>(vb, p.v_ss, k0, p.Skv, Vs);

  // live q tiles: [lo, hi)
  int lo = 0, hi = (p.Sq + kBS - 1) / kBS;
  if (p.causal) lo = k0 / kBS;  // no row before the tile's first key sees it
  if (p.window > 0) {
    const int k_last = min(k0 + kBR, p.Skv) - 1;  // last row any key here reaches
    hi = min(hi, (k_last + p.window - 1) / kBS + 1);
  }

  const int sy = threadIdx.x / 8, sx = threadIdx.x % 8;
  const int ay = threadIdx.x / 16, ax = threadIdx.x % 16;
  auto col_live = [&](int jj) { return HD % 64 == 0 || 64 * jj + 4 * ax < HD; };
  float dk[4][kNJ][4], dv[4][kNJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < kNJ; ++jj)
#pragma unroll
      for (int c = 0; c < 4; ++c) dk[i][jj][c] = dv[i][jj][c] = 0.0f;

  for (int qt = lo; qt < hi; ++qt) {
    const int q0 = qt * kBS;
    __syncthreads();  // the previous tile's Qs, dOs, Ps, dSs, Ls, Ds are read
    load_rows<T, HD, kBS>(qb, p.q_ss, q0, p.Sq, Qs);
    load_rows<T, HD, kBS>(p.dout + ob, p.o_ss, q0, p.Sq, dOs);
    if (threadIdx.x < kBS) {
      const bool in = q0 + threadIdx.x < p.Sq;
      Ls[threadIdx.x] = in ? p.lse[rowb + q0 + threadIdx.x] : 0.0f;
      Ds[threadIdx.x] = in ? p.delta[rowb + q0 + threadIdx.x] : 0.0f;
    }
    __syncthreads();

    // S^T and dP^T: rows are keys, columns queries
    float s[2][4], dp[2][4];
    tile_products<HD>(Ks, Vs, Qs, dOs, sy, sx, s, dp);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = sy + 32 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = sx + 8 * j;
        float pr, ds;
        p_and_ds(s[i][j], dp[i][j], Ls[c], Ds[c],
                 live(q0 + c, k0 + r, p.Sq, p.Skv, p.causal, p.window), p.scale,
                 p.softcap, p.inv_cap, pr, ds);
        Ps[r * kPP + c] = pr;
        dSs[r * kPP + c] = ds;
      }
    }
    __syncthreads();

    // dV += P^T dO, dK += dS^T Q
#pragma unroll 2
    for (int kk = 0; kk < kBS; kk += 4) {
      float4 pp[4], pd[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pp[i] = *reinterpret_cast<const float4*>(Ps + (ay + 16 * i) * kPP + kk);
        pd[i] = *reinterpret_cast<const float4*>(dSs + (ay + 16 * i) * kPP + kk);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* qrow = Qs + (kk + u) * kKP + 4 * ax;
        const float* drow = dOs + (kk + u) * kKP + 4 * ax;
#pragma unroll
        for (int jj = 0; jj < kNJ; ++jj) {
          if (!col_live(jj)) continue;
          const float4 qv = *reinterpret_cast<const float4*>(qrow + 64 * jj);
          const float4 ov = *reinterpret_cast<const float4*>(drow + 64 * jj);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float wp = comp(pp[i], u), wd = comp(pd[i], u);
            dv[i][jj][0] = __fmaf_rn(wp, ov.x, dv[i][jj][0]);
            dv[i][jj][1] = __fmaf_rn(wp, ov.y, dv[i][jj][1]);
            dv[i][jj][2] = __fmaf_rn(wp, ov.z, dv[i][jj][2]);
            dv[i][jj][3] = __fmaf_rn(wp, ov.w, dv[i][jj][3]);
            dk[i][jj][0] = __fmaf_rn(wd, qv.x, dk[i][jj][0]);
            dk[i][jj][1] = __fmaf_rn(wd, qv.y, dk[i][jj][1]);
            dk[i][jj][2] = __fmaf_rn(wd, qv.z, dk[i][jj][2]);
            dk[i][jj][3] = __fmaf_rn(wd, qv.w, dk[i][jj][3]);
          }
        }
      }
    }
  }

  // this q head's float32 partials, (B, H, Skv, HD)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ay + 16 * i;
    if (kj >= p.Skv) continue;
    const long long at = (static_cast<long long>(b) * p.H + h) * p.Skv + kj;
    float* dkp = p.dk_part + at * HD + 4 * ax;
    float* dvp = p.dv_part + at * HD + 4 * ax;
#pragma unroll
    for (int jj = 0; jj < kNJ; ++jj) {
      if (!col_live(jj)) continue;
      store4(dkp + 64 * jj, dk[i][jj][0] * p.scale, dk[i][jj][1] * p.scale,
             dk[i][jj][2] * p.scale, dk[i][jj][3] * p.scale);
      store4(dvp + 64 * jj, dv[i][jj][0], dv[i][jj][1], dv[i][jj][2], dv[i][jj][3]);
    }
  }
}

// dK and dV (B, Skv, KV, HD), contiguous, in T: the sum of the G q heads'
// float32 partials of each KV head, in the order g = 0, 1, ...
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_reduce_kernel(
    const float* __restrict__ dk_part, const float* __restrict__ dv_part, T* dk, T* dv,
    int B, int Skv, int KV, int G, int HD) {
  const long long n4 = static_cast<long long>(B) * Skv * KV * HD / 4;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n4;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const long long e = 4 * i;
    const int d = static_cast<int>(e % HD);
    long long rest = e / HD;
    const int kvh = static_cast<int>(rest % KV);
    rest /= KV;
    const int s = static_cast<int>(rest % Skv);
    const long long b = rest / Skv;
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), c = a;
    for (int g = 0; g < G; ++g) {
      const long long at = ((b * KV + kvh) * G + g) * Skv + s;
      const float4 x = *reinterpret_cast<const float4*>(dk_part + at * HD + d);
      const float4 y = *reinterpret_cast<const float4*>(dv_part + at * HD + d);
      a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
      c.x += y.x; c.y += y.y; c.z += y.z; c.w += y.w;
    }
    store4(dk + e, a.x, a.y, a.z, a.w);
    store4(dv + e, c.x, c.y, c.z, c.w);
  }
}

template <int HD>
constexpr size_t dq_smem() {
  return sizeof(float) * (2 * kBR * (HD + 4) + 2 * kBS * (HD + 4) + kBR * kPP + 2 * kBR);
}
template <int HD>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (2 * kBR * (HD + 4) + 2 * kBS * (HD + 4) + 2 * kBR * kPP + 2 * kBS);
}

template <typename T, int HD>
cudaError_t launch(const BwdParams<T>& p, int B, int KV, T* dk, T* dv, cudaStream_t stream) {
  auto kq = flash_bwd_dq_kernel<T, HD>;
  auto kkv = flash_bwd_dkdv_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(dq_smem<HD>()));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dkdv_smem<HD>()));
  if (err != cudaSuccess) return err;
  kq<<<dim3((p.Sq + kBR - 1) / kBR, p.H, B), kThreads, dq_smem<HD>(), stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  kkv<<<dim3((p.Skv + kBR - 1) / kBR, p.H, B), kThreads, dkdv_smem<HD>(), stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long n4 = static_cast<long long>(B) * p.Skv * KV * HD / 4;
  const int blocks = static_cast<int>(n4 / kThreads + 1 < 65536 ? n4 / kThreads + 1 : 65536);
  flash_bwd_reduce_kernel<T><<<blocks, kThreads, 0, stream>>>(p.dk_part, p.dv_part, dk, dv,
                                                              B, p.Skv, KV, p.G, HD);
  return cudaGetLastError();
}

template <typename T>
int run(const void* q, const void* k, const void* v, const void* o, const void* dout,
        const void* lse, void* delta, void* dq, void* dk_part, void* dv_part, void* dk,
        void* dv, int hd, int B, int Sq, int Skv, int KV, int G, const long long* st,
        int causal, int window, float softcap, float scale, cudaStream_t stream) {
  BwdParams<T> p{static_cast<const T*>(q), static_cast<const T*>(k),
                 static_cast<const T*>(v), static_cast<const T*>(o),
                 static_cast<const T*>(dout), static_cast<const float*>(lse),
                 static_cast<float*>(delta), static_cast<T*>(dq),
                 static_cast<float*>(dk_part), static_cast<float*>(dv_part),
                 st[0], st[1], st[2], st[3],
                 st[4], st[5], st[6],
                 st[7], st[8], st[9],
                 st[10], st[11], st[12], st[13],
                 Sq, Skv, G, KV * G, causal, window, scale, softcap,
                 softcap != 0.0f ? 1.0f / softcap : 0.0f};
  T* dkt = static_cast<T*>(dk);
  T* dvt = static_cast<T*>(dv);
  cudaError_t err;
  switch (hd) {
    case 64: err = launch<T, 64>(p, B, KV, dkt, dvt, stream); break;
    case 112: err = launch<T, 112>(p, B, KV, dkt, dvt, stream); break;
    case 128: err = launch<T, 128>(p, B, KV, dkt, dvt, stream); break;
    case 256: err = launch<T, 256>(p, B, KV, dkt, dvt, stream); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// dtype 0: float32, 1: bfloat16 (q, k, v, o, dout, dq, dk, dv all of it).
// q: (B, Sq, KV, G, hd) strided; k, v: (B, Skv, KV, hd) strided; o, dout
// and dq: (B, Sq, KV, G, hd) with o's strides; lse and delta: (B, KV*G, Sq)
// float32 contiguous; dk_part, dv_part: (B, KV*G, Skv, hd) float32
// scratch; dk, dv: (B, Skv, KV, hd) contiguous. `strides` holds 14 element
// strides: q's (b, s, kv, g), k's (b, s, kv), v's (b, s, kv), o's (b, s,
// kv, g); each a multiple of 16 bytes, the last axes contiguous. hd is 64,
// 112, 128 or 256. Launches three kernels on `stream` of CUDA device
// `device` and returns the first cudaError_t that is not 0 (0 on success).
int flash_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const void* lse, void* delta,
                        void* dq, void* dk_part, void* dv_part, void* dk, void* dv, int hd,
                        int B, int Sq, int Skv, int KV, int G, const long long* strides,
                        int causal, int window, float softcap, float scale, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || Sq == 0 || Skv == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(q, k, v, o, dout, lse, delta, dq, dk_part, dv_part, dk, dv, hd, B, Sq,
                      Skv, KV, G, strides, causal, window, softcap, scale, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk_part, dv_part, dk, dv, hd,
                              B, Sq, Skv, KV, G, strides, causal, window, softcap, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
