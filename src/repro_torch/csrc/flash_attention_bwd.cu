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
// Two routes by dtype, neither a fallback of the other, each three
// launches on one stream with no atomics (the result is the same bit for
// bit run to run): a pass for dQ, which also writes D; a pass for dK and
// dV, which writes each q head's float32 partials; and
// flash_bwd_reduce_kernel, which sums the G partials of each KV head in
// the order g = 0, 1, ... and stores dK and dV in their type. With KV = 1
// (Gemma 2B) a grid over KV heads alone would have 64 dK/dV blocks for 132
// SMs at the trainer's shape; over q heads it has 512, and the partials
// cost 67 MB written and read.
//
// What bounds it on an H100: operations. The function needs 5 products of
// Sq x Skv x hd per head (S, dP, dV, dK, dQ; half of them causal): at the
// Gemma-2B trainer's shape (B 2, S 2,048, 8 q heads over 1 KV head, hd
// 256, causal) 8.59e10 FLOP, 0.087 ms at the 989 TFLOP/s bf16 tensor-core
// rate.
//
// * bfloat16, the trainer's type: flash_bwd_dq_wgmma_kernel and
//   flash_bwd_dkdv_wgmma_kernel on the tensor cores (wgmma: bf16 in,
//   float32 accumulation). TMA brings q, k, v and dO through tensor maps of
//   the model's strided (B, S, KV, G, hd) and (B, S, KV, hd) layouts, in
//   64-column (128-byte) boxes with the 128-byte swizzle, as the forward
//   reads them (the helpers are hopper_tma_wgmma.cuh). Rows past S load as
//   zeros and are masked or not stored. Two warpgroups a block, no
//   producer warp (the forward's lesson: one caps the consumers'
//   registers).
//   - dQ pass: one block per (128-row q tile, q head, batch row), heaviest
//     causal tiles first; each warpgroup owns 64 q rows. Q and dO stay in
//     shared memory; the live K and V tiles of 64 rows stream through a
//     ring (1 stage at hd 256, 2 below: 194 KB and 128 KB). The prologue
//     computes D for the block's rows from O and dO in global memory (4
//     lanes a row, a fixed order) and writes it for the dK/dV pass. Per kv
//     tile: dP = dO V^T, then S = Q K^T, both in flight (V is refilled as
//     soon as every warp has its dP); P and dS in registers; dQ += dS K
//     with dS from registers (the accumulator's layout is the A operand's)
//     and K read MN-major with the transpose bit, as the forward reads V.
//     dQ (64 x hd float32: 128 registers at hd 256) accumulates on the
//     tensor cores over all tiles; the epilogue scales it, rounds it to
//     bf16 into the warpgroup's rows of the Q tile and stores it by TMA.
//   - dK/dV pass: one block per (64-row kv tile, q head, batch row), K and
//     V resident, the live Q and dO tiles of 64 rows through a 2-stage
//     ring (213 KB at hd 256). Warpgroup 0 computes S^T = K Q^T, P^T and
//     dV += P^T dO; warpgroup 1 computes dP^T = V dO^T and dK += dS^T Q.
//     S^T and dP^T are computed directly, so their accumulators have the
//     kv rows, the A layout of the next product: P and dS need no
//     transpose. Warpgroup 0 hands P^T (1 - t^2) to warpgroup 1 through 16
//     KB of shared memory (named barriers "empty" and "full"). Each
//     warpgroup holds one 64 x hd float32 accumulator (128 registers at hd
//     256); dK and dV together would not fit one warpgroup's 255. The work
//     is balanced: each warpgroup does one 64x64xhd product and one
//     64xhdx64 product in two terms a tile.
//   - Precision. q, k, v and dO are bf16, so S and dP are exact products
//     summed in float32 on the tensor cores, chained over hd. P and dS are
//     float32 and the tensor cores take bf16: each is split into
//     hi = bf16(x) and lo = bf16(x - hi) (16 of float32's 24 bits, 2^-17
//     relative), each its own wgmma into the same accumulator. With one
//     term (2^-9) dQ, dK and dV miss the contract (one bf16 ulp + 1e-4 of
//     the largest |value| of the plain backward); two meet it
//     (tests/test_torch_flash_attention_bwd.py emulates this arithmetic
//     on the CPU). The looser contract than the forward's (one ulp +
//     1e-5) lets S, dP and the dQ/dK/dV accumulators chain on the tensor
//     cores, where the forward adds its S steps and P V tiles on the CUDA
//     cores.
//   - So the kernels issue 10 product-units against the function's 5
//     (dQ pass: dP, S, dQ x 2; dK/dV pass: S^T, dP^T, dV x 2, dK x 2), a
//     0.174 ms ceiling at the trainer's shape. chip_smoke measured 0.518
//     ms there (NVIDIA H100 80GB HBM3, 700 W): 34% of peak on the products
//     issued, against 6.13 ms for the CUDA-core kernels this route
//     replaced; autograd through SDPA took 0.351 ms. PERF.md splits it
//     by kernel.
//   - Registers at hd 256 (ptxas): dQ pass 250, dK/dV pass 254, no
//     spills. ptxas injects one warpgroup arrive and wait in the dQ pass
//     (notes C7519 and C7517), not C7513's serialised wgmma.
//   - hd 112 runs the hd 128 instantiation over 112-wide tensor maps: TMA
//     fills columns 112..127 with zeros, which add exactly 0, and the
//     stores skip them.
// * float32, which only tests and synthetic checks use:
//   flash_bwd_dq_kernel and flash_bwd_dkdv_kernel on the CUDA cores (first
//   below): 64 resident rows, 32 streamed, S and dP recomputed in both
//   passes, everything in float32 with fma chains.
#include "hopper_tma_wgmma.cuh"

namespace {

// ===========================================================================
// float32: flash_bwd_dq_kernel, flash_bwd_dkdv_kernel, on the CUDA cores
// ===========================================================================

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

// Rows [r0, r0 + ROWS) of an (S, HD) float32 matrix with row stride `ss`
// (elements) into shared memory, row stride HD + 4; rows >= S are zeros.
// 16-byte loads. (bf16 goes through the wgmma kernels.)
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_rows(const T* __restrict__ src, long long ss, int r0,
                                          int S, float* dst) {
  static_assert(sizeof(T) == 4, "the CUDA-core kernels take float32");
  constexpr int kPerRow = HD / 4;
  for (int c = threadIdx.x; c < ROWS * kPerRow; c += kThreads) {
    const int r = c / kPerRow, d = (c % kPerRow) * 4;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S)
      raw = *reinterpret_cast<const uint4*>(src + static_cast<long long>(r0 + r) * ss + d);
    *reinterpret_cast<uint4*>(dst + r * (HD + 4) + d) = raw;
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


// ===========================================================================
// bfloat16: flash_bwd_dq_wgmma_kernel, flash_bwd_dkdv_wgmma_kernel
// ===========================================================================

constexpr int kWgThreads = 256;         // two warpgroups
constexpr int kDqRows = 128;            // q rows per dQ block, 64 a warpgroup
constexpr int kT = 64;                  // rows of a streamed or resident tile
constexpr int kBox = kT * 128;          // one 64-row, 64-column (128-byte) box
constexpr int kBarEmpty = 1, kBarFull = 2;  // the dK/dV block's exchange

struct WgParams {
  int Sq, Skv, G, H, hd;  // hd: the real head dim (112 runs the 128 kernels)
  int causal, window;
  float scale, softcap, inv_cap;
  const __nv_bfloat16* o;     // o and dout for D, o's strides
  const __nv_bfloat16* dout;
  long long o_sb, o_ss, o_skv, o_sg;
  const float* lse;  // (B, H, Sq)
  float* delta;      // (B, H, Sq)
  float* dk_part;    // (B, H, Skv, hd)
  float* dv_part;
};

// x0, x1 as bf16 hi + lo (16 of float32's 24 bits), each pair packed as
// wgmma's A fragment takes it
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// Issues d (64x64) = A B^T over HD columns, chained on the tensor cores,
// as one commit group: A and B 64-row tiles in shared memory, K-major,
// `a_box` and `b_box` bytes between their 64-column boxes.
template <int HD>
__device__ __forceinline__ void issue_abt(float (&d)[32], uint64_t da, int a_box, uint64_t db,
                                          int b_box) {
  reg_fence(d);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const int c = ks / 4, kk = ks % 4;
    wgmma_ss(d, da + ((c * a_box + kk * 32) >> 4), db + ((c * b_box + kk * 32) >> 4), ks > 0);
  }
  wgmma_commit();
}

// acc (64 x 64C) += A X and waits: A 64x64 in registers as hi + lo terms,
// X a 64-row tile in shared memory, MN-major (the transpose bit).
template <int C>
__device__ __forceinline__ void accumulate_ax(float (&acc)[C][32], const uint32_t (&hi)[16],
                                              const uint32_t (&lo)[16], uint32_t x) {
  const uint64_t dx = sw128_desc(x, kBox, 1024);
#pragma unroll
  for (int c = 0; c < C; ++c) reg_fence(acc[c]);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = dx + ((c * kBox + kk * 16 * 128) >> 4);
      wgmma_rs(acc[c], hi[4 * kk], hi[4 * kk + 1], hi[4 * kk + 2], hi[4 * kk + 3], db, 1);
      wgmma_rs(acc[c], lo[4 * kk], lo[4 * kk + 1], lo[4 * kk + 2], lo[4 * kk + 3], db, 1);
    }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < C; ++c) reg_fence(acc[c]);
}

// One warp's share of a stage: lane 0 counts the warp done with it and
// returns true for the last of the block's 8 warps, which refills it.
__device__ __forceinline__ bool last_of_eight(uint32_t counter, int lane) {
  if (lane != 0) return false;
  uint32_t before;
  asm volatile("atom.shared.add.u32 %0, [%1], 1;" : "=r"(before) : "r"(counter) : "memory");
  if (before % 8 != 7) return false;
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  return true;
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}

template <int HD>
struct DqLayout {  // shared memory, in bytes from a 1024-aligned base
  static constexpr int kChunks = HD / 64;
  static constexpr int kStages = HD == 256 ? 1 : 2;  // K and V tiles in the ring
  static constexpr int kQBox = kDqRows * 128;        // 128 rows x 128 B
  static constexpr int kTile = kChunks * kBox;       // one K or V tile
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + kChunks * kQBox;
  static constexpr int kK = kDO + kChunks * kQBox;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;  // Q + dO; K, V full per stage
  static constexpr int kCount = kBar + 8 * (1 + 2 * kStages);  // u32 counters
  static constexpr int kBytes = kCount + 4 * 2 * kStages;
  static constexpr size_t kAlloc = kBytes + 1024;    // room to align the base
};

// The dQ pass (see the note at the top). The wgmma accumulator layout, for
// thread t of a warpgroup (warp = t/32, lane): register 4j + 2r + c holds
// row 16 warp + lane/4 + 8r, column 8j + 2(lane%4) + c (r, c in {0, 1}).
template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const __grid_constant__ CUtensorMap tdq, const WgParams p) {
  using L = DqLayout<HD>;
  constexpr int kC = L::kChunks;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kQ, sDO = base + L::kDO, sK = base + L::kK, sV = base + L::kV;
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_k = bar_q + 8, bar_v = bar_k + 8 * L::kStages;
  const uint32_t done_k = base + L::kCount, done_v = done_k + 4 * L::kStages;

  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int h = blockIdx.x % p.H, b = blockIdx.x / p.H;
  const int kvh = h / p.G, g = h % p.G;
  const int q0 = qt * kDqRows;
  // live kv tiles: [lo, hi)
  const int q_last = min(q0 + kDqRows, p.Sq) - 1;
  int hi = (p.Skv + kT - 1) / kT, lo = 0;
  if (p.causal) hi = min(hi, q_last / kT + 1);
  if (p.window > 0) {
    const int kmin = q0 - p.window + 1;  // first key any row here sees
    if (kmin > 0) lo = kmin / kT;
  }
  const int n_tiles = hi - lo;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      asm volatile("st.shared.u32 [%0], 0;" ::"r"(done_k + 4 * s) : "memory");
      asm volatile("st.shared.u32 [%0], 0;" ::"r"(done_v + 4 * s) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the K (V) tile of loop step i into stage i % kStages, by TMA
  auto load_kv = [&](bool is_k, int i) {
    const int st = i % L::kStages;
    const uint32_t bar = (is_k ? bar_k : bar_v) + 8 * st;
    const uint32_t dst = (is_k ? sK : sV) + st * L::kTile;
    mbar_expect_tx(bar, L::kTile);
    for (int c = 0; c < kC; ++c)
      tma_load_4d(dst + c * kBox, is_k ? &tk : &tv, bar, 64 * c, kvh, (lo + i) * kT, b);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_q, 2 * kC * L::kQBox);
    for (int c = 0; c < kC; ++c) {
      tma_load_5d(sQ + c * L::kQBox, &tq, bar_q, 64 * c, g, kvh, q0, b);
      tma_load_5d(sDO + c * L::kQBox, &tdo, bar_q, 64 * c, g, kvh, q0, b);
    }
    for (int i = 0; i < min(n_tiles, L::kStages); ++i) {
      load_kv(true, i);
      load_kv(false, i);
    }
  }

  const int w = threadIdx.x / 128;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int qc0 = q0 + 64 * w;  // this warpgroup's first row
  const int row0 = qc0 + 16 * warp + lane / 4;  // and row0 + 8
  const int col = 2 * (lane % 4);
  const long long rowb = (static_cast<long long>(b) * p.H + h) * p.Sq;

  // D = rowsum(dO * O) of this thread's two rows from global memory, the 4
  // lanes of a row each taking every 4th 8-column group, summed in a fixed
  // order; written out for the dK/dV pass. L of the same rows.
  float Lr[2], Dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    float acc = 0.0f;
    if (row < p.Sq) {
      const long long off = b * p.o_sb + kvh * p.o_skv + g * p.o_sg + row * p.o_ss;
      const uint4* orow = reinterpret_cast<const uint4*>(p.o + off);
      const uint4* grow = reinterpret_cast<const uint4*>(p.dout + off);
      for (int c8 = lane % 4; c8 < p.hd / 8; c8 += 4) {
        const uint4 a = orow[c8], d = grow[c8];
        const __nv_bfloat162* ah = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* dh = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 fa = __bfloat1622float2(ah[u]), fd = __bfloat1622float2(dh[u]);
          acc = __fmaf_rn(fd.x, fa.x, acc);
          acc = __fmaf_rn(fd.y, fa.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    Dr[r] = acc;
    Lr[r] = row < p.Sq ? p.lse[rowb + row] : 0.0f;
    if (lane % 4 == 0 && row < p.Sq) p.delta[rowb + row] = acc;
  }

  float dq[kC][32];
#pragma unroll
  for (int c = 0; c < kC; ++c)
#pragma unroll
    for (int j = 0; j < 32; ++j) dq[c][j] = 0.0f;
  float s[32], dp[32];
  uint32_t ah[16], al[16];
  const uint32_t sQw = sQ + w * 64 * 128;  // this warpgroup's 64 rows of each box
  const uint64_t dq_desc = sw128_desc(sQw, 16, 1024);
  const uint64_t do_desc = sw128_desc(sDO + w * 64 * 128, 16, 1024);

  mbar_wait(bar_q, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % L::kStages;
    const uint32_t phase = (i / L::kStages) & 1;
    const int k0 = (lo + i) * kT;
    const uint32_t sKs = sK + st * L::kTile;

    // dP = dO V^T, then S = Q K^T, both in flight; V is free after dP
    mbar_wait(bar_v + 8 * st, phase);
    issue_abt<HD>(dp, do_desc, L::kQBox, sw128_desc(sV + st * L::kTile, 16, 1024), kBox);
    mbar_wait(bar_k + 8 * st, phase);
    issue_abt<HD>(s, dq_desc, L::kQBox, sw128_desc(sKs, 16, 1024), kBox);
    wgmma_wait<1>();
    reg_fence(dp);
    if (last_of_eight(done_v + 4 * st, lane) && i + L::kStages < n_tiles)
      load_kv(false, i + L::kStages);
    wgmma_wait<0>();
    reg_fence(s);

    // P and dS, as the plain version computes them; dS in two bf16 terms
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int r = (j / 2) % 2;
      const int qi = row0 + 8 * r, kj = k0 + 8 * (j / 4) + col + (j % 2);
      float pr;
      p_and_ds(s[j], dp[j], Lr[r], Dr[r], live(qi, kj, p.Sq, p.Skv, p.causal, p.window),
               p.scale, p.softcap, p.inv_cap, pr, s[j]);
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) split2(s[2 * u], s[2 * u + 1], ah[u], al[u]);

    // dQ += dS K, K read MN-major; then K is free
    accumulate_ax<kC>(dq, ah, al, sKs);
    if (last_of_eight(done_k + 4 * st, lane) && i + L::kStages < n_tiles)
      load_kv(true, i + L::kStages);
  }

  // dQ * scale in bf16 into this warpgroup's rows of the Q tile (the same
  // 128-byte swizzle: 16-byte unit j of row r sits at unit j ^ (r % 8)),
  // then one TMA store per box, which skips rows >= Sq and columns >= hd
#pragma unroll
  for (int c = 0; c < kC; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * warp + lane / 4 + 8 * r;
        const uint32_t addr =
            sQw + c * L::kQBox + row * 128 + ((j ^ (row % 8)) * 16) + col * 2;
        const uint32_t val = bf16x2_bits(__floats2bfloat162_rn(
            dq[c][4 * j + 2 * r] * p.scale, dq[c][4 * j + 2 * r + 1] * p.scale));
        asm volatile("st.shared.u32 [%0], %1;" ::"r"(addr), "r"(val) : "memory");
      }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, 128;" ::"r"(1 + w) : "memory");
  if (t == 0 && qc0 < p.Sq) {
    for (int c = 0; c < kC; ++c)
      tma_store_5d(&tdq, sQw + c * L::kQBox, 64 * c, g, kvh, qc0, b);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

template <int HD>
struct KvLayout {  // shared memory, in bytes from a 1024-aligned base
  static constexpr int kChunks = HD / 64;
  static constexpr int kStages = 2;               // Q and dO tiles in the ring
  static constexpr int kTile = kChunks * kBox;    // one 64-row tile
  static constexpr int kK = 0;
  static constexpr int kV = kK + kTile;
  static constexpr int kQ = kV + kTile;
  static constexpr int kDO = kQ + kStages * kTile;
  static constexpr int kX = kDO + kStages * kTile;  // P^T (1 - t^2), 128 x 32 floats
  static constexpr int kBar = kX + 128 * 32 * 4;    // K + V; Q + dO full per stage
  static constexpr int kCount = kBar + 8 * (1 + kStages);  // u32 counters
  static constexpr int kBytes = kCount + 4 * kStages;
  static constexpr size_t kAlloc = kBytes + 1024;
};

// The dK/dV pass (see the note at the top): warpgroup 0 owns dV, warpgroup
// 1 dK. Accumulator rows are kv rows, columns q rows (S^T, dP^T) or hd.
template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap tdo, const WgParams p) {
  using L = KvLayout<HD>;
  constexpr int kC = L::kChunks;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sK = base + L::kK, sV = base + L::kV, sQ = base + L::kQ, sDO = base + L::kDO;
  float* xch = reinterpret_cast<float*>(smem_raw + (base - raw) + L::kX);
  const uint32_t bar_kv = base + L::kBar, bar_qd = bar_kv + 8;
  const uint32_t done = base + L::kCount;

  const int kt = blockIdx.y;  // the first kv tiles see the most q rows
  const int h = blockIdx.x % p.H, b = blockIdx.x / p.H;
  const int kvh = h / p.G, g = h % p.G;
  const int k0 = kt * kT;
  // live q tiles: [lo, hi)
  int lo = 0, hi = (p.Sq + kT - 1) / kT;
  if (p.causal) lo = k0 / kT;  // no row before the tile's first key sees it
  if (p.window > 0) {
    const int k_last = min(k0 + kT, p.Skv) - 1;  // last row any key here reaches
    hi = min(hi, (k_last + p.window - 1) / kT + 1);
  }
  const int n_tiles = hi - lo;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(bar_qd + 8 * s, 1);
      asm volatile("st.shared.u32 [%0], 0;" ::"r"(done + 4 * s) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the Q and dO tiles of loop step i into stage i % kStages, by TMA
  auto load_qd = [&](int i) {
    const int st = i % L::kStages;
    const uint32_t bar = bar_qd + 8 * st;
    mbar_expect_tx(bar, 2 * L::kTile);
    for (int c = 0; c < kC; ++c) {
      tma_load_5d(sQ + st * L::kTile + c * kBox, &tq, bar, 64 * c, g, kvh, (lo + i) * kT, b);
      tma_load_5d(sDO + st * L::kTile + c * kBox, &tdo, bar, 64 * c, g, kvh, (lo + i) * kT, b);
    }
  };
  if (threadIdx.x == 0 && n_tiles > 0) {
    mbar_expect_tx(bar_kv, 2 * L::kTile);
    for (int c = 0; c < kC; ++c) {
      tma_load_4d(sK + c * kBox, &tk, bar_kv, 64 * c, kvh, k0, b);
      tma_load_4d(sV + c * kBox, &tv, bar_kv, 64 * c, kvh, k0, b);
    }
    for (int i = 0; i < min(n_tiles, L::kStages); ++i) load_qd(i);
  }

  const int w = threadIdx.x / 128;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int krow0 = k0 + 16 * warp + lane / 4;  // this thread's kv rows: and + 8
  const int col = 2 * (lane % 4);
  const long long rowb = (static_cast<long long>(b) * p.H + h) * p.Sq;

  float acc[kC][32];  // warpgroup 0: dV; 1: dK before the scale
#pragma unroll
  for (int c = 0; c < kC; ++c)
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[c][j] = 0.0f;
  float x[32];        // S^T (warpgroup 0) or dP^T (1), then P^T or dS^T
  float rv[16];       // L (0) or D (1) of this thread's 16 q columns
  uint32_t ah[16], al[16];
  const uint64_t da = sw128_desc(w == 0 ? sK : sV, 16, 1024);

  if (n_tiles > 0) {
    mbar_wait(bar_kv, 0);
    if (w == 1) named_arrive(kBarEmpty);  // the exchange starts empty
  }
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % L::kStages;
    const uint32_t phase = (i / L::kStages) & 1;
    const int q0 = (lo + i) * kT;
    const uint32_t sQs = sQ + st * L::kTile, sDOs = sDO + st * L::kTile;

    // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (1)
    mbar_wait(bar_qd + 8 * st, phase);
    issue_abt<HD>(x, da, kBox, sw128_desc(w == 0 ? sQs : sDOs, 16, 1024), kBox);
    const float* rsrc = w == 0 ? p.lse : p.delta;
#pragma unroll
    for (int m = 0; m < 8; ++m)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qi = q0 + 8 * m + col + c;
        rv[2 * m + c] = qi < p.Sq ? rsrc[rowb + qi] : 0.0f;
      }
    wgmma_wait<0>();
    reg_fence(x);

    if (w == 0) {
      // P^T as the plain version computes it; P^T (1 - t^2) to warpgroup 1
      named_sync(kBarEmpty);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int kj = krow0 + 8 * ((j / 2) % 2), qi = q0 + 8 * (j / 4) + col + (j % 2);
        float xv = x[j] * p.scale, tt = 0.0f;
        if (p.softcap != 0.0f) {
          tt = tanhf(xv * p.inv_cap);
          xv = p.softcap * tt;
        }
        const float pr = live(qi, kj, p.Sq, p.Skv, p.causal, p.window)
                             ? expf(xv - rv[2 * (j / 4) + j % 2])
                             : 0.0f;
        xch[j * 128 + t] = p.softcap != 0.0f ? pr * (1.0f - tt * tt) : pr;
        x[j] = pr;
      }
      __threadfence_block();
      named_arrive(kBarFull);
    } else {
      // dS^T = P^T (1 - t^2) (dP^T - D)
      named_sync(kBarFull);
#pragma unroll
      for (int j = 0; j < 32; ++j) x[j] = xch[j * 128 + t] * (x[j] - rv[2 * (j / 4) + j % 2]);
      if (i + 1 < n_tiles) named_arrive(kBarEmpty);
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) split2(x[2 * u], x[2 * u + 1], ah[u], al[u]);

    // dV += P^T dO (0) or dK += dS^T Q (1), read MN-major; then the stage
    // is free
    accumulate_ax<kC>(acc, ah, al, w == 0 ? sDOs : sQs);
    if (last_of_eight(done + 4 * st, lane) && i + L::kStages < n_tiles) load_qd(i + L::kStages);
  }

  // this q head's float32 partials, (B, H, Skv, hd), columns < hd only
  float* part = w == 0 ? p.dv_part : p.dk_part;
  const float f = w == 0 ? 1.0f : p.scale;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = krow0 + 8 * r;
    if (kj >= p.Skv) continue;
    float* dst = part + ((static_cast<long long>(b) * p.H + h) * p.Skv + kj) * p.hd;
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int d = 64 * c + 8 * m + col;
        if (d < p.hd)
          *reinterpret_cast<float2*>(dst + d) =
              make_float2(acc[c][4 * m + 2 * r] * f, acc[c][4 * m + 2 * r + 1] * f);
      }
  }
}

template <int HD>
cudaError_t launch_wgmma(const CUtensorMap (&maps)[7], const WgParams& p, int B, int KV,
                         __nv_bfloat16* dk, __nv_bfloat16* dv, cudaStream_t stream) {
  auto kq = flash_bwd_dq_wgmma_kernel<HD>;
  auto kkv = flash_bwd_dkdv_wgmma_kernel<HD>;
  constexpr size_t dq_bytes = DqLayout<HD>::kAlloc, kv_bytes = KvLayout<HD>::kAlloc;
  cudaError_t err = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(dq_bytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kv_bytes));
  if (err != cudaSuccess) return err;
  // maps: q (128-row box), q (64), k, v, dO (128), dO (64), dq (64)
  kq<<<dim3(p.H * B, (p.Sq + kDqRows - 1) / kDqRows), kWgThreads, dq_bytes, stream>>>(
      maps[0], maps[2], maps[3], maps[4], maps[6], p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  kkv<<<dim3(p.H * B, (p.Skv + kT - 1) / kT), kWgThreads, kv_bytes, stream>>>(
      maps[1], maps[2], maps[3], maps[5], p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long n4 = static_cast<long long>(B) * p.Skv * KV * p.hd / 4;
  const int blocks = static_cast<int>(n4 / kThreads + 1 < 65536 ? n4 / kThreads + 1 : 65536);
  flash_bwd_reduce_kernel<__nv_bfloat16><<<blocks, kThreads, 0, stream>>>(
      p.dk_part, p.dv_part, dk, dv, B, p.Skv, KV, p.G, p.hd);
  return cudaGetLastError();
}

int run_bf16(const void* q, const void* k, const void* v, const void* o, const void* dout,
             const void* lse, void* delta, void* dq, void* dk_part, void* dv_part, void* dk,
             void* dv, int hd, int B, int Sq, int Skv, int KV, int G, const long long* st,
             int causal, int window, float softcap, float scale, cudaStream_t stream) {
  if (hd != 64 && hd != 112 && hd != 128 && hd != 256) return cudaErrorInvalidValue;
  if ((Skv + kT - 1) / kT > 65535 || (Sq + kDqRows - 1) / kDqRows > 65535)
    return cudaErrorInvalidValue;
  const long long q_dims[5] = {hd, G, KV, Sq, B};
  const long long q_str[4] = {st[3], st[2], st[1], st[0]};
  const long long k_dims[4] = {hd, KV, Skv, B};
  const long long k_str[3] = {st[6], st[5], st[4]};
  const long long v_str[3] = {st[9], st[8], st[7]};
  const long long o_str[4] = {st[13], st[12], st[11], st[10]};
  const uint32_t box128[5] = {64, 1, 1, kDqRows, 1};
  const uint32_t box64[5] = {64, 1, 1, kT, 1};
  const uint32_t kv_box[4] = {64, 1, kT, 1};
  CUtensorMap maps[7];
  cudaError_t err;
  if ((err = encode_map(&maps[0], q, 5, q_dims, q_str, box128)) != cudaSuccess ||
      (err = encode_map(&maps[1], q, 5, q_dims, q_str, box64)) != cudaSuccess ||
      (err = encode_map(&maps[2], k, 4, k_dims, k_str, kv_box)) != cudaSuccess ||
      (err = encode_map(&maps[3], v, 4, k_dims, v_str, kv_box)) != cudaSuccess ||
      (err = encode_map(&maps[4], dout, 5, q_dims, o_str, box128)) != cudaSuccess ||
      (err = encode_map(&maps[5], dout, 5, q_dims, o_str, box64)) != cudaSuccess ||
      (err = encode_map(&maps[6], dq, 5, q_dims, o_str, box64)) != cudaSuccess)
    return static_cast<int>(err);
  WgParams p;
  p.Sq = Sq;
  p.Skv = Skv;
  p.G = G;
  p.H = KV * G;
  p.hd = hd;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.softcap = softcap;
  p.inv_cap = softcap != 0.0f ? 1.0f / softcap : 0.0f;
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.o_sb = st[10];
  p.o_ss = st[11];
  p.o_skv = st[12];
  p.o_sg = st[13];
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dk_part = static_cast<float*>(dk_part);
  p.dv_part = static_cast<float*>(dv_part);
  __nv_bfloat16* dkt = static_cast<__nv_bfloat16*>(dk);
  __nv_bfloat16* dvt = static_cast<__nv_bfloat16*>(dv);
  switch (hd) {
    case 64: err = launch_wgmma<64>(maps, p, B, KV, dkt, dvt, stream); break;
    case 256: err = launch_wgmma<256>(maps, p, B, KV, dkt, dvt, stream); break;
    default: err = launch_wgmma<128>(maps, p, B, KV, dkt, dvt, stream); break;  // 112 too
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// dtype 0: float32 (the CUDA-core kernels), 1: bfloat16 (the wgmma kernels,
// whose tensor maps need positive strides under 2^40 bytes); q, k, v, o,
// dout, dq, dk, dv all of it.
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
    return run_bf16(q, k, v, o, dout, lse, delta, dq, dk_part, dv_part, dk, dv, hd, B, Sq, Skv,
                    KV, G, strides, causal, window, softcap, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
