// RWKV-6's wkv recurrence over a whole sequence: the prefill's scan.
//
// Replaces no Pallas kernel: the JAX package writes this scan as a
// `lax.scan` of plain jnp over chunks (src/repro/models/ssm/rwkv6.py:102
// _wkv_chunked), and the port's plain version is that chunk loop in
// PyTorch (kernels/wkv6/ref.py). On the card the loop launched ~30 small
// kernels for each of its 125 chunks a layer at 8,000 tokens and wrote
// and re-read an 84 MB float32 decay tensor a chunk; this kernel was added
// for those launches and those bytes.
//
// What it computes, for each batch row b and head h, with r, k, v and
// log w of shape (B, S, H, P) and u of shape (H, P), all float32:
//   S_0 = 0
//   y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)       (y (B, S, H, P))
//   S_t = diag(exp(log w_t)) S_{t-1} + k_t v_t^T    (final S (B, H, P, P))
// the values the chunk loop computes. It steps token by token, as the
// per-step oracle does: y_t[q] = sum_p r_t[p] S_{t-1}[p, q] + bonus_t
// v_t[q], bonus_t = sum_p r_t[p] u[p] k_t[p], and each state entry
// S[p, q] = fma(k_t[p], v_t[q], S[p, q] * w_t[p]). Every decay factor is
// one step's exp(log w) <= 1, so no product of decays is formed and the
// clamp of log w to [-20, -1e-6] cannot overflow anything. All float32 on
// the CUDA cores, IEEE rounding, fused multiply-adds only where written
// (__fmaf_rn; the build passes -fmad=false).
//
// What bounds it on an H100. Bytes: r, k, v and log w read once and y
// written once, 820 MB a layer at RWKV6-3B's prefill shape (2, 8000, 40,
// 64), 0.245 ms at 3.35 TB/s. Operations: 3 float32 instructions per
// state entry and token (y's fma, the decay's mul, the update's fma),
// 7.9e9 a layer, ~0.24 ms at the CUDA cores' instruction rate; the chunked form
// does no fewer on CUDA cores (its intra-chunk products cost as much as
// the steps they replace, and add an exp per pair). What does bound it is
// the recurrence's parallelism and the instructions around the products:
// one (row, head)'s 64 x 64 state has to walk the 8,000 tokens in order,
// B x H = 80 of them fill few SMs, and every lane reads its r, k and w
// from shared memory each token.
//
// What the design does about it (the shape follows from P alone, not a
// knob; Shape below):
//   - A block per (row, head, slice of 32 value columns): the columns of
//     S are independent, so a head of 64 splits into 2 blocks of 4 warps,
//     each carrying its 64 x 32 slice of the state in registers for the
//     whole sequence (160 blocks at the path's shape).
//   - A lane holds a tile of 8 state rows by 2 columns: 16 independent
//     update chains a token, its 8 rows' r, k and w in 6 16-byte
//     shared-memory loads shared by its 2 columns. Lanes are laid out
//     column-fastest, so a quarter warp reads the same 16 bytes of r, k
//     and w (one broadcast wavefront). Of the tiles tried on an H100
//     (16 x 1, 8 x 2, 4 x 4, 8 x 4, 16 x 2 and 16 x 4, with 16 or 32
//     columns a block) this was the fastest at B = 1 and B = 2.
//   - y's partial sums over a column's 8 lanes go to shared memory each
//     token (no shuffle in the token loop) and are added once a stage, in
//     a fixed pairwise order, with bonus_t v_t.
//   - The sequence goes through shared memory in stages of 16 tokens,
//     double buffered with cp.async: stage c + 1's r, k,
//     log w and the block's v columns are in flight while stage c is
//     stepped. Once a stage has landed, the block turns log w into w =
//     expf(log w) in place and sums each token's bonus, once for all its
//     columns. A ragged last stage is zero-filled and stepped whole: a
//     zero-filled token has w = 1 and k = v = 0, so its step leaves the
//     state as it was, bit for bit, and its y is not stored. So any S,
//     S = 1 included, takes the same path.
//   - One launch a call: the final state is written from the registers
//     after the last token.
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int kBonusLanes = 4;     // lanes that sum one token's bonus
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The block's and the lane's share of a head's state, from the head size
// alone: a block carries kCols value columns of one (row, head); a lane a
// tile of kNP state rows by kNQ columns; a stage kTokens tokens.
template <int P>
struct Shape {
  static constexpr int kNQ = 2;
  static constexpr int kNP = P >= 32 ? 8 : 4;
  static constexpr int kCols = P >= 32 ? 32 : P;
  static constexpr int kRowLanes = P / kNP;       // lanes that split a column's rows
  static constexpr int kColGroups = kCols / kNQ;  // lanes that split the block's columns
  static constexpr int kThreads = kRowLanes * kColGroups;
  static constexpr int kTokens = 16;
  static constexpr int kPitch = P + 4;            // a staged row of r, k, w (floats)
  static constexpr int kPartPitch = kRowLanes * kCols + 16;  // a token's y partials
  static_assert(kThreads % 32 == 0 && P % kCols == 0, "whole warps, whole slices");
};

template <int P>
struct Stage {
  float r[Shape<P>::kTokens][Shape<P>::kPitch];
  float k[Shape<P>::kTokens][Shape<P>::kPitch];
  float w[Shape<P>::kTokens][Shape<P>::kPitch];
  float v[Shape<P>::kTokens][Shape<P>::kCols];
  float bonus[Shape<P>::kTokens];
};

// Stage tokens t0.. of (b, h): r, k and log w whole rows, v the block's
// columns, zero-filled past S. `row0` points at token 0 of (b, h); tokens
// are `pitch` floats apart.
template <int P>
__device__ __forceinline__ void load_stage(Stage<P>& st, const float* r, const float* k,
                                           const float* v, const float* logw, long long row0,
                                           long long pitch, int q0, int t0, int S) {
  using Sh = Shape<P>;
  constexpr int kRowChunks = P / 4, kColChunks = Sh::kCols / 4;
  for (int i = threadIdx.x; i < Sh::kTokens * kRowChunks; i += Sh::kThreads) {
    const int t = i / kRowChunks, c = 4 * (i % kRowChunks);
    const bool ok = t0 + t < S;
    const long long off = ok ? row0 + (t0 + t) * pitch + c : 0;
    cp_async16(&st.r[t][c], r + off, ok);
    cp_async16(&st.k[t][c], k + off, ok);
    cp_async16(&st.w[t][c], logw + off, ok);
  }
  for (int i = threadIdx.x; i < Sh::kTokens * kColChunks; i += Sh::kThreads) {
    const int t = i / kColChunks, c = 4 * (i % kColChunks);
    const bool ok = t0 + t < S;
    cp_async16(&st.v[t][c], v + (ok ? row0 + (t0 + t) * pitch + q0 + c : 0), ok);
  }
}

template <int N>
__device__ __forceinline__ void load4(const float* src, float (&dst)[N]) {
#pragma unroll
  for (int j = 0; j < N; j += 4) {
    const float4 x = *reinterpret_cast<const float4*>(src + j);
    dst[j] = x.x;
    dst[j + 1] = x.y;
    dst[j + 2] = x.z;
    dst[j + 3] = x.w;
  }
}

template <int P>
__global__ void __launch_bounds__(Shape<P>::kThreads)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ logw,
            const float* __restrict__ u, float* __restrict__ y, float* __restrict__ state,
            int S, int H) {
  using Sh = Shape<P>;
  constexpr int L = Sh::kTokens, T = Sh::kThreads, NP = Sh::kNP, NQ = Sh::kNQ;
  constexpr int COLS = Sh::kCols, RL = Sh::kRowLanes;
  __shared__ __align__(16) Stage<P> stages[2];
  __shared__ __align__(16) float part[L][Sh::kPartPitch];  // y partials [t][row lane][col]
  __shared__ float us[P];

  const int slice = blockIdx.x % (P / COLS);
  const int bh = blockIdx.x / (P / COLS);
  const int h = bh % H, b = bh / H;
  const int q0 = slice * COLS;
  const int cg = threadIdx.x % Sh::kColGroups, rl = threadIdx.x / Sh::kColGroups;
  const int p0 = rl * NP, c0 = cg * NQ;  // the lane's first state row and column
  const long long pitch = static_cast<long long>(H) * P;
  const long long row0 = static_cast<long long>(b) * S * pitch + static_cast<long long>(h) * P;

  for (int i = threadIdx.x; i < P; i += T) us[i] = u[h * P + i];
  float s[NP][NQ];
#pragma unroll
  for (int i = 0; i < NP; ++i)
#pragma unroll
    for (int j = 0; j < NQ; ++j) s[i][j] = 0.0f;

  const int n_stages = (S + L - 1) / L;
  if (n_stages > 0) load_stage(stages[0], r, k, v, logw, row0, pitch, q0, 0, S);
  cp_async_commit();
  for (int c = 0; c < n_stages; ++c) {
    Stage<P>& st = stages[c & 1];
    if (c + 1 < n_stages) {
      load_stage(stages[(c + 1) & 1], r, k, v, logw, row0, pitch, q0, (c + 1) * L, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // w = exp(log w) in place (a zero-filled token gets w = 1: with k = v
    // = 0 its step leaves the state as it was, bit for bit)
    constexpr int kRowChunks = P / 4, kExpTrips = (L * kRowChunks + T - 1) / T;
#pragma unroll
    for (int j = 0; j < kExpTrips; ++j) {
      const int i = threadIdx.x + j * T;
      if (i < L * kRowChunks) {
        float4& w = *reinterpret_cast<float4*>(&st.w[i / kRowChunks][4 * (i % kRowChunks)]);
        w = make_float4(expf(w.x), expf(w.y), expf(w.z), expf(w.w));
      }
    }
    // a token's bonus sum_p r[p] u[p] k[p], by kBonusLanes neighbouring
    // lanes over P / kBonusLanes rows each, then 2 shuffles (L * 4 is a
    // multiple of 32, so a warp takes part whole or not at all)
    constexpr int kBonusRows = P / kBonusLanes;
    for (int i = threadIdx.x; i < L * kBonusLanes; i += T) {
      const int t = i / kBonusLanes, g = i % kBonusLanes;
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < kBonusRows; ++j) {
        const int p = g * kBonusRows + j;
        acc = __fmaf_rn(__fmul_rn(st.r[t][p], us[p]), st.k[t][p], acc);
      }
      acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, 1));
      acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, 2));
      if (g == 0) st.bonus[t] = acc;
    }
    __syncthreads();

    // every token of the stage, a ragged stage's zero-filled ones too:
    // each lane's partial y over its rows, then its state tile's step
#pragma unroll
    for (int t = 0; t < L; ++t) {
      float rt[NP], kt[NP], wt[NP];
      load4(&st.r[t][p0], rt);
      load4(&st.k[t][p0], kt);
      load4(&st.w[t][p0], wt);
      const float2 vt = *reinterpret_cast<const float2*>(&st.v[t][c0]);
      const float vq[NQ] = {vt.x, vt.y};
      float yp[NQ];
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
        for (int i = 0; i < NP; i += 2) {
          a0 = __fmaf_rn(rt[i], s[i][j], a0);
          a1 = __fmaf_rn(rt[i + 1], s[i + 1][j], a1);
        }
        yp[j] = __fadd_rn(a0, a1);
      }
#pragma unroll
      for (int i = 0; i < NP; ++i)
#pragma unroll
        for (int j = 0; j < NQ; ++j) s[i][j] = __fmaf_rn(kt[i], vq[j], __fmul_rn(s[i][j], wt[i]));
      *reinterpret_cast<float2*>(&part[t][rl * COLS + c0]) = make_float2(yp[0], yp[1]);
    }
    __syncthreads();
    // y = the row lanes' partials, added by a fixed pairwise tree, + bonus v
    const int n = min(L, S - c * L);
    constexpr int kOutTrips = (L * COLS + T - 1) / T;
#pragma unroll
    for (int j = 0; j < kOutTrips; ++j) {
      const int i = threadIdx.x + j * T;
      const int t = i / COLS, q = i % COLS;
      if (t < n) {
        float x[RL];
#pragma unroll
        for (int l = 0; l < RL; ++l) x[l] = part[t][l * COLS + q];
#pragma unroll
        for (int m = 1; m < RL; m *= 2)
#pragma unroll
          for (int l = 0; l + m < RL; l += 2 * m) x[l] = __fadd_rn(x[l], x[l + m]);
        y[row0 + static_cast<long long>(c * L + t) * pitch + q0 + q] =
            __fmaf_rn(st.bonus[t], st.v[t][q], x[0]);
      }
    }
    __syncthreads();  // every lane is done with this buffer before it is refilled
  }

  float* out = state + (static_cast<long long>(b) * H + h) * P * P + q0 + c0;
#pragma unroll
  for (int i = 0; i < NP; ++i)
    *reinterpret_cast<float2*>(out + static_cast<long long>(p0 + i) * P) =
        make_float2(s[i][0], s[i][1]);
}

template <int P>
cudaError_t launch(const float* r, const float* k, const float* v, const float* logw,
                   const float* u, float* y, float* state, int B, int S, int H,
                   cudaStream_t stream) {
  const long long blocks = static_cast<long long>(B) * H * (P / Shape<P>::kCols);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  wkv6_kernel<P><<<static_cast<unsigned>(blocks), Shape<P>::kThreads, 0, stream>>>(
      r, k, v, logw, u, y, state, S, H);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// r, k, v, logw: contiguous float32 (B, S, H, P) device tensors, 16-byte
// aligned; u: contiguous float32 (H, P); y: (B, S, H, P) and state:
// (B, H, P, P), both written whole. P is 16, 32 or 64. Launches
// B * H * P / min(P, 32) blocks on `stream` of CUDA device `device` and
// returns the first cudaError_t met (0 on success).
int wkv6_forward(const void* r, const void* k, const void* v, const void* logw, const void* u,
                 void* y, void* state, int B, int S, int H, int P, int device, void* stream) {
  if (B < 1 || S < 0 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  const auto* rf = static_cast<const float*>(r);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* wf = static_cast<const float*>(logw);
  const auto* uf = static_cast<const float*>(u);
  auto* yf = static_cast<float*>(y);
  auto* sf = static_cast<float*>(state);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 16: return static_cast<int>(launch<16>(rf, kf, vf, wf, uf, yf, sf, B, S, H, s));
    case 32: return static_cast<int>(launch<32>(rf, kf, vf, wf, uf, yf, sf, B, S, H, s));
    case 64: return static_cast<int>(launch<64>(rf, kf, vf, wf, uf, yf, sf, B, S, H, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
