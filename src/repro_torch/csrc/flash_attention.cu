// Forward flash attention with grouped KV heads, for prefill: one kernel
// per dtype.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py
//   flash_attention_4d (its pallas_call at :110).
//
// What it computes, for every batch row b, query head h = kv*G + g and
// query position i (keys j of KV head kv = h / G, never repeated):
//   s_ij = (q_i . k_j) * hd^-0.5
//   s_ij = softcap * tanh(s_ij / softcap)            when softcap != 0
//   s_ij = -1e30 unless j < Skv, (i >= j if causal), (i - j < window if
//          window > 0)
//   o_i  = sum_j softmax_j(s_ij) v_j
// with float32 scores, softmax and accumulation, out in q's type. The
// masked score is the finite -1e30 of both JAX versions, not -inf: a row
// whose first visited tile is fully masked gets m = -1e30 and p = exp(0)
// there, and the next live tile's correction exp(-1e30 - m) wipes that
// out (with -inf it would be exp(nan)).
//
// The two kernels are routes by dtype, not fallbacks of each other:
//
// * bfloat16, the model's type: flash_fwd_wgmma_kernel, on the tensor
//   cores (below).
// * float32, which only tests and synthetic checks use: flash_fwd_f32_kernel,
//   on the CUDA cores (further below).
//
// What bounds the bf16 kernel on an H100: operations. At the Gemma-2 9B
// prefill shape (B=2, 16 q heads, 8 KV heads, S=8,000, head_dim 256) a
// global layer does 4*B*H*hd*S(S+1)/2 = 1.05 TFLOP, 1.06 ms at the
// 989 TFLOP/s bf16 tensor-core rate; a local layer (window 4,096) 0.80
// TFLOP, 0.81 ms. Each live score also takes 3 special-function ops (the
// softcap's tanh: an exp and a reciprocal; the softmax's exp): 0.73 ms for
// a global layer at 16 per SM per clock. What the design does about each:
//
// * Both products run on wgmma (bf16 in, float32 accumulation). One block
//   of 2 warpgroups (256 threads) takes one (128-row q tile, q head, batch
//   row), heaviest causal tiles first across all heads. Each warpgroup
//   owns 64 q rows: the 64 x hd float32 O accumulator, the 64x64 S tile
//   and P live in registers, 250 a thread at hd 256. There is no producer
//   warp: with one (288 threads) or a producer warpgroup (384, setmaxnreg
//   24/240) ptxas caps the consumers at 168-184 registers (9 or 12 warps
//   share an SM's 4 register files; setmaxnreg did not lift it), spills,
//   and serialises every wgmma. At 256 threads each may take 255.
// * Q (128 x hd) is loaded once; K and V tiles of 64 kv rows go through a
//   ring of stages in shared memory (2 at hd 256, 4 below). K and V each
//   have a "full" mbarrier per stage, which TMA completes by bytes, and a
//   counter of the warps done with that operand (K after S = Q K^T, V
//   after P V). Thread 0 issues the first loads; the last of the 8 warps
//   to finish with a stage refills it with the tile kStages ahead, so no
//   warp ever waits for a slot. Loads run ahead of the products, and no
//   thread spends registers on a copy. The two
//   warpgroups meet only at the full barriers, so one's softmax runs while
//   the other's products hold the tensor cores.
// * TMA reads the model's strided (B, S, KV, G, hd) and (B, S, KV, hd)
//   tensors through 5-D and 4-D tensor maps (no transpose, no copy), in
//   boxes of 64 hd columns (128 bytes) with the 128-byte swizzle that
//   wgmma reads without bank conflicts. Rows past S are filled with zeros
//   (the ragged last tile: 8,000 = 62.5 x 128) and masked.
// * S = Q K^T: m64n64k16 with A (Q) and B (K) from shared memory, both
//   K-major (hd contiguous). q and k are bf16, so every product is exact,
//   but the tensor cores' float32 sums do not round to nearest: chained
//   over the 16 k-steps of hd 256 (or over 4 or 2), S drifted enough on
//   rows of the Gemma-2 prefill's own inputs whose sums nearly cancel to
//   miss the contract. So each k-step starts from zero, two in flight,
//   and the CUDA cores add them up, rounding to nearest.
// * The softmax runs in registers with the plain version's arithmetic:
//   s * hd^-0.5, softcap * tanhf(s / softcap), the -1e30 mask, the row max
//   and sum over the 4 lanes that share a row, expf, O's correction; l is
//   summed from the float32 p. Faster forms (tanh as 1 - 2/(1 + e^{2y}),
//   scores in log2 units) missed the one-bf16-ulp + 1e-5 contract on
//   those rows.
// * P V keeps P exact: P is split in registers into bf16 P_hi, P_mid and
//   P_lo (3 x 8 bits hold float32's 24), and each goes through wgmma with
//   A from registers (the S accumulator's layout is the A operand's) and B
//   the V tile, MN-major (hd contiguous), read with the transpose bit. A
//   two-way split (2^-18 relative error) missed the contract on the same
//   rows. The three products make 2x the function's operations, a 2.12 ms
//   ceiling for a global layer. Each tile's P V is summed from zero, 64
//   hd columns at a time, and added to O * corr on the CUDA cores with one
//   fma: O chained on the tensor cores over a global row's thousands of
//   keys missed the contract too.
// * Only the kv tiles that the causal and window bounds leave live are
//   visited; the per-element mask runs only on tiles that need it.
// * Epilogue: each warpgroup divides by max(l, 1e-30), rounds to bf16 into
//   its own 64 rows of the Q tile in shared memory (same swizzle) and
//   stores them with TMA, which skips rows >= S.
// * Head dim 112 (Zamba2-7B's shared attention, 3584 / 32) runs the hd 128
//   instantiation over tensor maps whose inner extent is 112: the second
//   64-column box of each row reads columns 64..127, and TMA fills 112..127
//   with zeros (the full box still counts in the barrier's bytes, as for
//   the rows past S) and drops them on the store. The zero columns add
//   exactly 0 to every S k-step sum and give zero O columns, so the result
//   is the 112-wide function, at 8/7 of its tensor work; the scale
//   112^-0.5 comes from the host. 112 is not a multiple of the 64-column
//   (128-byte) boxes that the swizzle and the descriptors assume, which a
//   native instantiation would need a layout of its own for.
//
// Tried and dropped: FlashAttention-3's ping-pong, the warpgroups taking
// turns on the tensor cores at named barriers (no faster here), and
// issuing S_{i+1} before the softmax of S_i (ptxas then serialised every
// wgmma, C7513; with the per-step S sums there are no registers left for
// it at hd 256). Not done yet: a persistent grid, clusters with TMA
// multicast of K and V for the q heads of a KV group, fp8.
#include "device_guard.cuh"
#include "hopper_tma_wgmma.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBK = 64;  // kv rows per tile (both kernels)

// ===========================================================================
// bfloat16: flash_fwd_wgmma_kernel
// ===========================================================================

constexpr int kTcBQ = 128;            // q rows per block (2 warpgroups x 64)
constexpr int kTcThreads = 256;       // 2 warpgroups of 64 q rows each
constexpr float kLog2e = 1.4426950408889634f;

struct TcParams {
  int Sq, Skv, G, H;
  int causal, window;
  float scale;    // hd^-0.5
  float softcap;  // 0: none
  float inv_cap;  // 1 / softcap
  float* lse;     // (B, H, Sq) row log-sum-exp for the backward, or null
};

template <int HD>
struct TcLayout {  // shared memory, in bytes from a 1024-aligned base
  static constexpr int kChunks = HD / 64;           // 128-byte boxes per row
  static constexpr int kStages = HD == 256 ? 2 : 4;
  static constexpr int kQChunk = kTcBQ * 128;       // 128 rows x 128 B
  static constexpr int kKVChunk = kBK * 128;        // 64 rows x 128 B
  static constexpr int kTile = kChunks * kKVChunk;  // one K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kChunks * kQChunk;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;
  static constexpr int kCount = kBar + 8 * (1 + 2 * kStages);  // u32 counters
  static constexpr int kBytes = kCount + 4 * 2 * kStages;
  static constexpr size_t kAlloc = kBytes + 1024;   // room to align the base
};

// 2^x on the special-function unit (relative error ~2^-22)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two warpgroups of 64 q rows each; see the note at the top. The wgmma
// accumulator layout, for thread t of a warpgroup (warp w = t/32, lane):
// register 4j + 2r + c holds row 16w + lane/4 + 8r, column
// 8j + 2(lane%4) + c (r, c in {0, 1}).
template <int HD>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap to,
                           const TcParams p) {
  using L = TcLayout<HD>;
  constexpr int kC = L::kChunks;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kQ, sK = base + L::kK, sV = base + L::kV;
  const uint32_t bar_q = base + L::kBar;
  // per stage: K and V full (+ 8 * stage); warps done with K and V (+ 4 * stage)
  const uint32_t bar_k = bar_q + 8, bar_v = bar_k + 8 * L::kStages;
  const uint32_t done_k = base + L::kCount, done_v = done_k + 4 * L::kStages;

  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int h = blockIdx.x % p.H, b = blockIdx.x / p.H;
  const int kvh = h / p.G, g = h % p.G;
  const int q0 = qt * kTcBQ;
  // live kv tiles: [lo, hi)
  const int q_last = min(q0 + kTcBQ, p.Sq) - 1;
  int hi = (p.Skv + kBK - 1) / kBK, lo = 0;
  if (p.causal) hi = min(hi, q_last / kBK + 1);
  if (p.window > 0) {
    const int kmin = q0 - p.window + 1;  // first key any row here sees
    if (kmin > 0) lo = kmin / kBK;
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

  // the K (V) tile at loop step i into stage i % kStages, by TMA
  auto load_k = [&](int i) {
    const int st = i % L::kStages;
    mbar_expect_tx(bar_k + 8 * st, L::kTile);
    for (int c = 0; c < kC; ++c)
      tma_load_4d(sK + st * L::kTile + c * L::kKVChunk, &tk, bar_k + 8 * st,
                  64 * c, kvh, (lo + i) * kBK, b);
  };
  auto load_v = [&](int i) {
    const int st = i % L::kStages;
    mbar_expect_tx(bar_v + 8 * st, L::kTile);
    for (int c = 0; c < kC; ++c)
      tma_load_4d(sV + st * L::kTile + c * L::kKVChunk, &tv, bar_v + 8 * st,
                  64 * c, kvh, (lo + i) * kBK, b);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_q, kC * L::kQChunk);
    for (int c = 0; c < kC; ++c)
      tma_load_5d(sQ + c * L::kQChunk, &tq, bar_q, 64 * c, g, kvh, q0, b);
    for (int i = 0; i < min(n_tiles, L::kStages); ++i) {
      load_k(i);
      load_v(i);
    }
  }

  const int w = threadIdx.x / 128;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int qc0 = q0 + 64 * w;  // this warpgroup's first row
  const int row0 = qc0 + 16 * warp + lane / 4;  // and row0 + 8
  const int col = 2 * (lane % 4);
  const uint32_t sQw = sQ + w * 64 * 128;  // its 64 rows of each Q chunk

  float o[kC][32];
#pragma unroll
  for (int c = 0; c < kC; ++c)
#pragma unroll
    for (int j = 0; j < 32; ++j) o[c][j] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float sc[32] = {};        // S of the tile in hand, then its p
  float part[2][32];        // S of one k-step
  float pv[32];             // P V of one 64-column chunk
  uint32_t ph[16], pm[16], pl[16];  // its P = P_hi + P_mid + P_lo

  // After S_i (P_i V_i) each warp counts itself done with the stage's K
  // (V); the last of the 8 refills it with tile i + kStages. No one waits.
  auto release = [&](int i, uint32_t done, bool is_k) {
    if (lane != 0) return;
    const uint32_t addr = done + 4 * (i % L::kStages);
    uint32_t before;
    asm volatile("atom.shared.add.u32 %0, [%1], 1;" : "=r"(before) : "r"(addr) : "memory");
    if (before % 8 != 7 || i + L::kStages >= n_tiles) return;  // 8 per use
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    if (is_k)
      load_k(i + L::kStages);
    else
      load_v(i + L::kStages);
  };

  mbar_wait(bar_q, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % L::kStages;
    const uint32_t phase = (i / L::kStages) & 1;
    const int k0 = (lo + i) * kBK;

    // S = Q K^T: each k-step of 16 hd columns from zero on the tensor
    // cores (two in flight), summed on the CUDA cores, rounding to nearest
    mbar_wait(bar_k + 8 * st, phase);
    const uint64_t dq = sw128_desc(sQw, 16, 1024);
    const uint64_t dk = sw128_desc(sK + st * L::kTile, 16, 1024);
    auto issue_s = [&](int ks, float (&d)[32]) {  // + byte offset / 16
      const int c = ks / 4, kk = ks % 4;
      wgmma_fence();
      wgmma_ss(d, dq + ((c * L::kQChunk + kk * 32) >> 4),
               dk + ((c * L::kKVChunk + kk * 32) >> 4), 0);
      wgmma_commit();
    };
    reg_fence(sc);
    issue_s(0, sc);
    issue_s(1, part[1]);
    wgmma_wait<1>();
    reg_fence(sc);
    issue_s(2, part[0]);
#pragma unroll
    for (int ks = 1; ks < HD / 16; ++ks) {
      if (ks + 1 < HD / 16)
        wgmma_wait<1>();
      else
        wgmma_wait<0>();
      float (&d)[32] = part[ks % 2];
      reg_fence(d);
#pragma unroll
      for (int j = 0; j < 32; ++j) sc[j] = __fadd_rn(sc[j], d[j]);
      if (ks + 2 < HD / 16) issue_s(ks + 2, d);
    }
    release(i, done_k, true);

    // scale and softcap as the plain version does (see the note at the top)
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] *= p.scale;
    if (p.softcap != 0.0f) {
#pragma unroll
      for (int j = 0; j < 32; ++j) sc[j] = p.softcap * tanhf(sc[j] * p.inv_cap);
    }
    const bool need_mask = k0 + kBK > p.Skv || (p.causal && k0 + kBK - 1 > qc0) ||
                           (p.window > 0 && qc0 + 63 - k0 >= p.window);
    if (need_mask) {
      // key - row and the keys left, for register 0; register j adds
      // constants
      const int d0 = k0 + col - row0;
      const int left = p.Skv - k0 - col;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int dk = 8 * (j / 4) + (j % 2);  // key offset
        const int d = d0 + dk - 8 * ((j / 2) % 2);  // key - row
        bool live = dk < left;
        if (p.causal) live = live && d <= 0;
        if (p.window > 0) live = live && -d < p.window;
        if (!live) sc[j] = kNegInf;
      }
    }

    // online softmax; rows are shared by the 4 lanes of a quad
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 32; ++j)
        if ((j / 2) % 2 == r) mx = fmaxf(mx, sc[j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      corr[r] = ex2((m[r] - m_new) * kLog2e);
      m[r] = m_new;
    }
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int r = (j / 2) % 2;
      sc[j] = ex2((sc[j] - m[r]) * kLog2e);
      rs[r] += sc[j];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * corr[r] + rs[r];
    }

    // P = P_hi + P_mid + P_lo in bf16, exactly (3 x 8 bits hold float32's
    // 24), laid out as wgmma's A fragments: for the k-step of kv columns
    // 16kk.., registers 8kk + 2u, 8kk + 2u + 1 make fragment register u
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      float2 r = make_float2(sc[2 * u], sc[2 * u + 1]);
      const __nv_bfloat162 hv = __float22bfloat162_rn(r);
      const float2 hf = __bfloat1622float2(hv);
      r = make_float2(r.x - hf.x, r.y - hf.y);
      const __nv_bfloat162 mv = __float22bfloat162_rn(r);
      const float2 mf = __bfloat1622float2(mv);
      ph[u] = bf16x2_bits(hv);
      pm[u] = bf16x2_bits(mv);
      pl[u] = bf16x2_bits(__floats2bfloat162_rn(r.x - mf.x, r.y - mf.y));
    }

    // O = O * corr + P V, 64 hd columns at a time: the tensor cores sum
    // this tile's P V from zero, and the CUDA cores add it to O with one
    // fma (see the note at the top)
    mbar_wait(bar_v + 8 * st, phase);
    const uint64_t dv = sw128_desc(sV + st * L::kTile, L::kKVChunk, 1024);
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      reg_fence(pv);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = dv + ((c * L::kKVChunk + kk * 16 * 128) >> 4);
        wgmma_rs(pv, ph[4 * kk], ph[4 * kk + 1], ph[4 * kk + 2], ph[4 * kk + 3], db,
                 kk > 0);
        wgmma_rs(pv, pm[4 * kk], pm[4 * kk + 1], pm[4 * kk + 2], pm[4 * kk + 3], db, 1);
        wgmma_rs(pv, pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2], pl[4 * kk + 3], db, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(pv);
#pragma unroll
      for (int j = 0; j < 32; ++j) o[c][j] = __fmaf_rn(o[c][j], corr[(j / 2) % 2], pv[j]);
    }
    release(i, done_v, false);
  }

  // O / l in bf16 into this warpgroup's rows of the Q tile (the same
  // 128-byte swizzle: 16-byte unit j of row r sits at unit j ^ (r % 8)),
  // then one TMA store per chunk, which skips rows >= Sq
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = 1.0f / fmaxf(l[r], 1e-30f);
  if (p.lse != nullptr && lane % 4 == 0) {  // m + log l, one lane per row
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row0 + 8 * r < p.Sq)
        p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + row0 + 8 * r] =
            m[r] + logf(fmaxf(l[r], 1e-30f));
  }
#pragma unroll
  for (int c = 0; c < kC; ++c) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * warp + lane / 4 + 8 * r;
        const uint32_t addr = sQw + c * L::kQChunk + row * 128 +
                              ((j ^ (row % 8)) * 16) + col * 2;
        const uint32_t val = bf16x2_bits(__floats2bfloat162_rn(
            o[c][4 * j + 2 * r] * inv[r], o[c][4 * j + 2 * r + 1] * inv[r]));
        asm volatile("st.shared.u32 [%0], %1;" ::"r"(addr), "r"(val) : "memory");
      }
    }
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, 128;" ::"r"(1 + w) : "memory");
  if (t == 0 && qc0 < p.Sq) {
    for (int c = 0; c < kC; ++c)
      tma_store_5d(&to, sQw + c * L::kQChunk, 64 * c, g, kvh, qc0, b);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

template <int HD>
cudaError_t launch_wgmma(const CUtensorMap& tq, const CUtensorMap& tk,
                         const CUtensorMap& tv, const CUtensorMap& to,
                         const TcParams& p, int B, cudaStream_t stream) {
  auto kern = flash_fwd_wgmma_kernel<HD>;
  constexpr size_t bytes = TcLayout<HD>::kAlloc;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  dim3 grid(p.H * B, (p.Sq + kTcBQ - 1) / kTcBQ);
  kern<<<grid, kTcThreads, bytes, stream>>>(tq, tk, tv, to, p);
  return cudaGetLastError();
}

// ===========================================================================
// float32: flash_fwd_f32_kernel, on the CUDA cores
// ===========================================================================
//
// One block of 256 threads per (q tile of 64 rows, q head, batch row),
// heaviest causal tiles first. The block keeps its q tile in shared
// memory and walks only the live kv tiles of 64 rows: each is staged in
// shared memory (K and V with 16-byte loads), the 64x64 scores are
// computed as 4x4 per thread with float4 reads laid out to avoid bank
// conflicts, the online softmax runs per row across the 16 threads that
// share it (shuffles), and P goes through shared memory into P.V. The
// 64 x hd accumulator lives in registers, 4 rows x hd/16 columns per
// thread. Shared memory is (2*64*(hd+4) + 64*hd + 64*80) floats, 219 KB at
// hd 256. Ragged ends load zeros and are masked or not stored. At hd 112
// a thread's second group of output columns is live only for its first 12
// lanes of a row (columns 64 + 4tx < 112).

constexpr int kBQ = 64;  // q rows per block
constexpr int kThreads = 256;

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
  const float* q; const float* k; const float* v; float* o;
  long long q_sb, q_ss, q_skv, q_sg;   // strides in elements
  long long k_sb, k_ss, k_skv;
  long long v_sb, v_ss, v_skv;
  long long o_sb, o_ss, o_skv, o_sg;
  int Sq, Skv, G;
  int causal, window;
  float softcap, scale;
  float* lse;  // (B, H, Sq) row log-sum-exp for the backward, or null
};

// Rows [r0, r0+64) of an (S, HD) matrix with row stride `ss` (elements)
// into shared memory with row stride `ds`; rows >= S are zeros. All loads
// are issued before any store, so they are in flight together.
template <int HD>
__device__ __forceinline__ void load_tile(const float* __restrict__ src,
                                          long long ss, int r0, int S,
                                          float* dst, int ds) {
  constexpr int kPerRow = HD / 4;
  constexpr int kIters = 64 * kPerRow / kThreads;
  static_assert(64 * kPerRow % kThreads == 0, "tile must split evenly");
  float4 raw[kIters];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int c = it * kThreads + threadIdx.x;
    const int r = c / kPerRow, d = (c % kPerRow) * 4;
    raw[it] = r0 + r < S ? *reinterpret_cast<const float4*>(
                               src + static_cast<long long>(r0 + r) * ss + d)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int c = it * kThreads + threadIdx.x;
    const int r = c / kPerRow, d = (c % kPerRow) * 4;
    *reinterpret_cast<float4*>(dst + r * ds + d) = raw[it];
  }
}

__device__ __forceinline__ float comp(const float4& a, int u) {
  return u == 0 ? a.x : u == 1 ? a.y : u == 2 ? a.z : a.w;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_f32_kernel(Params p) {
  using L = Layout<HD>;
  constexpr int kNJ = (HD + 63) / 64;  // float4 column groups per thread
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
  const float* qb = p.q + b * p.q_sb + kvh * p.q_skv + g * p.q_sg;
  const float* kb = p.k + b * p.k_sb + kvh * p.k_skv;
  const float* vb = p.v + b * p.v_sb + kvh * p.v_skv;
  float* ob = p.o + b * p.o_sb + kvh * p.o_skv + g * p.o_sg;

  load_tile<HD>(qb, p.q_ss, q0, p.Sq, Qs, L::kQS);

  // thread (ty, tx): q rows ty + 16i and, per tile, kv columns tx + 16j
  // (i, j < 4); output columns 4tx + 64jj .. +3 (jj < kNJ)
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  // column group jj of this thread lies inside the row (always, unless
  // HD is not a multiple of 64)
  auto col_live = [&](int jj) { return HD % 64 == 0 || 64 * jj + 4 * tx < HD; };
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
    load_tile<HD>(kb, p.k_ss, k0, p.Skv, Ks, L::kQS);
    load_tile<HD>(vb, p.v_ss, k0, p.Skv, Vs, HD);
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
          if (!col_live(jj)) continue;
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
    if (p.lse != nullptr && tx == 0)  // m + log l, one thread per row
      p.lse[(static_cast<long long>(b) * gridDim.y + h) * p.Sq + qi] = m[i] + logf(denom);
#pragma unroll
    for (int jj = 0; jj < kNJ; ++jj) {
      if (!col_live(jj)) continue;
      float4 x;
      x.x = __fdiv_rn(acc[i][jj][0], denom);
      x.y = __fdiv_rn(acc[i][jj][1], denom);
      x.z = __fdiv_rn(acc[i][jj][2], denom);
      x.w = __fdiv_rn(acc[i][jj][3], denom);
      *reinterpret_cast<float4*>(ob + static_cast<long long>(qi) * p.o_ss + 4 * tx +
                                 64 * jj) = x;
    }
  }
}

template <int HD>
cudaError_t launch_f32(const Params& p, int B, int H, cudaStream_t stream) {
  auto kern = flash_fwd_f32_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Layout<HD>::kBytes));
  if (err != cudaSuccess) return err;
  dim3 grid((p.Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, Layout<HD>::kBytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Both entry points take q, o: (B, Sq, KV, G, hd); k, v: (B, Skv, KV, hd),
// device pointers, 16-byte aligned, the last axis contiguous. `strides`
// holds 14 element strides: q's (b, s, kv, g), k's (b, s, kv), v's (b, s,
// kv), o's (b, s, kv, g); each a multiple of 16 bytes. hd is 64, 112, 128
// or 256. `lse`, when not null, receives the float32 row log-sum-exp of the
// masked scores, (B, KV * G, Sq) contiguous, which the backward
// (flash_attention_bwd.cu) reads; the serving path passes null. They
// launch on `stream` of CUDA device `device` and return the launch's
// cudaError_t (0 on success).

// bfloat16 tensors: the tensor-core kernel. Its tensor maps are encoded
// here at every call, over the real head dim; hd 112 runs the hd 128
// instantiation (see the note at the top).
int flash_attention_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                             int hd, int B, int Sq, int Skv, int KV, int G,
                             const long long* strides, int causal, int window,
                             float softcap, float scale, void* lse, int device,
                             void* stream) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Sq == 0 || B == 0) return 0;
  if (hd != 64 && hd != 112 && hd != 128 && hd != 256) return cudaErrorInvalidValue;
  const long long* st = strides;
  const long long q_dims[5] = {hd, G, KV, Sq, B};
  const long long q_str[4] = {st[3], st[2], st[1], st[0]};
  const long long k_dims[4] = {hd, KV, Skv, B};
  const long long k_str[3] = {st[6], st[5], st[4]};
  const long long v_str[3] = {st[9], st[8], st[7]};
  const long long o_str[4] = {st[13], st[12], st[11], st[10]};
  const uint32_t q_box[5] = {64, 1, 1, kTcBQ, 1};
  const uint32_t kv_box[4] = {64, 1, kBK, 1};
  const uint32_t o_box[5] = {64, 1, 1, 64, 1};
  CUtensorMap tq, tk, tv, to;
  if ((err = encode_map(&tq, q, 5, q_dims, q_str, q_box)) != cudaSuccess ||
      (err = encode_map(&tk, k, 4, k_dims, k_str, kv_box)) != cudaSuccess ||
      (err = encode_map(&tv, v, 4, k_dims, v_str, kv_box)) != cudaSuccess ||
      (err = encode_map(&to, o, 5, q_dims, o_str, o_box)) != cudaSuccess)
    return static_cast<int>(err);
  TcParams p;
  p.Sq = Sq;
  p.Skv = Skv;
  p.G = G;
  p.H = KV * G;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.softcap = softcap;
  p.inv_cap = softcap != 0.0f ? 1.0f / softcap : 0.0f;
  p.lse = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: err = launch_wgmma<64>(tq, tk, tv, to, p, B, s); break;
    case 112:  // zero-filled to 128 by TMA
    case 128: err = launch_wgmma<128>(tq, tk, tv, to, p, B, s); break;
    default: err = launch_wgmma<256>(tq, tk, tv, to, p, B, s); break;
  }
  return static_cast<int>(err);
}

// float32 tensors: the CUDA-core kernel.
int flash_attention_fwd_f32(const void* q, const void* k, const void* v, void* o,
                            int hd, int B, int Sq, int Skv, int KV, int G,
                            const long long* strides, int causal, int window,
                            float softcap, float scale, void* lse, int device,
                            void* stream) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Sq == 0 || B == 0) return 0;
  const long long* st = strides;
  Params p{static_cast<const float*>(q), static_cast<const float*>(k),
           static_cast<const float*>(v), static_cast<float*>(o),
           st[0], st[1], st[2], st[3],
           st[4], st[5], st[6],
           st[7], st[8], st[9],
           st[10], st[11], st[12], st[13],
           Sq, Skv, G, causal, window, softcap, scale, static_cast<float*>(lse)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: err = launch_f32<64>(p, B, KV * G, s); break;
    case 112: err = launch_f32<112>(p, B, KV * G, s); break;
    case 128: err = launch_f32<128>(p, B, KV * G, s); break;
    case 256: err = launch_f32<256>(p, B, KV * G, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
