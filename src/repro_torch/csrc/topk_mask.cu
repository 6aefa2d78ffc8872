// Exact top-k threshold bits per session, by a multi-block radix select
// over the float32 bit space.
//
// Replaces: src/repro/kernels/topk_mask/topk_mask.py
//   topk_threshold_bits_3d.
//
// What it computes: for each session b of a (B, n) buffer of |u| float32
// bit patterns (sign cleared, zero-padded), the bit pattern of the k-th
// largest value, sort(|u|)[n - k], exactly: what the counting search of
// the plain version (bits 30..0 decided one at a time) returns.
// Non-negative floats order as their bit patterns, NaN above inf. Zero
// padding is counted like any zero, so the result is 0 when fewer than k
// values are non-zero, as the counting search gives. A pattern with the
// sign bit set (never produced by the wrapper's |u|) counts as 0, as it
// does in the counting search's int32 compare. The caller turns the bits
// back into a float and builds the masks with a float `|u| >= thr`
// compare, so the masks equal the sort path's, NaN included.
//
// What bounds it on an H100: bytes, at one 4-byte read per coordinate
// (B=8 x 334,464 padded coordinates are 10.7 MB, ~3.2 us at 3.35 TB/s).
//
// What the design does about it: a few digit passes instead of 31
// counting passes, each over many blocks per session.
//   - Digits: bits 30..0 in the widths the caller gives (11 + 10 + 10 on
//     the selection path). Pass p builds, per session, the histogram of
//     the next digit among the values whose higher bits equal the prefix
//     found so far: a shared-memory histogram per block (atomics), merged
//     into the session's global histogram with one atomicAdd per non-zero
//     bin. A scan from the top bin then picks the digit at which the
//     running count reaches the remaining k, and lowers the remaining k by
//     the count above that bin. Each pass selects exactly, so any digit
//     schedule returns the counting search's bits.
//   - Blocks: a grid of (blocks per session, B), about kBlocksPerSM blocks
//     per SM over the whole grid, so that B = 8 sessions run on 33 blocks
//     each over the 132 SMs, not on 8 blocks; 16-byte loads, 4 in flight
//     per thread. Passes after the first re-read the session's bits from
//     L2 (10.7 MB at B = 8, inside its 50 MB).
//   - Between passes: one launch per pass. The last block of a session
//     to finish a pass (an atomic counter) scans that session's histogram
//     and writes the prefix and remaining k that the next pass reads, or,
//     after the last pass, the result. A cooperative launch with grid-wide
//     syncs would save the launch gaps, but needs every block resident at
//     once (a grid bounded by the occupancy, whatever B is) and syncs the
//     whole grid where only a session's blocks depend on each other; one
//     launch per pass takes any B and any n, and costs ~3 launches.
//   - Scratch (histograms, counters, prefixes) is the caller's, zeroed
//     (`topk_scratch_words` ints per session); the kernel allocates
//     nothing. Counts are 32-bit: n < 2^31.
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDigitBits = 11;
constexpr int kMaxBins = 1 << kMaxDigitBits;
constexpr int kMaxBinsPerThread = kMaxBins / kThreads;
constexpr int kMaxPasses = 4;
constexpr int kBlocksPerSM = 2;       // blocks of the whole grid per SM
constexpr int kMinLoadsPerThread = 8; // 16-byte loads a thread makes at least
constexpr int kUnroll = 4;            // 16-byte loads in flight per thread

// One pass: the digit is bits [shift, shift + width); offsets are into a
// session's scratch; state_in < 0 for the first pass, state_out < 0 for
// the last (which writes the result instead).
struct Pass {
  int shift, width, hist, done, state_in, state_out;
};

// Count one bit pattern into the block's histogram if its bits above the
// digit equal the prefix's (`want`).
__device__ __forceinline__ void count(uint32_t v, int hi, uint32_t want,
                                      int shift, uint32_t dmask, int* hist) {
  v = (v & 0x80000000u) ? 0u : v;  // as the int32 counting search: below every candidate
  if ((v >> hi) == want) atomicAdd(&hist[(v >> shift) & dmask], 1);
}

__device__ __forceinline__ void count4(const uint4& q, int hi, uint32_t want,
                                       int shift, uint32_t dmask, int* hist) {
  count(q.x, hi, want, shift, dmask, hist);
  count(q.y, hi, want, shift, dmask, hist);
  count(q.z, hi, want, shift, dmask, hist);
  count(q.w, hi, want, shift, dmask, hist);
}

__global__ void __launch_bounds__(kThreads)
radix_select_pass_kernel(const uint4* __restrict__ bits, long long n4, int k,
                         Pass ps, int* __restrict__ scratch, long long words,
                         int* __restrict__ out) {
  __shared__ int hist[kMaxBins];
  __shared__ int warp_tot[kWarps];
  __shared__ int last;
  const int b = blockIdx.y;
  int* sess = scratch + static_cast<long long>(b) * words;
  const int bins = 1 << ps.width;
  uint32_t prefix = 0;
  int krem = k;
  if (ps.state_in >= 0) {
    prefix = static_cast<uint32_t>(sess[ps.state_in]);
    krem = sess[ps.state_in + 1];
  }
  const int hi = ps.shift + ps.width;  // <= 31: bits 30..hi are decided
  const uint32_t want = prefix >> hi;
  const uint32_t dmask = static_cast<uint32_t>(bins - 1);

  for (int i = threadIdx.x; i < bins; i += kThreads) hist[i] = 0;
  __syncthreads();

  const uint4* base = bits + static_cast<long long>(b) * n4;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < n4; i += kUnroll * stride) {
    uint4 q[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) q[u] = base[i + u * stride];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) count4(q[u], hi, want, ps.shift, dmask, hist);
  }
  for (; i < n4; i += stride) count4(base[i], hi, want, ps.shift, dmask, hist);
  __syncthreads();

  // merge into the session's histogram; the last block of the session on
  // this pass goes on to scan it
  for (int j = threadIdx.x; j < bins; j += kThreads) {
    const int c = hist[j];
    if (c) atomicAdd(&sess[ps.hist + j], c);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&sess[ps.done], 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // Scan from the top bin. Thread t owns `per` bins from the top down,
  // starting at bins - 1 - t * per; `above` is the count in the bins of
  // the threads before it (all higher).
  const int per = (bins + kThreads - 1) / kThreads;
  const int top = bins - 1 - static_cast<int>(threadIdx.x) * per;
  int cnt[kMaxBinsPerThread];
  int sum = 0;
#pragma unroll
  for (int j = 0; j < kMaxBinsPerThread; ++j) {
    cnt[j] = (j < per && top - j >= 0) ? __ldcg(&sess[ps.hist + top - j]) : 0;
    sum += cnt[j];
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  int above = incl - sum;
  for (int w = 0; w < warp; ++w) above += warp_tot[w];
  // exactly one thread holds the bin where the running count reaches krem
  if (above < krem && krem <= above + sum) {
    int digit = top;
#pragma unroll
    for (int j = 0; j < kMaxBinsPerThread; ++j) {
      if (above + cnt[j] >= krem) {
        digit = top - j;
        break;
      }
      above += cnt[j];
    }
    const uint32_t next = prefix | (static_cast<uint32_t>(digit) << ps.shift);
    if (ps.state_out >= 0) {
      sess[ps.state_out] = static_cast<int>(next);
      sess[ps.state_out + 1] = krem - above;
    } else {
      out[b] = static_cast<int>(next);
    }
  }
}

// The passes for a digit schedule, from bit 30 down, and the ints of
// scratch a session needs (0 if the schedule is not one this kernel
// takes: 1..kMaxPasses digits of 1..kMaxDigitBits bits summing to 31).
long long layout(const int* digit_bits, int passes, Pass* ps) {
  if (passes < 1 || passes > kMaxPasses) return 0;
  int shift = 31;
  long long off = 0;
  for (int p = 0; p < passes; ++p) {
    const int w = digit_bits[p];
    if (w < 1 || w > kMaxDigitBits) return 0;
    shift -= w;
    ps[p].shift = shift;
    ps[p].width = w;
    ps[p].hist = static_cast<int>(off);
    off += 1 << w;
  }
  if (shift != 0) return 0;
  for (int p = 0; p < passes; ++p) {
    ps[p].done = static_cast<int>(off + p);
    ps[p].state_in = p == 0 ? -1 : static_cast<int>(off + passes + 2 * (p - 1));
    ps[p].state_out = p == passes - 1 ? -1 : static_cast<int>(off + passes + 2 * p);
  }
  off += passes + 2 * (passes - 1);
  return (off + 3) / 4 * 4;
}

int sm_count(int device) {
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) != cudaSuccess
      || n <= 0)
    return 132;
  return n;
}

}  // namespace

extern "C" {

// Ints of zeroed scratch `topk_threshold_bits` needs per session for this
// digit schedule; 0 if it does not take the schedule.
long long topk_scratch_words(const int* digit_bits, int passes) {
  Pass ps[kMaxPasses];
  return layout(digit_bits, passes, ps);
}

// Blocks per session of the grid for B sessions of n coordinates.
int topk_blocks_per_session(long long n, int B, int device) {
  const long long target = static_cast<long long>(kBlocksPerSM) * sm_count(device);
  long long bps = (target + B - 1) / B;
  long long cap = n / 4 / (static_cast<long long>(kThreads) * kMinLoadsPerThread);
  if (cap < 1) cap = 1;
  if (bps > cap) bps = cap;
  return static_cast<int>(bps < 1 ? 1 : bps);
}

// `bits`: device pointer to a (B, n) contiguous uint32 buffer, 16-byte
// aligned, n a multiple of 4 and below 2^31, 1 <= k <= n, 1 <= B <= 65535;
// `digit_bits` (host) the digit widths from bit 30 down; `scratch`: B *
// topk_scratch_words ints of zeroed device memory; `out`: (B,) int32.
// Launches one kernel per digit on `stream` of CUDA device `device` and
// returns the first failed launch's cudaError_t (0 on success).
int topk_threshold_bits(const void* bits, long long n, long long k, int B,
                        const int* digit_bits, int passes, void* scratch,
                        void* out, int device, void* stream) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return static_cast<int>(err);
  Pass ps[kMaxPasses];
  const long long words = layout(digit_bits, passes, ps);
  if (!words || n % 4 || n >= (1LL << 31) || k < 1 || k > n || B < 1 || B > 65535 ||
      reinterpret_cast<uintptr_t>(bits) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(topk_blocks_per_session(n, B, device), B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int p = 0; p < passes; ++p) {
    radix_select_pass_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const uint4*>(bits), n / 4, static_cast<int>(k), ps[p],
        static_cast<int*>(scratch), words, static_cast<int*>(out));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
