// Fused masked-Adam step for a stack of B sessions (Algorithm 2, lines 8-13),
// with the LLM trainer's global-norm clip folded in.
//
// Replaces: src/repro/kernels/masked_adam/masked_adam.py
//   masked_adam_stacked_3d (and masked_adam_2d, its B=1 form).
//
// What it computes, per coordinate of session b, in float32:
//   m' = b1*m + (1-b1)*g
//   v' = b2*v + (1-b2)*(g*g)
//   u  = bc[b]*m' / sqrt(v' + eps)
//   p' = p - u*mask
// p, g, m and v may each be float32, bfloat16 or float16 (the step is
// computed in float32 and stored back in each tensor's own type); the mask
// is one byte per coordinate; u is always float32.
//
// With a device pointer to the global gradient norm gn (grad_norm.cu), the
// JAX trainer's clip (src/repro/launch/train.py:59-69) comes first:
//   scale = min(1, clip / max(gn, 1e-9))
//   g     = (isfinite(gn) && isfinite(g)) ? g*scale : 0, rounded to g's type
// and the clipped g is written back over g (the trainer's state keeps the
// clipped gradients, as the JAX step's `grads` are). Without gn the kernel
// reads g only and its arithmetic is the unclipped step's.
//
// What bounds it on an H100: bytes. It does ~10 float operations for
// every 33 bytes it moves (f32 p/g/m/v read, 1-byte mask read, p/m/v/u
// written), so device memory bandwidth is the limit: B=8 x 334,405
// coordinates move 88.3 MB, ~26 us at 3.35 TB/s; Gemma 2B's in-place bf16
// step with the clip moves 25 bytes a coordinate, 62.7 GB, ~18.7 ms.
//
// What the design does about it: one pass, every byte touched once. Each
// thread handles 8 consecutive coordinates at a time with 16-byte loads and
// stores (vec8.cuh), neighbouring threads on neighbouring addresses. The
// grid is one-dimensional over all B sessions' 8-coordinate vectors, with
// a block size and a block count that the wrapper picks
// (kernels/masked_adam/ops.launch_shape); each thread strides over the
// grid, so a grid smaller than the work is allowed. On an H100, blocks of
// 64 threads spread a B=1 call (11 MB) over all 132 SMs, ~5 blocks each,
// where 256-thread blocks gave 32 SMs two blocks and 100 one (0.0059 ms
// against 0.0071); a grid of 512 threads an SM that strides over B=8's
// 1.3 waves ends without a partial wave (0.0348 ms against 0.0369). The
// buffers come from
// `repro_torch.kernels.stacking`: rows of 128, so n is a multiple of 8 and
// there is no ragged tail. The arithmetic uses the IEEE-rounded intrinsics
// in the plain version's order (and the library is built with -fmad=false),
// so the kernel equals its plain PyTorch version bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "vec8.cuh"

namespace {

using vec8::kVec;
using vec8::load8;
using vec8::store8;

constexpr int kMaxThreads = 256;

struct Args {
  const void* p; void* g; const void* m; const void* v;
  const uint8_t* mask; const float* bc;
  const float* gn;  // the global gradient norm, or null: no clip
  void* p_out; void* m_out; void* v_out; float* u_out;
  long long n;     // coordinates per session (a multiple of kVec)
  long long vecs;  // kVec-coordinate vectors over all sessions
  int sessions;
  int p_dt, g_dt, m_dt, v_dt;
  float b1, omb1, b2, omb2, eps, clip;
};

__global__ void __launch_bounds__(kMaxThreads) masked_adam_kernel(Args a) {
  bool ok = true;
  float scale = 1.0f;
  if (a.gn != nullptr) {
    const float gn = *a.gn;
    ok = isfinite(gn);
    scale = fminf(1.0f, __fdiv_rn(a.clip, fmaxf(gn, 1e-9f)));
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long vec = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       vec < a.vecs; vec += stride) {
    const long long at = vec * kVec;
    const float bc = a.bc[a.sessions == 1 ? 0 : at / a.n];

    float p[kVec], g[kVec], m[kVec], v[kVec], u[kVec], mf[kVec];
    load8(a.p, a.p_dt, at, p);
    load8(a.g, a.g_dt, at, g);
    load8(a.m, a.m_dt, at, m);
    load8(a.v, a.v_dt, at, v);
    uint2 mb = *reinterpret_cast<const uint2*>(a.mask + at);
    const uint8_t* mbytes = reinterpret_cast<const uint8_t*>(&mb);

    if (a.gn != nullptr) {
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        g[j] = vec8::round_to((ok && isfinite(g[j])) ? __fmul_rn(g[j], scale) : 0.0f,
                              a.g_dt);
      store8(a.g, a.g_dt, at, g);
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      mf[j] = mbytes[j] ? 1.0f : 0.0f;
      m[j] = __fadd_rn(__fmul_rn(a.b1, m[j]), __fmul_rn(a.omb1, g[j]));
      v[j] = __fadd_rn(__fmul_rn(a.b2, v[j]),
                       __fmul_rn(a.omb2, __fmul_rn(g[j], g[j])));
      u[j] = __fdiv_rn(__fmul_rn(bc, m[j]), __fsqrt_rn(__fadd_rn(v[j], a.eps)));
      p[j] = __fsub_rn(p[j], __fmul_rn(u[j], mf[j]));
    }
    store8(a.p_out, a.p_dt, at, p);
    store8(a.m_out, a.m_dt, at, m);
    store8(a.v_out, a.v_dt, at, v);
    store8(a.u_out, vec8::kF32, at, u);
  }
}

}  // namespace

extern "C" {

// Pointers are device pointers to (B, n) contiguous buffers, 16-byte
// aligned; dtype codes are 0 float32, 1 bfloat16, 2 float16. gn is a
// device pointer to one float32 (the clip's global norm) or null. The grid
// is `blocks` blocks of `threads` threads (a multiple of 32, at most 256).
// Launches on `stream` of CUDA device `device` and returns the launch's
// cudaError_t (0 on success).
int masked_adam_3d(const void* p, int p_dt, void* g, int g_dt,
                   const void* m, int m_dt, const void* v, int v_dt,
                   const void* mask, const void* bc, const void* gn, float clip,
                   void* p_out, void* m_out, void* v_out, void* u_out,
                   long long n, int B, float b1, float omb1, float b2,
                   float omb2, float eps, int threads, int blocks, int device,
                   void* stream) {
  if (threads < 32 || threads > kMaxThreads || threads % 32 || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const DeviceGuard guard(device);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a{p, g, m, v, static_cast<const uint8_t*>(mask),
         static_cast<const float*>(bc), static_cast<const float*>(gn),
         p_out, m_out, v_out, static_cast<float*>(u_out),
         n, n / kVec * B, B, p_dt, g_dt, m_dt, v_dt,
         b1, omb1, b2, omb2, eps, clip};
  masked_adam_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
