// The calling thread's current CUDA device, for the scope of one launcher.
//
// Every extern "C" launcher takes the device of its tensors. It makes that
// device current for its launches and puts the caller's device back when it
// returns, on every return path, the error paths too: PyTorch reads the
// current device back from the runtime, so a launcher that left card 1
// current would send the caller's next `device="cuda"` allocation, its
// current stream and its graph captures there. The guard switches only when
// the target differs from the caller's device, so a launch on the current
// card costs one cudaGetDevice and nothing more.
#pragma once

#include <cuda_runtime.h>

struct DeviceGuard {
  int prev = -1;            // the caller's device, or -1 when nothing changed
  cudaError_t err;          // cudaSuccess unless querying or switching failed

  explicit DeviceGuard(int device) {
    int cur = -1;
    err = cudaGetDevice(&cur);
    if (err != cudaSuccess || cur == device) return;
    err = cudaSetDevice(device);
    if (err == cudaSuccess) prev = cur;
  }

  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }

  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
};
