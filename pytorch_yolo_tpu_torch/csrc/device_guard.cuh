// The current device around one C entry point of the kernel library.
//
// Each entry launches on the device it is given.  DeviceGuard makes that
// device current for the life of the guard and gives the calling thread
// its own current device back when the guard ends, on every return path:
// a launch on one card of a batch mesh leaves torch's current device as
// it found it.
#pragma once

#include <cuda_runtime.h>

namespace {

struct DeviceGuard {
  int prev = -1;
  bool moved = false;
  cudaError_t err = cudaSuccess;

  explicit DeviceGuard(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) {
      err = cudaSetDevice(device);
      moved = true;
    }
  }
  ~DeviceGuard() {
    if (moved) cudaSetDevice(prev);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
};

}  // namespace
