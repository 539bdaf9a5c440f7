// Shared by every kernel source: the C entries take the caller's device index
// and make that device current themselves, so the Python wrappers enter no
// `torch.cuda.device` context.
#pragma once
#include <cuda_runtime.h>

namespace {

// Most device indices an entry takes (its per-device caches have this many slots).
constexpr int kMaxDevices = 64;

// Makes `device` current for the call's lifetime and restores the old one.
class DeviceScope {
 public:
  explicit DeviceScope(int device) {
    if (device < 0 || device >= kMaxDevices) {
      err_ = cudaErrorInvalidDevice;
      return;
    }
    err_ = cudaGetDevice(&old_);
    if (err_ == cudaSuccess && old_ != device) {
      err_ = cudaSetDevice(device);
      restore_ = err_ == cudaSuccess;
    }
  }
  ~DeviceScope() {
    if (restore_) cudaSetDevice(old_);
  }
  cudaError_t error() const { return err_; }

 private:
  int old_ = 0;
  bool restore_ = false;
  cudaError_t err_;
};

}  // namespace
