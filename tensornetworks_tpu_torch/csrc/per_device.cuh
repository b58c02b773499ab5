// A host-side value made once for each device, at its first use while that
// device is current. The launchers cache their one-time setup this way:
// cudaFuncSetAttribute and the occupancy answers hold for one device only, so
// a process that launches on a second card sets it up there too.

#pragma once

#include <mutex>

#include <cuda_runtime.h>

namespace tn {

constexpr int kMaxDevices = 64;

template <class T>
class PerDevice {
 public:
  // The current device's value (`make()` runs at its first use there), or
  // null if the current device cannot be read or is beyond kMaxDevices.
  template <class F>
  const T* get(F make) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return nullptr;
    std::call_once(once_[dev], [&] { value_[dev] = make(); });
    return &value_[dev];
  }

 private:
  std::once_flag once_[kMaxDevices];
  T value_[kMaxDevices] = {};
};

}  // namespace tn
