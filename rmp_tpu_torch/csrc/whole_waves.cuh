// Whole waves, for the launches of K3's and K5's wide kernels
// (fk_derivatives_wide.cu, fused_tick_wide.cu). An SM holds as many CTAs as
// a layout's shared memory (or the registers) let it. Where a grid needs
// more than one wave of them, the last wave is part-filled, and its few
// envs an SM each take a whole env's chain of dependent steps with the SM
// to spare (K3 at F = 40, n = 32, B = 4096: 1.29 waves of 24 envs an SM,
// 0.1652 ms; 0.1330 ms in two whole waves). So such a launch asks for more
// shared memory than the layout needs where that keeps the number of waves
// and makes them whole: the fewest CTAs an SM that take the grid in as many
// waves as the most would.
#pragma once

#include <cuda_runtime.h>

namespace rmp {

// The current device, its SM count, shared memory an SM and the part of it
// reserved a CTA (sms == 0 on an error).
struct SmShape {
  int device = -1, sms = 0, smem = 0, reserved = 0;
};

// The current device's SmShape, asked of the driver once per device.
inline SmShape current_sm_shape() {
  constexpr int kDevices = 16;  // devices whose attributes are kept
  static SmShape known[kDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kDevices)
    return SmShape{};
  SmShape& d = known[dev];
  if (d.sms == 0) {
    SmShape asked;
    asked.device = dev;
    if (cudaDeviceGetAttribute(
            &asked.smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(&asked.reserved,
                               cudaDevAttrReservedSharedMemoryPerBlock,
                               dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&asked.sms, cudaDevAttrMultiProcessorCount,
                               dev) != cudaSuccess)
      return SmShape{};
    d = asked;
  }
  return d;
}

// The dynamic shared memory a CTA of a grid of `grid` CTAs asks for, where
// a layout of `bytes` a CTA lets an SM of shape `d` hold `most` CTAs: the
// layout's own, or, where the grid takes more than one wave, the least size
// (in 128-byte units) at which no more CTAs fit an SM than the fewest that
// keep the number of waves.
inline int whole_wave_bytes(int bytes, int most, int grid, const SmShape& d) {
  if (d.sms <= 0 || most <= 0) return bytes;
  const int need = (grid + d.sms - 1) / d.sms;  // CTAs an SM takes in all
  if (need <= most) return bytes;
  const int waves = (need + most - 1) / most;
  const int fewest = (need + waves - 1) / waves;
  if (fewest >= most) return bytes;
  const int padded =
      (d.smem / (fewest + 1) - d.reserved + 1 + 127) / 128 * 128;
  return padded > bytes ? padded : bytes;
}

}  // namespace rmp
