// Shared definitions of the windowed block-pair kernels.
//
// Layout contract (the same as the reference's Pallas sweeps): targets are
// [G*B] columns in the Morton-sorted padded layout, one group of B targets
// per thread block and one target per thread; sources are [G, S] window
// rows, of which the first nv[g] slots are valid. Padding and duplicate
// source slots carry m = 0, so they add exactly 0 to every sum. The self
// pair is included; callers correct it.
#pragma once

#include <cuda_runtime.h>

// source slots staged in shared memory per sweep step
#define PSPH_TILE 256

// 1/pi rounded once to float, as the plain versions' scalar is
#define PSPH_INV_PI 0.3183098861837907f

// Dyer-Ip softened point-mass term, accumulated into (phi, g). Finite at
// r = 0 (x = 0 takes the inner branch, dx = 0 kills the force); phi then
// holds the -2.4 m/a self term that the caller removes.
__device__ __forceinline__ void psph_dyer_ip(
    float m, float dxx, float dxy, float dxz, float r2, float inv_r,
    float inv_a, float& phi, float& gx, float& gy, float& gz) {
  const float x = (r2 * inv_r) * inv_a;
  const float x2 = x * x;
  const float x3 = x2 * x;
  float mag, p;
  if (x < 1.0f) {
    const float inv_a3 = inv_a * inv_a * inv_a;
    mag = (m * inv_a3) * (8.0f - 9.0f * x + 2.0f * x3);
    p = -(m * inv_a) * (2.4f - 4.0f * x2 + 3.0f * x3 - 0.4f * x2 * x3);
  } else {
    const float mr = m * inv_r;
    mag = mr * inv_r * inv_r;
    p = -mr;
  }
  phi += p;
  gx += dxx * mag;
  gy += dxy * mag;
  gz += dxz * mag;
}
