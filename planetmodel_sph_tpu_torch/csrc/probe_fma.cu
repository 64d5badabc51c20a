// f32 FMA-rate probe.
//
// Replaces: tools/roofline.py _vpu_kernel (:78-89), launched by
// measure_vpu (:97): acc = v, then reps times acc = acc * v + v four times.
//
// Bound on the H100: operations only. The function reads each element
// once and writes it once (8 bytes) against 8 * reps f32 operations (four
// fused multiply-adds per rep, two operations each), so at reps = 512 it
// needs 4,096 operations per 8 bytes, some 25 times the card's f32
// operations-per-byte balance. Design: one thread per element, v loaded
// once into a register, the 4 * reps dependent FMAs kept in registers, one
// store. The chain runs in the written order (fmaf, which nvcc neither
// reorders nor folds: reps and v are runtime values), and enough warps
// are resident (256 x 512 elements = 4,096 warps over 132 SMs) to hide
// each FMA's latency. The library keeps multiply-add contraction on: with
// -fmad=false the chain would be a multiply and an add, half the rate
// this probe exists to measure. Each step therefore rounds once, where
// the plain version's acc * v + v rounds twice.
#include <cuda_runtime.h>

__global__ void probe_fma_kernel(const float* __restrict__ x,
                                 float* __restrict__ o, int n, int reps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float v = x[i];
  float acc = v;
  for (int r = 0; r < reps; ++r) {
    acc = fmaf(acc, v, v);
    acc = fmaf(acc, v, v);
    acc = fmaf(acc, v, v);
    acc = fmaf(acc, v, v);
  }
  o[i] = acc;
}

extern "C" int psph_probe_fma(const float* x, float* o, int n, int reps,
                              void* stream) {
  if (n > 0)
    probe_fma_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
        x, o, n, reps);
  return (int)cudaGetLastError();
}
