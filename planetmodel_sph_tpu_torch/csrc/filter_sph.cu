// Rebuild-time true-pair candidate filter over the SPH window.
//
// Replaces: planetmodel_sph_tpu/ops/pallas/groups2.py filter_sph (:382),
// body _filter_kernel (:341).
//
//   keep[g, j] = 1 if some target i of group g has
//                r_ij^2 < (max(tc_i, sc_j) + tsk_i + ssk_j)^2,
//                with j < nv[g] and m_j > 0; else 0 (every slot written).
// tc/sc are kappa*(1+margin)*h scaled by the caller, tsk/ssk the skins.
//
// Bound on the H100: about 12 f32 operations per (target, slot) test
// against 24 bytes of source row read and 4 bytes of mask written per
// slot; with the early exit on the first hit the work is data dependent,
// and at the production windows reading the rows (~50 MB at the solve's
// widened window) is of the same order as the tests. Design: threads run
// over source slots, the group's B targets sit in shared memory, and each
// slot stops at its first interacting target. The library is built with
// -fmad=false so r2 and cut*cut round exactly as the plain version's
// separate multiplies and adds do: the mask must match bit for bit.
#include "common.cuh"

__global__ void filter_sph_kernel(
    const float* __restrict__ tx, const float* __restrict__ ty,
    const float* __restrict__ tz, const float* __restrict__ tc,
    const float* __restrict__ tsk, const float* __restrict__ sx,
    const float* __restrict__ sy, const float* __restrict__ sz,
    const float* __restrict__ sc, const float* __restrict__ ssk,
    const float* __restrict__ sm, const int* __restrict__ nv,
    float* __restrict__ keep, int b, int s) {
  extern __shared__ float tgt[];  // [5][b]: x, y, z, cut, skin
  const int g = blockIdx.x;
  const size_t t0 = (size_t)g * b;
  for (int i = threadIdx.x; i < b; i += blockDim.x) {
    tgt[i] = tx[t0 + i];
    tgt[b + i] = ty[t0 + i];
    tgt[2 * b + i] = tz[t0 + i];
    tgt[3 * b + i] = tc[t0 + i];
    tgt[4 * b + i] = tsk[t0 + i];
  }
  __syncthreads();
  const size_t row = (size_t)g * s;
  const int n = min(nv[g], s);
  for (int j = threadIdx.x; j < s; j += blockDim.x) {
    float out = 0.0f;
    if (j < n && sm[row + j] > 0.0f) {
      const float cx = sx[row + j], cy = sy[row + j], cz = sz[row + j];
      const float cc = sc[row + j], csk = ssk[row + j];
      for (int i = 0; i < b; ++i) {
        const float dxx = tgt[i] - cx;
        const float dxy = tgt[b + i] - cy;
        const float dxz = tgt[2 * b + i] - cz;
        const float r2 = dxx * dxx + dxy * dxy + dxz * dxz;
        const float cut = fmaxf(tgt[3 * b + i], cc) + tgt[4 * b + i] + csk;
        if (r2 < cut * cut) {
          out = 1.0f;
          break;
        }
      }
    }
    keep[row + j] = out;
  }
}

extern "C" int psph_filter_sph(
    const float* tx, const float* ty, const float* tz, const float* tc,
    const float* tsk, const float* sx, const float* sy, const float* sz,
    const float* sc, const float* ssk, const float* sm, const int* nv,
    float* keep, int g, int b, int s, void* stream) {
  if (g > 0)
    filter_sph_kernel<<<g, 256, 5 * b * sizeof(float),
                        (cudaStream_t)stream>>>(
        tx, ty, tz, tc, tsk, sx, sy, sz, sc, ssk, sm, nv, keep, b, s);
  return (int)cudaGetLastError();
}
