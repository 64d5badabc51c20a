// Grad-h density sweep over the SPH window.
//
// Replaces: planetmodel_sph_tpu/ops/pallas/groups2.py pass1_gradh (:250),
// body _pass1_gradh_kernel (:190).
//
// Per target i of group g, over the first nv[g] source slots j:
//   rho_i = (1/pi h_i^3)  sum_j m_j Wpoly(q),    q = |x_i - x_j| / h_i
//   xi_i  = -(1/pi h_i^4) sum_j m_j (3 Wpoly + q dWpoly/dq)
//   nn_i  = #{j : q < 2, m_j > 0}                (self pair included)
//
// Bound on the H100: about 30 f32 operations per pair against 16 bytes of
// source row per slot shared by the group's 64 targets, so pair arithmetic
// bounds it, not memory. Design: one thread block per target group, one
// thread per target; the group's source slots are staged PSPH_TILE at a
// time in shared memory (each slot read from device memory once per
// group) and every thread sweeps them from shared memory with its sums in
// registers. The loop stops at nv, so padding slots cost nothing. q comes
// from sqrtf(r2) * ih, as in the reference's pass 1. The library is built
// with -fmad=false so r2 rounds as the plain version's separate ops do and
// the q < 2 count matches it exactly.
#include "common.cuh"

__global__ void pass1_gradh_kernel(
    const float* __restrict__ tx, const float* __restrict__ ty,
    const float* __restrict__ tz, const float* __restrict__ tih,
    const float* __restrict__ sx, const float* __restrict__ sy,
    const float* __restrict__ sz, const float* __restrict__ sm,
    const int* __restrict__ nv, float* __restrict__ rho,
    int* __restrict__ nn, float* __restrict__ xi, int b, int s) {
  __shared__ float cx[PSPH_TILE], cy[PSPH_TILE], cz[PSPH_TILE],
      cm[PSPH_TILE];
  const int g = blockIdx.x;
  const int i = threadIdx.x;
  const size_t t = (size_t)g * b + i;
  const size_t row = (size_t)g * s;
  const float x = tx[t], y = ty[t], z = tz[t], ih = tih[t];
  const int n = min(nv[g], s);
  float s_rho = 0.0f, s_xi = 0.0f;
  int s_nn = 0;
  for (int base = 0; base < n; base += PSPH_TILE) {
    const int cnt = min(PSPH_TILE, n - base);
    for (int j = i; j < cnt; j += blockDim.x) {
      cx[j] = sx[row + base + j];
      cy[j] = sy[row + base + j];
      cz[j] = sz[row + base + j];
      cm[j] = sm[row + base + j];
    }
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const float dxx = x - cx[j];
      const float dxy = y - cy[j];
      const float dxz = z - cz[j];
      const float r2 = dxx * dxx + dxy * dxy + dxz * dxz;
      const float m = cm[j];
      const float q = sqrtf(r2) * ih;
      const float q2 = q * q;
      const float q3 = q2 * q;
      const float inner = 1.0f - 1.5f * q2 + 0.75f * q3;
      const float tt = 2.0f - q;
      const float tsq = tt * tt;
      float wpoly = 0.0f, dhpoly = 0.0f;
      if (q < 1.0f) {
        wpoly = inner;
        dhpoly = 3.0f * inner - 3.0f * q2 + 2.25f * q3;
      } else if (q < 2.0f) {
        wpoly = 0.25f * tsq * tt;
        dhpoly = 0.75f * tsq * (tt - q);
      }
      s_rho += m * wpoly;
      s_xi += m * dhpoly;
      s_nn += (q < 2.0f && m > 0.0f) ? 1 : 0;
    }
    __syncthreads();
  }
  const float ci3 = PSPH_INV_PI * (ih * ih * ih);
  rho[t] = ci3 * s_rho;
  xi[t] = -(ci3 * ih) * s_xi;
  nn[t] = s_nn;
}

extern "C" int psph_pass1_gradh(
    const float* tx, const float* ty, const float* tz, const float* tih,
    const float* sx, const float* sy, const float* sz, const float* sm,
    const int* nv, float* rho, int* nn, float* xi, int g, int b, int s,
    void* stream) {
  if (g > 0)
    pass1_gradh_kernel<<<g, b, 0, (cudaStream_t)stream>>>(
        tx, ty, tz, tih, sx, sy, sz, sm, nv, rho, nn, xi, b, s);
  return (int)cudaGetLastError();
}
