// Grad-h pressure-gradient sweep with fused near-field gravity and the
// merged residual-P2P window.
//
// Replaces: planetmodel_sph_tpu/ops/pallas/groups2.py pass2 (:649), body
// _pass2_kernel (:440), in the configuration the production step runs:
// mode "grad_h", grav=True, receiver_soft=False (softening
// a = min(h_i, h_j), i.e. inv_a = min(ih_i, ih_j)), and the residual-P2P
// rows swept into the same gravity sums (:578-619).
//
// Per target i of group g:
//   over the SPH window (nv[g] slots, rows x, y, z, ih, m, cc):
//     gp_i  += m_j (tc_i gw(q_i, h_i) + cc_j gw(q_j, h_j)) (x_i - x_j)
//     Dyer-Ip phi, g and the count of m_j > 0 on the same pair geometry
//   over the residual-P2P window (nv2[g] slots, rows x, y, z, ih, m):
//     Dyer-Ip phi, g and the count into the same gravity sums
// Outputs gp (unscaled; the caller applies rho_i), g_const * (phi, g) and
// the direct count, self pair included in both windows' terms.
//
// Bound on the H100: about 80 f32 operations per SPH slot and 30 per P2P
// slot for each of the group's 64 targets, against 24 (SPH) and 20 (P2P)
// bytes of source row per slot read once per group: pair arithmetic bounds
// it. Design: one thread block per target group, one thread per target,
// source slots staged PSPH_TILE at a time in shared memory, sums in
// registers, loops that stop at nv and nv2. r and 1/r come from one
// rsqrtf(max(r2, 1e-30)) per pair, so the self pair gives dx = 0, zero
// force and the finite inner Dyer-Ip potential.
#include "common.cuh"

// (dW/dr)/r with its prefactors; finite at r = 0 (inner branch, no 1/r)
__device__ __forceinline__ float gw_from(float q, float inv_h, float inv_h4,
                                         float inv_r) {
  float val = 0.0f;
  if (q < 1.0f) {
    val = (-3.0f + 2.25f * q) * inv_h;
  } else if (q < 2.0f) {
    const float t = 2.0f - q;
    val = (-0.75f * t * t) * inv_r;
  }
  return (PSPH_INV_PI * inv_h4) * val;
}

__global__ void pass2_kernel(
    const float* __restrict__ tx, const float* __restrict__ ty,
    const float* __restrict__ tz, const float* __restrict__ tih,
    const float* __restrict__ tc, const float* __restrict__ sx,
    const float* __restrict__ sy, const float* __restrict__ sz,
    const float* __restrict__ sih, const float* __restrict__ sm,
    const float* __restrict__ scc, const float* __restrict__ px,
    const float* __restrict__ py, const float* __restrict__ pz,
    const float* __restrict__ pih, const float* __restrict__ pm,
    const int* __restrict__ nv, const int* __restrict__ nv2,
    float* __restrict__ gpx, float* __restrict__ gpy,
    float* __restrict__ gpz, float* __restrict__ phi_out,
    float* __restrict__ gx_out, float* __restrict__ gy_out,
    float* __restrict__ gz_out, int* __restrict__ nd_out, int b, int s,
    int s2, float g_const) {
  __shared__ float cx[PSPH_TILE], cy[PSPH_TILE], cz[PSPH_TILE],
      cih[PSPH_TILE], cm[PSPH_TILE], ccc[PSPH_TILE];
  const int g = blockIdx.x;
  const int i = threadIdx.x;
  const size_t t = (size_t)g * b + i;
  const float x = tx[t], y = ty[t], z = tz[t], ih = tih[t], tcv = tc[t];
  float tih4 = ih * ih;
  tih4 = tih4 * tih4;
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  float phi = 0.0f, gx = 0.0f, gy = 0.0f, gz = 0.0f;
  int nd = 0;

  // SPH window: pressure gradient + fused Dyer-Ip gravity
  size_t row = (size_t)g * s;
  int n = min(nv[g], s);
  for (int base = 0; base < n; base += PSPH_TILE) {
    const int cnt = min(PSPH_TILE, n - base);
    for (int j = i; j < cnt; j += blockDim.x) {
      cx[j] = sx[row + base + j];
      cy[j] = sy[row + base + j];
      cz[j] = sz[row + base + j];
      cih[j] = sih[row + base + j];
      cm[j] = sm[row + base + j];
      ccc[j] = scc[row + base + j];
    }
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const float dxx = x - cx[j];
      const float dxy = y - cy[j];
      const float dxz = z - cz[j];
      const float r2 = dxx * dxx + dxy * dxy + dxz * dxz;
      const float m = cm[j];
      const float jh = cih[j];
      const float inv_r = rsqrtf(fmaxf(r2, 1e-30f));
      const float r = r2 * inv_r;
      float jh4 = jh * jh;
      jh4 = jh4 * jh4;
      const float gw_i = gw_from(r * ih, ih, tih4, inv_r);
      const float gw_j = gw_from(r * jh, jh, jh4, inv_r);
      const float coef = m * (tcv * gw_i + ccc[j] * gw_j);
      ax += dxx * coef;
      ay += dxy * coef;
      az += dxz * coef;
      psph_dyer_ip(m, dxx, dxy, dxz, r2, inv_r, fminf(ih, jh), phi, gx, gy,
                   gz);
      nd += (m > 0.0f) ? 1 : 0;
    }
    __syncthreads();
  }

  // residual-P2P window into the same gravity sums
  row = (size_t)g * s2;
  n = min(nv2[g], s2);
  for (int base = 0; base < n; base += PSPH_TILE) {
    const int cnt = min(PSPH_TILE, n - base);
    for (int j = i; j < cnt; j += blockDim.x) {
      cx[j] = px[row + base + j];
      cy[j] = py[row + base + j];
      cz[j] = pz[row + base + j];
      cih[j] = pih[row + base + j];
      cm[j] = pm[row + base + j];
    }
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const float dxx = x - cx[j];
      const float dxy = y - cy[j];
      const float dxz = z - cz[j];
      const float r2 = dxx * dxx + dxy * dxy + dxz * dxz;
      const float m = cm[j];
      const float inv_r = rsqrtf(fmaxf(r2, 1e-30f));
      psph_dyer_ip(m, dxx, dxy, dxz, r2, inv_r, fminf(ih, cih[j]), phi, gx,
                   gy, gz);
      nd += (m > 0.0f) ? 1 : 0;
    }
    __syncthreads();
  }

  gpx[t] = ax;
  gpy[t] = ay;
  gpz[t] = az;
  phi_out[t] = g_const * phi;
  gx_out[t] = g_const * gx;
  gy_out[t] = g_const * gy;
  gz_out[t] = g_const * gz;
  nd_out[t] = nd;
}

extern "C" int psph_pass2(
    const float* tx, const float* ty, const float* tz, const float* tih,
    const float* tc, const float* sx, const float* sy, const float* sz,
    const float* sih, const float* sm, const float* scc, const float* px,
    const float* py, const float* pz, const float* pih, const float* pm,
    const int* nv, const int* nv2, float* gpx, float* gpy, float* gpz,
    float* phi, float* gx, float* gy, float* gz, int* nd, int g, int b,
    int s, int s2, float g_const, void* stream) {
  if (g > 0)
    pass2_kernel<<<g, b, 0, (cudaStream_t)stream>>>(
        tx, ty, tz, tih, tc, sx, sy, sz, sih, sm, scc, px, py, pz, pih, pm,
        nv, nv2, gpx, gpy, gpz, phi, gx, gy, gz, nd, b, s, s2, g_const);
  return (int)cudaGetLastError();
}
