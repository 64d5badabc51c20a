// All-pairs pressure gradient, with the optional fused Monaghan viscosity
// and Balsara div/curl sums.
//
// Replaces: planetmodel_sph_tpu/ops/pallas/pairwise.py pass2 (:284), body
// _pass2_kernel (:158).
//
// Per target i, over every source j != i, with g = (gw(r, h_i) + gw(r,
// h_j)) / 2 and gw = (dW/dr)/r (sign_bug: the reference's +3q inner
// branch):
//   asymmetric: grad P_i = sum_j m_j (P_j / rho_j) g (x_i - x_j)
//   symmetric:  grad P_i = rho_i sum_j m_j (P_i/rho_i^2 + P_j/rho_j^2) g
//                          (x_i - x_j)
//   av:      + rho_i sum_j m_j Pi_ij g_av (x_i - x_j), Pi_ij the Monaghan
//            term on approaching pairs, g_av ALWAYS the correct derivative
//   balsara: Pi_ij *= (f_i + f_j)/2, and the raw sums
//            dc_i = sum_j m_j g_av (v_ij . x_ij, v_ij x x_ij)
//
// Bound on the H100: pair arithmetic, as pass 1. Design: as pass 1 (one
// thread per target, sources staged in shared memory, the source range
// split over blockIdx.y and the partial sums added in split order by a
// second kernel). Every term of a pair carries a kernel-gradient factor,
// so a pair outside both supports adds exactly 0 and is skipped before any
// of the pressure or viscosity math, unless a NaN or an infinity could
// reach the sums through it: the plain version multiplies it by a gradient
// of 0, and a non-finite field times 0 is NaN. So a tile in which a staged
// field (or the factor formed from them) is not finite, and a target with
// a non-finite value in what it reads of itself, skip nothing (all_pairs:
// set once a tile at the staging and once a target; it zeroes the gate's
// 1/h_i, so that the gate costs what it did), and the gate "r/h_i >= 2 and
// r/h_j >= 2" leaves out no pair with a NaN in r or either 1/h. A flagged
// target also visits its self pair with m = 0, as the plain version
// weighs it: 0 times its own non-finite value is NaN there. The
// per-source factor P_j/rho_j (or P_j/rho_j^2) is formed once when the
// tile is staged. This kernel decides
// only through q < 1, q < 2 inside continuous functions and v.x < 0, its
// sums are held to a tolerance, and it keeps multiply-add contraction.
#include "common.cuh"

#define PW_TILE 128

// (dW/dr)/r from r and 1/h; finite at r = 0 (q = 0 takes the inner branch)
__device__ __forceinline__ float pw_gw(float r, float q, float ih,
                                       float lin) {
  const float c = PSPH_INV_PI * (ih * ih * ih * ih);
  if (q < 1.0f) return (lin + 2.25f * q) * c * ih;
  if (q < 2.0f) {
    const float t = 2.0f - q;
    return (-0.75f * t * t) * c / r;
  }
  return 0.0f;
}

template <bool AV, bool BAL>
__global__ void pairwise_pass2_kernel(
    const float* __restrict__ pos, const float* __restrict__ inv_h,
    const float* __restrict__ mass, const float* __restrict__ rho,
    const float* __restrict__ prs, const float* __restrict__ vel,
    const float* __restrict__ hh, const float* __restrict__ cs,
    const float* __restrict__ fb, float* __restrict__ part, int n, int chunk,
    int asymmetric, int sign_bug, float av_alpha, float av_beta) {
  constexpr int NOUT = BAL ? 7 : 3;
  __shared__ float cx[PW_TILE], cy[PW_TILE], cz[PW_TILE], cih[PW_TILE],
      cm[PW_TILE], cp[PW_TILE];
  __shared__ float cvx[AV ? PW_TILE : 1], cvy[AV ? PW_TILE : 1],
      cvz[AV ? PW_TILE : 1], chh[AV ? PW_TILE : 1], ccs[AV ? PW_TILE : 1],
      crho[AV ? PW_TILE : 1], cfb[BAL ? PW_TILE : 1];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const int j0 = blockIdx.y * chunk;
  const int j1 = min(n, j0 + chunk);
  const float lin = sign_bug ? 3.0f : -3.0f;
  float x = 0.0f, y = 0.0f, z = 0.0f, ih = 1.0f, ri = 1.0f, pi_i = 0.0f;
  float vx = 0.0f, vy = 0.0f, vz = 0.0f, hi = 1.0f, csi = 0.0f, fbi = 1.0f;
  if (live) {
    x = pos[3 * (size_t)i];
    y = pos[3 * (size_t)i + 1];
    z = pos[3 * (size_t)i + 2];
    ih = inv_h[i];
    ri = rho[i];
    pi_i = prs[i] / (ri * ri);
    if constexpr (AV) {
      vx = vel[3 * (size_t)i];
      vy = vel[3 * (size_t)i + 1];
      vz = vel[3 * (size_t)i + 2];
      hi = hh[i];
      csi = cs[i];
    }
    if constexpr (BAL) fbi = fb[i];
  }
  const float own[12] = {x, y, z, ih, ri, pi_i, vx, vy, vz, hi, csi, fbi};
  const bool target_bad = !psph_all_finite(own);
  float acc[NOUT];
#pragma unroll
  for (int k = 0; k < NOUT; ++k) acc[k] = 0.0f;
  for (int base = j0; base < j1; base += PW_TILE) {
    const int cnt = min(PW_TILE, j1 - base);
    bool bad = false;
    for (int k = threadIdx.x; k < cnt; k += blockDim.x) {
      const size_t j = (size_t)base + k;
      const float rj = rho[j];
      float v[13] = {pos[3 * j], pos[3 * j + 1], pos[3 * j + 2], inv_h[j],
                     mass[j], asymmetric ? prs[j] / rj : prs[j] / (rj * rj),
                     rj, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      cx[k] = v[0];
      cy[k] = v[1];
      cz[k] = v[2];
      cih[k] = v[3];
      cm[k] = v[4];
      cp[k] = v[5];
      if constexpr (AV) {
        v[7] = cvx[k] = vel[3 * j];
        v[8] = cvy[k] = vel[3 * j + 1];
        v[9] = cvz[k] = vel[3 * j + 2];
        v[10] = chh[k] = hh[j];
        v[11] = ccs[k] = cs[j];
        crho[k] = rj;
      }
      if constexpr (BAL) v[12] = cfb[k] = fb[j];
      bad = bad || !psph_all_finite(v);
    }
    const bool tile_bad = __syncthreads_or(bad) != 0;
    const bool all_pairs = tile_bad || target_bad;
    // the gate's 1/h_i for this tile: 0 gates out nothing
    const float ih_gate = all_pairs ? 0.0f : ih;
    if (live) {
      // one pair's terms with mass m (0 for the self pair, as the plain
      // version weighs it)
      auto pair = [&](int k, float m) {
        const float dxx = x - cx[k];
        const float dxy = y - cy[k];
        const float dxz = z - cz[k];
        const float r2 = dxx * dxx + dxy * dxy + dxz * dxz;
        const float jh = cih[k];
        const float r = sqrtf(r2);
        const float qi = r * ih;
        const float qj = r * jh;
        if (r * ih_gate >= 2.0f && qj >= 2.0f) return;
        const float gw =
            0.5f * (pw_gw(r, qi, ih, lin) + pw_gw(r, qj, jh, lin));
        float coef = asymmetric ? m * cp[k] * gw
                                : m * (pi_i + cp[k]) * ri * gw;
        if constexpr (AV) {
          const float dvx = vx - cvx[k];
          const float dvy = vy - cvy[k];
          const float dvz = vz - cvz[k];
          const float vdotr = dvx * dxx + dvy * dxy + dvz * dxz;
          const float gs_av =
              sign_bug ? 0.5f * (pw_gw(r, qi, ih, -3.0f)
                                 + pw_gw(r, qj, jh, -3.0f))
                       : gw;
          if (vdotr < 0.0f) {
            const float hbar = 0.5f * (hi + chh[k]);
            const float mu = hbar * vdotr / (r2 + 0.01f * hbar * hbar);
            const float cbar = 0.5f * (csi + ccs[k]);
            const float rhobar = 0.5f * (ri + crho[k]);
            float pij = (-av_alpha * cbar * mu + av_beta * mu * mu) / rhobar;
            if constexpr (BAL) pij *= 0.5f * (fbi + cfb[k]);
            coef += m * pij * gs_av * ri;
          }
          if constexpr (BAL) {
            const float g_dc = m * gs_av;
            acc[3] += g_dc * vdotr;
            acc[4] += g_dc * (dvy * dxz - dvz * dxy);
            acc[5] += g_dc * (dvz * dxx - dvx * dxz);
            acc[6] += g_dc * (dvx * dxy - dvy * dxx);
          }
        }
        acc[0] += dxx * coef;
        acc[1] += dxy * coef;
        acc[2] += dxz * coef;
      };
      for (int k = 0; k < cnt; ++k) {
        if (base + k == i) {
          // 0 times a non-finite value of the target's own is NaN
          if (target_bad) pair(k, 0.0f);
          continue;
        }
        pair(k, cm[k]);
      }
    }
    __syncthreads();
  }
  if (live) {
    float* p = part + (size_t)blockIdx.y * NOUT * n + i;
#pragma unroll
    for (int k = 0; k < NOUT; ++k) p[(size_t)k * n] = acc[k];
  }
}

// adds the splits' partial sums in split order into grad P [n,3] and, with
// nout = 7, the div/curl sums dc [n,4]
__global__ void pairwise_pass2_reduce(const float* __restrict__ part,
                                      float* __restrict__ gp,
                                      float* __restrict__ dc, int n,
                                      int splits, int nout) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  for (int k = 0; k < nout; ++k) {
    float f = 0.0f;
    for (int s = 0; s < splits; ++s)
      f += part[((size_t)s * nout + k) * n + i];
    if (k < 3)
      gp[3 * (size_t)i + k] = f;
    else
      dc[4 * (size_t)i + (k - 3)] = f;
  }
}

extern "C" int psph_pairwise_pass2(
    const float* pos, const float* inv_h, const float* mass,
    const float* rho, const float* prs, const float* vel, const float* hh,
    const float* cs, const float* fb, float* gp, float* dc, float* part,
    int n, int splits, int asymmetric, int sign_bug, int av, int balsara,
    float av_alpha, float av_beta, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int iblocks = (n + PW_TILE - 1) / PW_TILE;
  const int chunk = (n + splits - 1) / splits;
  const dim3 grid(iblocks, splits);
  cudaStream_t st = (cudaStream_t)stream;
  if (av && balsara)
    pairwise_pass2_kernel<true, true><<<grid, PW_TILE, 0, st>>>(
        pos, inv_h, mass, rho, prs, vel, hh, cs, fb, part, n, chunk,
        asymmetric, sign_bug, av_alpha, av_beta);
  else if (av)
    pairwise_pass2_kernel<true, false><<<grid, PW_TILE, 0, st>>>(
        pos, inv_h, mass, rho, prs, vel, hh, cs, fb, part, n, chunk,
        asymmetric, sign_bug, av_alpha, av_beta);
  else
    pairwise_pass2_kernel<false, false><<<grid, PW_TILE, 0, st>>>(
        pos, inv_h, mass, rho, prs, vel, hh, cs, fb, part, n, chunk,
        asymmetric, sign_bug, av_alpha, av_beta);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  pairwise_pass2_reduce<<<iblocks, PW_TILE, 0, st>>>(
      part, gp, dc, n, splits, (av && balsara) ? 7 : 3);
  return (int)cudaGetLastError();
}
