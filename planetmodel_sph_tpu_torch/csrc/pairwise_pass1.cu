// All-pairs density + neighbour count + direct gravity in one sweep.
//
// Replaces: planetmodel_sph_tpu/ops/pallas/pairwise.py pass1 (:255), body
// _pass1_kernel (:113).
//
// Per target i, over every source j != i of the n particles:
//   rho_i = m_i/(pi h_i^3) + sum_j m_j (W(r, h_i) + W(r, h_j)) / 2
//   nn_i  = #{j : q_i < 2},  q_i = sqrt(r2) / h_i   (W(r, h_i) > 0)
//   phi_i, grad phi_i = G sum_j Dyer-Ip(m_j, x_i - x_j, a),
//       1/a = 1/h_i (receiver softening) or min(1/h_i, 1/h_j)
//   nd_i  = #{j != i}
// With do_gravity = 0 the potential, its gradient and nd are zero.
//
// Bound on the H100: n^2 pairs of some tens of f32 operations against 20 n
// bytes of input, so pair arithmetic bounds it from a few hundred particles
// on. Design: the classic N-body layout, one thread per target with its
// sums in registers, the sources staged PW_TILE at a time in shared memory.
// The tiled layout of the TPU kernel (its [N,1]/[1,N] operands, the output
// block resident across a sequential grid axis, the sentinel padding) has
// no counterpart: the loop runs j < n directly. One thread per target is
// only n/128 blocks, so blockIdx.y splits the source range; each split
// writes its partial sums to a [splits, 7, n] scratch and a second small
// kernel adds them in split order, so the sums are repeatable and the
// counts exact (no float atomics). Pairs outside both supports skip the
// spline math, unless a NaN or an infinity could reach rho through them:
// the plain version multiplies such a pair by a weight of 0, and a
// non-finite field times 0 is NaN. So a tile in which a staged field is
// not finite, and a target whose own x, y, z or 1/h is not finite, skip
// nothing (all_pairs: set once a tile at the staging and once a target;
// it zeroes the gate's 1/h_i, so that the gate costs what it did), and
// the gate "not (r/h_i >= 2 and r/h_j >= 2)" visits a pair with a NaN in
// r or either 1/h; the self pair, which the plain version weighs with
// m = 0, is visited so (and not counted) for a flagged target, where 0
// times its own non-finite value is NaN. Gravity softens with psph_min,
// NaN when either 1/h is, as torch.minimum, and guards r = 0 with
// psph_max, which keeps a NaN r2 as torch.clamp does. The library is
// built with -fmad=false so r2 rounds as the plain version's separate
// multiplies and adds do and the q < 2 count matches it exactly.
#include "common.cuh"

#define PW_TILE 128

__device__ __forceinline__ float pw_spline_w(float q, float c) {
  if (q < 1.0f) {
    const float q2 = q * q;
    return (1.0f - 1.5f * q2 + 0.75f * q2 * q) * c;
  }
  if (q < 2.0f) {
    const float t = 2.0f - q;
    return 0.25f * t * t * t * c;
  }
  return 0.0f;
}

__global__ void pairwise_pass1_kernel(
    const float* __restrict__ pos, const float* __restrict__ inv_h,
    const float* __restrict__ mass, float* __restrict__ part_f,
    int* __restrict__ part_i, int n, int chunk, int do_gravity,
    int receiver_soft) {
  __shared__ float cx[PW_TILE], cy[PW_TILE], cz[PW_TILE], cih[PW_TILE],
      cm[PW_TILE];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const int j0 = blockIdx.y * chunk;
  const int j1 = min(n, j0 + chunk);
  float x = 0.0f, y = 0.0f, z = 0.0f, ih = 1.0f;
  if (live) {
    x = pos[3 * (size_t)i];
    y = pos[3 * (size_t)i + 1];
    z = pos[3 * (size_t)i + 2];
    ih = inv_h[i];
  }
  const float own[4] = {x, y, z, ih};
  const bool target_bad = !psph_all_finite(own);
  const float ci = PSPH_INV_PI * (ih * ih * ih);
  float s_rho = 0.0f, s_phi = 0.0f, s_gx = 0.0f, s_gy = 0.0f, s_gz = 0.0f;
  int s_nn = 0, s_nd = 0;
  for (int base = j0; base < j1; base += PW_TILE) {
    const int cnt = min(PW_TILE, j1 - base);
    bool bad = false;
    for (int k = threadIdx.x; k < cnt; k += blockDim.x) {
      const size_t j = (size_t)base + k;
      const float v[5] = {pos[3 * j], pos[3 * j + 1], pos[3 * j + 2],
                          inv_h[j], mass[j]};
      cx[k] = v[0];
      cy[k] = v[1];
      cz[k] = v[2];
      cih[k] = v[3];
      cm[k] = v[4];
      bad = bad || !psph_all_finite(v);
    }
    const bool tile_bad = __syncthreads_or(bad) != 0;
    const bool all_pairs = tile_bad || target_bad;
    // the gate's 1/h_i for this tile: 0 gates out nothing
    const float ih_gate = all_pairs ? 0.0f : ih;
    if (live) {
      // one pair's terms with mass m; `other`: 1, or 0 for the self pair,
      // which the plain version weighs with m = 0 and does not count
      auto pair = [&](int k, float m, int other) {
        const float dxx = x - cx[k];
        const float dxy = y - cy[k];
        const float dxz = z - cz[k];
        const float r2 = dxx * dxx + dxy * dxy + dxz * dxz;
        const float jh = cih[k];
        const float r = sqrtf(r2);
        const float qi = r * ih;
        const float qj = r * jh;
        if (!(r * ih_gate >= 2.0f && qj >= 2.0f)) {
          const float cj = PSPH_INV_PI * (jh * jh * jh);
          s_rho += m * 0.5f * (pw_spline_w(qi, ci) + pw_spline_w(qj, cj));
          s_nn += qi < 2.0f ? other : 0;
        }
        if (do_gravity) {
          const float inv_a = receiver_soft ? ih : psph_min(ih, jh);
          const float inv_r = rsqrtf(psph_max(r2, 1e-30f));
          psph_dyer_ip(m, dxx, dxy, dxz, r2, inv_r, inv_a, s_phi, s_gx, s_gy,
                       s_gz);
          s_nd += other;
        }
      };
      for (int k = 0; k < cnt; ++k) {
        if (base + k == i) {
          // 0 times a non-finite value of the target's own is NaN
          if (target_bad) pair(k, 0.0f, 0);
          continue;
        }
        pair(k, cm[k], 1);
      }
    }
    __syncthreads();
  }
  if (live) {
    float* pf = part_f + (size_t)blockIdx.y * 5 * n + i;
    pf[0] = s_rho;
    pf[(size_t)n] = s_phi;
    pf[2 * (size_t)n] = s_gx;
    pf[3 * (size_t)n] = s_gy;
    pf[4 * (size_t)n] = s_gz;
    int* pi = part_i + (size_t)blockIdx.y * 2 * n + i;
    pi[0] = s_nn;
    pi[(size_t)n] = s_nd;
  }
}

// adds the splits' partial sums in split order, the self-density term and
// the gravitational constant
__global__ void pairwise_pass1_reduce(
    const float* __restrict__ part_f, const int* __restrict__ part_i,
    const float* __restrict__ inv_h, const float* __restrict__ mass,
    float* __restrict__ rho, int* __restrict__ nn, float* __restrict__ phi,
    float* __restrict__ gphi, int* __restrict__ nd, int n, int splits,
    float g_const) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float f[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  int c[2] = {0, 0};
  for (int s = 0; s < splits; ++s) {
    for (int k = 0; k < 5; ++k) f[k] += part_f[((size_t)s * 5 + k) * n + i];
    for (int k = 0; k < 2; ++k) c[k] += part_i[((size_t)s * 2 + k) * n + i];
  }
  const float ih = inv_h[i];
  rho[i] = mass[i] * PSPH_INV_PI * ih * ih * ih + f[0];
  nn[i] = c[0];
  phi[i] = g_const * f[1];
  gphi[3 * (size_t)i] = g_const * f[2];
  gphi[3 * (size_t)i + 1] = g_const * f[3];
  gphi[3 * (size_t)i + 2] = g_const * f[4];
  nd[i] = c[1];
}

extern "C" int psph_pairwise_pass1(
    const float* pos, const float* inv_h, const float* mass, float* rho,
    int* nn, float* phi, float* gphi, int* nd, float* part_f, int* part_i,
    int n, int splits, int do_gravity, int receiver_soft, float g_const,
    void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int iblocks = (n + PW_TILE - 1) / PW_TILE;
  const int chunk = (n + splits - 1) / splits;
  cudaStream_t st = (cudaStream_t)stream;
  pairwise_pass1_kernel<<<dim3(iblocks, splits), PW_TILE, 0, st>>>(
      pos, inv_h, mass, part_f, part_i, n, chunk, do_gravity, receiver_soft);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  pairwise_pass1_reduce<<<iblocks, PW_TILE, 0, st>>>(
      part_f, part_i, inv_h, mass, rho, nn, phi, gphi, nd, n, splits,
      g_const);
  return (int)cudaGetLastError();
}
