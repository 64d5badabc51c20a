// Tree gravity in one launch: the near P2P window (optional), the ring
// sub-block multipoles, the windowed block multipoles of the supergroup
// partition (optional) and the dense far scan over the block (or
// supergroup) multipoles under the frozen acceptance mask.
//
// Replaces: planetmodel_sph_tpu/ops/pallas/groups2.py gravity_fused
// (:969), body _gravity_fused_kernel (:821): has_p2p on (every tier, the
// uncached step and the standalone gravity sweep) or off (the RESPA outer
// force), has_blk on or off, both softenings, nm = 10 moment fields
// (monopole m, cm + traceless quadrupole Qxx..Qzz) or nm = 4 (monopole
// only).
//
// Per target i of group g:
//   near tier (has_p2p): the first nv_p2p[g] slots of the [G, Sp] rows x,
//     y, z, [ih,] m, Dyer-Ip softened with 1/a = ih_i (receiver softening)
//     or min(ih_i, ih_j); the count of its slots with m > 0 is n_direct
//     (self pair included, as is its potential -2.4 m/a);
//   ring tier: the first nv_ring[g] entries of the group's [G, Sr] moment
//     rows, entries with m > 0;
//   blk tier (has_blk): the first nv_blk[g] entries of the group's
//     [G, Sb] block-moment rows, entries with m > 0: blocks that pass the
//     acceptance test while their supergroup does not;
//   far tier: every entry e of the shared [NBpad] moment rows (blocks, or
//     supergroups under has_blk) with accept[g, e] > 0.5 and m_e > 0.
//   Each entry adds the unsoftened monopole (-m/r, m d/r^3) and, for nm=10,
//   the traceless quadrupole (-(d^T Q d)/(2 r^5), -(Q d)/r^5
//   + (5/2)(d^T Q d) d/r^7), d = x_i - cm. Outputs g_const * (phi, g), the
//   count of ring, blk and far entries used (n_approx) and n_direct (0 without
//   the near tier): two counters, where the TPU kernel reuses one.
//
// Bound on the H100: per group the [NBpad] accept row (22.5 KB at 100k)
// is read once and the accepted far entries cost about 60 f32 operations
// per target; the far moment rows (10 x NBpad floats) are shared by all
// groups and stay in L2. Design: one thread block per target group, one
// thread per target; ring entries and far entries (with the group's accept
// slice) are staged PSPH_TILE at a time in shared memory. Entries with
// accept == 0 or m == 0 are skipped, which is exact: their terms are 0 in
// the reference (its live mask multiplies the quadrupole powers first so
// that an entry at r ~ 0 cannot produce inf * 0). The accept test is the
// same for every thread of the block, so the skip does not diverge.
#include "common.cuh"

struct Acc {
  float phi, gx, gy, gz;
  int n;
};

__device__ __forceinline__ void mono_quad(float (*c)[PSPH_TILE], int j,
                                          int nm, float x, float y, float z,
                                          Acc& a) {
  const float m = c[0][j];
  const float dxx = x - c[1][j];
  const float dxy = y - c[2][j];
  const float dxz = z - c[3][j];
  const float r2 = dxx * dxx + dxy * dxy + dxz * dxz;
  const float inv_r = rsqrtf(fmaxf(r2, 1e-30f));
  const float mag = m * inv_r * inv_r * inv_r;
  float phi_c = -m * inv_r;
  float gx_c = dxx * mag;
  float gy_c = dxy * mag;
  float gz_c = dxz * mag;
  if (nm == 10) {
    const float qxx = c[4][j], qxy = c[5][j], qxz = c[6][j];
    const float qyy = c[7][j], qyz = c[8][j], qzz = c[9][j];
    const float qdx = qxx * dxx + qxy * dxy + qxz * dxz;
    const float qdy = qxy * dxx + qyy * dxy + qyz * dxz;
    const float qdz = qxz * dxx + qyz * dxy + qzz * dxz;
    const float dqd = dxx * qdx + dxy * qdy + dxz * qdz;
    const float ir2 = inv_r * inv_r;
    const float ir5 = ir2 * ir2 * inv_r;
    const float ir7dqd = 2.5f * dqd * ir5 * ir2;
    phi_c = phi_c - 0.5f * dqd * ir5;
    gx_c = gx_c - qdx * ir5 + dxx * ir7dqd;
    gy_c = gy_c - qdy * ir5 + dxy * ir7dqd;
    gz_c = gz_c - qdz * ir5 + dxz * ir7dqd;
  }
  a.phi += phi_c;
  a.gx += gx_c;
  a.gy += gy_c;
  a.gz += gz_c;
  a.n += 1;
}

struct Rows {
  const float* f[10];
};

// One windowed moment tier: the first n entries of the rows starting at
// `row`, staged PSPH_TILE at a time; entries with m > 0 are evaluated.
// Every thread of the block must call it (it synchronises).
__device__ __forceinline__ void moment_window(const Rows& rows, size_t row,
                                              int n, int nm,
                                              float (*c)[PSPH_TILE], float x,
                                              float y, float z, Acc& a) {
  const int i = threadIdx.x;
  for (int base = 0; base < n; base += PSPH_TILE) {
    const int cnt = min(PSPH_TILE, n - base);
    for (int j = i; j < cnt; j += blockDim.x)
      for (int k = 0; k < nm; ++k) c[k][j] = rows.f[k][row + base + j];
    __syncthreads();
    for (int j = 0; j < cnt; ++j)
      if (c[0][j] > 0.0f) mono_quad(c, j, nm, x, y, z, a);
    __syncthreads();
  }
}

// HAS_P2P: 0 no near tier, 1 min-h softening, 2 receiver softening
template <int HAS_P2P>
__global__ void gravity_fused_kernel(
    const float* __restrict__ tx, const float* __restrict__ ty,
    const float* __restrict__ tz, const float* __restrict__ tih, Rows p2p,
    const int* __restrict__ nv_p2p, Rows ring,
    const int* __restrict__ nv_ring, Rows blk,
    const int* __restrict__ nv_blk, Rows far,
    const float* __restrict__ accept, float* __restrict__ phi_out,
    float* __restrict__ gx_out, float* __restrict__ gy_out,
    float* __restrict__ gz_out, int* __restrict__ nd_out,
    int* __restrict__ na_out, int b, int sp, int sr, int sb, int nbpad,
    int nm, float g_const) {
  __shared__ float c[10][PSPH_TILE];
  __shared__ float acc[PSPH_TILE];
  const int g = blockIdx.x;
  const int i = threadIdx.x;
  const size_t t = (size_t)g * b + i;
  const float x = tx[t], y = ty[t], z = tz[t];
  Acc a = {0.0f, 0.0f, 0.0f, 0.0f, 0};
  int nd = 0;

  // near tier: P2P over the sub-block window
  if (HAS_P2P)
    psph_p2p_window<HAS_P2P == 2>(p2p.f[0], p2p.f[1], p2p.f[2], p2p.f[3],
                                  p2p.f[4], (size_t)g * sp,
                                  min(nv_p2p[g], sp), x, y, z, tih[t], c,
                                  a.phi, a.gx, a.gy, a.gz, nd);

  // ring tier: windowed sub-block moments
  moment_window(ring, (size_t)g * sr, min(nv_ring[g], sr), nm, c, x, y, z,
                a);
  // blk tier: windowed block moments (null without the supergroup tier;
  // the same test for every thread of the grid)
  if (nv_blk != nullptr)
    moment_window(blk, (size_t)g * sb, min(nv_blk[g], sb), nm, c, x, y, z,
                  a);

  // far tier: dense scan over block (or supergroup) moments under the
  // frozen mask
  const size_t row = (size_t)g * nbpad;
  for (int base = 0; base < nbpad; base += PSPH_TILE) {
    const int cnt = min(PSPH_TILE, nbpad - base);
    for (int j = i; j < cnt; j += blockDim.x) {
      acc[j] = accept[row + base + j];
      for (int k = 0; k < nm; ++k) c[k][j] = far.f[k][base + j];
    }
    __syncthreads();
    for (int j = 0; j < cnt; ++j)
      if (acc[j] > 0.5f && c[0][j] > 0.0f) mono_quad(c, j, nm, x, y, z, a);
    __syncthreads();
  }

  phi_out[t] = g_const * a.phi;
  gx_out[t] = g_const * a.gx;
  gy_out[t] = g_const * a.gy;
  gz_out[t] = g_const * a.gz;
  nd_out[t] = nd;
  na_out[t] = a.n;
}

// The P2P rows and nv_p2p are null when has_p2p == 0, pih also under
// receiver_soft; the blk rows and nv_blk are null without the supergroup
// tier; ring, blk and far rows 4..9 are null when nm == 4.
extern "C" int psph_gravity_fused(
    const float* tx, const float* ty, const float* tz, const float* tih,
    const float* px, const float* py, const float* pz, const float* pih,
    const float* pm, const int* nv_p2p, const float* r0, const float* r1,
    const float* r2, const float* r3, const float* r4, const float* r5,
    const float* r6, const float* r7, const float* r8, const float* r9,
    const int* nv_ring, const float* b0, const float* b1, const float* b2,
    const float* b3, const float* b4, const float* b5, const float* b6,
    const float* b7, const float* b8, const float* b9, const int* nv_blk,
    const float* f0, const float* f1, const float* f2,
    const float* f3, const float* f4, const float* f5, const float* f6,
    const float* f7, const float* f8, const float* f9, const float* accept,
    float* phi, float* gx, float* gy, float* gz, int* nd, int* na, int g,
    int b, int sp, int sr, int sb, int nbpad, int nm, int has_p2p,
    int receiver_soft, float g_const, void* stream) {
  Rows p2p = {{px, py, pz, pih, pm, 0, 0, 0, 0, 0}};
  Rows ring = {{r0, r1, r2, r3, r4, r5, r6, r7, r8, r9}};
  Rows blk = {{b0, b1, b2, b3, b4, b5, b6, b7, b8, b9}};
  Rows far = {{f0, f1, f2, f3, f4, f5, f6, f7, f8, f9}};
  cudaStream_t st = (cudaStream_t)stream;
#define PSPH_GF(P)                                                        \
  gravity_fused_kernel<P><<<g, b, 0, st>>>(                               \
      tx, ty, tz, tih, p2p, nv_p2p, ring, nv_ring, blk, nv_blk, far,      \
      accept, phi, gx, gy, gz, nd, na, b, sp, sr, sb, nbpad, nm, g_const)
  if (g > 0) {
    if (!has_p2p)
      PSPH_GF(0);
    else if (!receiver_soft)
      PSPH_GF(1);
    else
      PSPH_GF(2);
  }
#undef PSPH_GF
  return (int)cudaGetLastError();
}
