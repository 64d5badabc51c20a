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
// Bound on the H100: f32 operations. Every live pair costs its geometry
// (11 operations) and only the few per cent inside the support the spline
// (about 30); the window's 16 bytes a slot are read once per group and
// shared by its targets. What held the first design back: every slot below
// nv took the square root and the spline, dead slots (m = 0) and pairs far
// outside the support alike; one block of 64 threads per group left the
// card half occupied in one ragged wave, each thread walking the whole
// window alone; and each tile was loaded synchronously before its sweep.
// This design (common.cuh, psph_window):
// - tiles of PSPH_TILE slots are copied asynchronously (cp.async, 16 bytes
//   a copy), the copy of tile t + 1 in flight while tile t is swept;
// - each staged tile is compacted to its live slots (m != 0) with a
//   ballot per warp, and only those are visited;
// - a pair with (r2 ih) ih > PSPH_Q2_SKIP is skipped before the square
//   root: PSPH_Q2_SKIP = 4 (1 + 2^-12) lies far above the rounding of
//   either product, so a skipped pair has sqrtf(r2) ih >= 2 and adds
//   nothing to rho, xi or the count; the test is false for NaN and for
//   ih <= 0, so those pairs are evaluated as before; a tile in which a
//   live slot holds a non-finite x, y, z or m, and a target whose own
//   x, y, z or ih is not finite, skip nothing (all_pairs: the flag is
//   set once a tile at the compaction and once a target, and zeroes the
//   skip's ih for the tile, so that the pair test costs what it did), so
//   that a NaN or an infinity reaches rho and xi as in the plain version,
//   where it meets a weight of 0;
// - every other pair takes q = sqrtf(r2) ih exactly as the plain version
//   does (the library is built with -fmad=false, so r2 rounds as its
//   separate operations do and the q < 2 count matches it exactly) and
//   the spline by select, not branch;
// - 64 targets x 4 slot slices = 256 threads a group; the slices' sums are
//   added in slice order at the end, with no atomics, so the result is
//   the same on every run. A group of more than 256 targets takes one
//   block of 256 per 256 targets (psph_grid), each sweeping the
//   whole window for its own.
#include "common.cuh"

__global__ void __launch_bounds__(PSPH_WIN_THREADS) pass1_gradh_kernel(
    const float* __restrict__ tx, const float* __restrict__ ty,
    const float* __restrict__ tz, const float* __restrict__ tih,
    const float* __restrict__ sx, const float* __restrict__ sy,
    const float* __restrict__ sz, const float* __restrict__ sm,
    const int* __restrict__ nv, float* __restrict__ rho,
    int* __restrict__ nn, float* __restrict__ xi, int b, int s, int ns,
    int vec) {
  __shared__ __align__(16) float raw[2][4][PSPH_TILE];
  __shared__ __align__(16) float4 comp[PSPH_TILE];
  __shared__ int wtab[64];
  const int g = blockIdx.x;
  const PsphShare my = psph_share(b);
  const int k = my.k;
  const size_t t = my.t;
  const float x = tx[t], y = ty[t], z = tz[t], ih = tih[t];
  const float ih_skip = ih > 0.0f ? ih : 0.0f;
  const float own[4] = {x, y, z, ih};
  const bool target_bad = !psph_all_finite(own);
  const int n = min(nv[g], s);
  const float* const rows[4] = {sx, sy, sz, sm};
  float acc[2] = {0.0f, 0.0f};     // sum m Wpoly, sum m (3 Wpoly + q Wpoly')
  int cnt[1] = {0};
  int npos = 0;
  psph_window<4>(rows, (size_t)g * s, n, vec != 0, raw,
                 [&](float (*st)[PSPH_TILE], int c) {
    bool tile_bad;
    const int live = psph_compact(st[3], c, wtab, npos, tile_bad,
                                  [&](int j, int at) {
      const float v[4] = {st[0][j], st[1][j], st[2][j], st[3][j]};
      comp[at] = make_float4(v[0], v[1], v[2], v[3]);
      return !psph_all_finite(v);
    });
    const bool all_pairs = tile_bad || target_bad;
    // the skip's ih for this tile: 0 skips nothing ((r2 0) 0 is 0 or NaN)
    const float ih_tile = all_pairs ? 0.0f : ih_skip;
#pragma unroll 4
    for (int j = my.from; j < live; j += ns) {
      const float4 p = comp[j];
      const float dxx = x - p.x;
      const float dxy = y - p.y;
      const float dxz = z - p.z;
      const float r2 = dxx * dxx + dxy * dxy + dxz * dxz;
      if (!((r2 * ih_tile) * ih_tile > PSPH_Q2_SKIP)) {
        const float q = sqrtf(r2) * ih;
        const float q2 = q * q;
        const float q3 = q2 * q;
        const float inner = 1.0f - 1.5f * q2 + 0.75f * q3;
        const float tt = 2.0f - q;
        const float tsq = tt * tt;
        const bool in1 = q < 1.0f, in2 = q < 2.0f;
        const float wpoly =
            in1 ? inner : (in2 ? 0.25f * tsq * tt : 0.0f);
        const float dhpoly =
            in1 ? 3.0f * inner - 3.0f * q2 + 2.25f * q3
                : (in2 ? 0.75f * tsq * (tt - q) : 0.0f);
        acc[0] += p.w * wpoly;
        acc[1] += p.w * dhpoly;
        cnt[0] += (in2 && p.w > 0.0f) ? 1 : 0;
      }
    }
  });
  psph_combine(acc, &raw[0][0][0], my.bt, ns);
  psph_combine(cnt, reinterpret_cast<int*>(&raw[1][0][0]), my.bt, ns);
  if (k == 0 && my.on) {
    const float ci3 = PSPH_INV_PI * (ih * ih * ih);
    rho[t] = ci3 * acc[0];
    xi[t] = -(ci3 * ih) * acc[1];
    nn[t] = cnt[0];
  }
}

extern "C" int psph_pass1_gradh(
    const float* tx, const float* ty, const float* tz, const float* tih,
    const float* sx, const float* sy, const float* sz, const float* sm,
    const int* nv, float* rho, int* nn, float* xi, int g, int b, int s,
    void* stream) {
  const int ns = psph_slices(b);
  if (g > 0 && ns == 0) return (int)cudaErrorInvalidValue;
  const float* rows[4] = {sx, sy, sz, sm};
  const int vec = psph_vec_rows(rows, 4, s) ? 1 : 0;
  if (g > 0)
    pass1_gradh_kernel<<<psph_grid(g, b), psph_block(b, ns), 0,
                         (cudaStream_t)stream>>>(
        tx, ty, tz, tih, sx, sy, sz, sm, nv, rho, nn, xi, b, s, ns, vec);
  return (int)cudaGetLastError();
}
