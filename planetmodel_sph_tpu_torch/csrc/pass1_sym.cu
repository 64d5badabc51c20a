// Symmetric-density sweep over the SPH window.
//
// Replaces: planetmodel_sph_tpu/ops/pallas/groups2.py pass1_sym (:324),
// body _pass1_sym_kernel (:263).
//
// Per target i of group g, over the first nv[g] source slots j (rows x, y,
// z, ih, m):
//   rho_i = sum_j m_j (W(r, h_i) + W(r, h_j)) / 2
//         = (1 / 2 pi) (ih_i^3 sum_j m_j Wpoly(r ih_i)
//                       + sum_j m_j Wpoly(r ih_j) ih_j^3)
//   nn_i  = #{j : r ih_i < 2, m_j > 0}           (self pair included)
// The source's prefactor ih_j^3 rides per pair, the target's is applied
// once after the sweep.
//
// Bound on the H100: f32 operations. Every live pair costs its geometry
// and the skip test (12 operations); only the few per cent inside either
// support the square root and the two splines (about 30 more). The
// window's 20 bytes a slot are read once per group and shared by its
// targets. What held the first design back: one block of 64 threads per
// group, each thread walking every slot below nv alone, dead slots (m = 0)
// included; every pair took the square root and both splines; and each
// tile was loaded synchronously, five scalar shared loads a pair. This
// design is pass1_gradh.cu's (common.cuh, psph_window):
// - tiles of PSPH_TILE slots are copied asynchronously (cp.async, 16 bytes
//   a copy), the copy of tile t + 1 in flight while tile t is swept;
// - each staged tile is compacted with a ballot per warp to its live
//   slots (m != 0) and to the dead ones of which a staged field or ih^3 is
//   not finite: with m = 0 the plain version still forms
//   m Wpoly(r ih_j) ih_j^3 = 0 * 0 * inf = NaN there. A slot goes to two
//   float4s, (x, y, z, ih_skip) and (m, ih, ih^3, -), ih_skip the source's
//   ih where it is > 0, else 0: one 16-byte shared load a pair the skip
//   leaves out, two for the others, and ih^3 formed once a slot as the
//   plain version forms it a pair;
// - the either-support skip: a pair adds to rho only where r ih_i < 2 or
//   r ih_j < 2, so it is skipped when (r2 ihm) ihm > PSPH_Q2_SKIP, ihm =
//   min(ih_i, ih_j) (the larger support): then sqrtf(r2) ihm >= 2 and,
//   rounding being monotone, sqrtf(r2) ih >= 2 for both ih, so the pair
//   adds nothing to either sum nor to the count. Both operands of the
//   min are >= 0 and not NaN (a NaN or non-positive ih is 0 there, and 0
//   skips nothing), so fminf serves. A tile in which a kept slot holds a
//   non-finite x, y, z, ih, ih^3 or m, and a target whose own x, y, z or
//   ih is not finite, skip nothing (all_pairs: the flag is set once a
//   tile at the compaction and once a target, and zeroes the target's
//   ih_skip for the tile, so that the pair test costs what it did), so
//   that a NaN or an infinity reaches rho as in the plain version, where
//   it meets a weight of 0;
// - every other pair takes q = sqrtf(r2) ih exactly as the plain version
//   does (the library is built with -fmad=false, so r2 rounds as its
//   separate operations do and the q < 2 count matches it exactly);
// - 64 targets x 4 slot slices = 256 threads a group; the slices' sums are
//   added in slice order at the end, with no atomics, so the result is
//   the same on every run.
#include "common.cuh"

__device__ __forceinline__ float w_poly(float q) {
  const float q2 = q * q;
  const float t = 2.0f - q;
  float w = 0.0f;
  if (q < 1.0f)
    w = 1.0f - 1.5f * q2 + 0.75f * q2 * q;
  else if (q < 2.0f)
    w = 0.25f * t * t * t;
  return w;
}

__global__ void __launch_bounds__(PSPH_WIN_THREADS) pass1_sym_kernel(
    const float* __restrict__ tx, const float* __restrict__ ty,
    const float* __restrict__ tz, const float* __restrict__ tih,
    const float* __restrict__ sx, const float* __restrict__ sy,
    const float* __restrict__ sz, const float* __restrict__ sih,
    const float* __restrict__ sm, const int* __restrict__ nv,
    float* __restrict__ rho, int* __restrict__ nn, int b, int s, int ns,
    int vec) {
  __shared__ __align__(16) float raw[2][5][PSPH_TILE];
  __shared__ __align__(16) float4 geo[PSPH_TILE];    // x, y, z, ih_skip
  __shared__ __align__(16) float4 wts[PSPH_TILE];    // m, ih, ih^3, -
  __shared__ int wtab[64];
  const int g = blockIdx.x;
  const int i = threadIdx.x % b, k = threadIdx.x / b;
  const size_t t = (size_t)g * b + i;
  const float x = tx[t], y = ty[t], z = tz[t], ih = tih[t];
  const float ih_skip = ih > 0.0f ? ih : 0.0f;
  const float own[4] = {x, y, z, ih};
  const bool target_bad = !psph_all_finite(own);
  const int n = min(nv[g], s);
  const float* const rows[5] = {sx, sy, sz, sih, sm};
  float acc[2] = {0.0f, 0.0f};     // sum m Wpoly(q_i), sum m Wpoly(q_j) ih_j^3
  int cnt[1] = {0};
  int npos = 0;
  psph_window<5>(rows, (size_t)g * s, n, vec != 0, raw,
                 [&](float (*st)[PSPH_TILE], int c) {
    // the staged fields of slot j that reach a sum, ih^3 among them
    auto fields = [&](int j, float (&v)[5]) {
      const float jh = st[3][j];
      v[0] = st[0][j];
      v[1] = st[1][j];
      v[2] = st[2][j];
      v[3] = jh * jh * jh;
      v[4] = st[4][j];
    };
    bool tile_bad;
    const int kept = psph_compact_where(
        st[4], c, wtab, npos, tile_bad,
        [&](int j, float m) {
          float v[5];
          fields(j, v);
          return m != 0.0f || !psph_all_finite(v);
        },
        [&](int j, int at) {
          float v[5];
          fields(j, v);
          const float jh = st[3][j];
          geo[at] = make_float4(v[0], v[1], v[2], jh > 0.0f ? jh : 0.0f);
          wts[at] = make_float4(v[4], jh, v[3], 0.0f);
          return !psph_all_finite(v);
        });
    const bool all_pairs = tile_bad || target_bad;
    // the skip's ih for this tile: 0 skips nothing ((r2 0) 0 is 0 or NaN)
    const float ih_tile = all_pairs ? 0.0f : ih_skip;
#pragma unroll 4
    for (int j = k; j < kept; j += ns) {
      const float4 p = geo[j];
      const float dxx = x - p.x;
      const float dxy = y - p.y;
      const float dxz = z - p.z;
      const float r2 = dxx * dxx + dxy * dxy + dxz * dxz;
      const float ihm = fminf(ih_tile, p.w);
      if (!((r2 * ihm) * ihm > PSPH_Q2_SKIP)) {
        const float4 w = wts[j];
        const float r = sqrtf(r2);
        const float q = r * ih;
        acc[0] += w.x * w_poly(q);
        acc[1] += w.x * w_poly(r * w.y) * w.z;
        cnt[0] += (q < 2.0f && w.x > 0.0f) ? 1 : 0;
      }
    }
  });
  psph_combine(acc, &raw[0][0][0], b, ns);
  psph_combine(cnt, reinterpret_cast<int*>(&raw[1][0][0]), b, ns);
  if (k == 0) {
    const float ci3 = ih * ih * ih;
    rho[t] = (0.5f * PSPH_INV_PI) * (ci3 * acc[0] + acc[1]);
    nn[t] = cnt[0];
  }
}

extern "C" int psph_pass1_sym(
    const float* tx, const float* ty, const float* tz, const float* tih,
    const float* sx, const float* sy, const float* sz, const float* sih,
    const float* sm, const int* nv, float* rho, int* nn, int g, int b,
    int s, void* stream) {
  const int ns = psph_slices(b);
  if (g > 0 && ns == 0) return (int)cudaErrorInvalidValue;
  const float* rows[5] = {sx, sy, sz, sih, sm};
  const int vec = psph_vec_rows(rows, 5, s) ? 1 : 0;
  if (g > 0)
    pass1_sym_kernel<<<g, b * ns, 0, (cudaStream_t)stream>>>(
        tx, ty, tz, tih, sx, sy, sz, sih, sm, nv, rho, nn, b, s, ns, vec);
  return (int)cudaGetLastError();
}
