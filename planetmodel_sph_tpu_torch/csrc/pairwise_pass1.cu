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
// Bound on the H100: n^2 pairs against 20 n bytes of input, so pair
// arithmetic bounds it from a few hundred particles on. Only a few per
// mille of the pairs lie inside a support (some 50 neighbours among n);
// gravity takes every pair. What held the first design back: one thread a
// target, five scalar shared loads a pair; the IEEE square root, both q and
// the gate on every pair; the self test j == i in the inner loop of every
// tile; the Dyer-Ip term branching on x < 1; and the whole file built
// without multiply-adds for the sake of the count. This design:
// - PW_TPT = 2 targets a thread (i and i + PW_THREADS of the block's
//   PW_TARGETS), which share each source's shared loads: a float4 (x, y, z,
//   m) and a float 1/h (two beat one in every case on the H100);
// - the q^2 test before the square root: with ihm = psph_min(ih_i, ih_j),
//   the smaller 1/h and so the larger support, a pair with s2 = (r2 ihm)
//   ihm > PSPH_Q2_SKIP has sqrtf(r2) ihm >= 2 and, rounding being
//   monotone, sqrtf(r2) ih >= 2 for both 1/h: it adds nothing to rho nor
//   to the count, and its Dyer-Ip term takes the outer branch (x = r/a >=
//   2, a being 1/ihm or h_i <= 1/ihm): m/r and m/r^3 with 1/r =
//   rsqrt(s2) ihm, s2 > 4 needing no guard and no denormal scaling, the
//   terms selected (0 for the pairs the test keeps), no branch. r2 of the
//   test is formed with multiply-adds: its rounding lies far inside the
//   constant's margin;
// - the pairs the test keeps (0.2 % of them) are listed, per thread, in
//   shared memory (source, target, self bit) and evaluated by near()
//   after the sweep of the tile, or when the list may not hold the next
//   source's pairs: evaluated inline, their square root and splines sat
//   in the sweep's loop and a warp ran them whenever one of its 64
//   (target, source) pairs needed them. near() forms r2 again as the
//   plain version does, with __fmul_rn and __fadd_rn (never contracted),
//   q = sqrtf(r2) ih with __fmul_rn, and keeps the exact gate "not (r
//   ih_i >= 2 and q_j >= 2)", so the q < 2 count equals the plain
//   version's with multiply-adds allowed in the rest of the file; its
//   gravity is psph_p2p_pair (common.cuh): the outer branch first, the
//   inner one selected into it, rsqrtf(psph_max(r2, 1e-30f)) and min-h
//   softening psph_min;
// - the self pair can lie only in a tile whose source range meets the
//   block's targets (the same for the whole block): only such a diagonal
//   tile runs the sweep with the test j == i; every other tile runs one
//   without it;
// - a NaN or an infinity must reach the outputs as in the plain version,
//   which multiplies a pair outside both supports by a weight of 0 (a
//   non-finite field times 0 is NaN): a tile in which a staged field is
//   not finite, and a target whose own x, y, z or 1/h is not finite, skip
//   nothing (all_pairs: set once a tile at the staging and once a target;
//   it zeroes the target's 1/h of the test and the gate for the tile, so
//   s2 is 0 or NaN and the gate leaves out nothing), and a NaN in r2 or
//   either 1/h fails the test and is listed. The self pair, which the
//   plain version weighs with m = 0, is listed so (and not counted) by a
//   flagged target, where 0 times its own non-finite value is NaN;
// - the targets alone are only n/256 blocks, so blockIdx.y splits the
//   source range; each split writes its partial sums to a [splits, 7, n]
//   scratch and a second small kernel adds them in split order, so the
//   sums are repeatable and the counts exact (no float atomics). nd of a
//   split is its source count less the self pair.
#include "common.cuh"

#define PW_THREADS 128
#define PW_TPT 2
#define PW_TARGETS (PW_THREADS * PW_TPT)
// sources staged a tile: as many as a block has targets
#define PW_TILE PW_TARGETS
// pairs the q^2 test keeps that a thread lists before it evaluates them
#define PW_DEFER 16
// a listed pair: source k (8 bits), target u (bit 8), the self pair (bit 9)
static_assert(PW_TILE <= 256 && PW_TPT == 2, "the list's entries");

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

template <bool GRAV, bool RECV>
__global__ void __launch_bounds__(PW_THREADS) pairwise_pass1_kernel(
    const float* __restrict__ pos, const float* __restrict__ inv_h,
    const float* __restrict__ mass, float* __restrict__ part_f,
    int* __restrict__ part_i, int n, int chunk) {
  __shared__ __align__(16) float4 src[PW_TILE];    // x, y, z, m
  __shared__ float sih[PW_TILE];
  // each thread's list of the sources the q^2 test kept, per target
  __shared__ unsigned short queue[PW_DEFER][PW_THREADS];
  // this thread's column of the list, and its last entry that leaves room
  // for the next source's pairs
  unsigned short* const qbase = &queue[0][threadIdx.x];
  const unsigned short* const qlast =
      qbase + (PW_DEFER - PW_TPT) * PW_THREADS;
  const int lo = blockIdx.x * PW_TARGETS;
  const int j0 = blockIdx.y * chunk;
  const int j1 = min(n, j0 + chunk);
  int ti[PW_TPT];
  float x[PW_TPT], y[PW_TPT], z[PW_TPT], ih[PW_TPT], ci[PW_TPT];
  bool target_bad[PW_TPT];
  float rho[PW_TPT], acc[PW_TPT][4];     // acc: phi, gx, gy, gz
  int nn[PW_TPT];
#pragma unroll
  for (int u = 0; u < PW_TPT; ++u) {
    ti[u] = lo + threadIdx.x + u * PW_THREADS;
    x[u] = y[u] = z[u] = 0.0f;
    ih[u] = 1.0f;
    if (ti[u] < n) {
      x[u] = pos[3 * (size_t)ti[u]];
      y[u] = pos[3 * (size_t)ti[u] + 1];
      z[u] = pos[3 * (size_t)ti[u] + 2];
      ih[u] = inv_h[ti[u]];
    }
    const float own[4] = {x[u], y[u], z[u], ih[u]};
    target_bad[u] = !psph_all_finite(own);
    ci[u] = PSPH_INV_PI * (ih[u] * ih[u] * ih[u]);
    rho[u] = 0.0f;
    nn[u] = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[u][c] = 0.0f;
  }
  for (int base = j0; base < j1; base += PW_TILE) {
    const int cnt = min(PW_TILE, j1 - base);
    bool bad = false;
    for (int k = threadIdx.x; k < cnt; k += PW_THREADS) {
      const size_t j = (size_t)base + k;
      const float v[5] = {pos[3 * j], pos[3 * j + 1], pos[3 * j + 2],
                          inv_h[j], mass[j]};
      src[k] = make_float4(v[0], v[1], v[2], v[4]);
      sih[k] = v[3];
      bad = bad || !psph_all_finite(v);
    }
    const bool tile_bad = __syncthreads_or(bad) != 0;
    // each target's 1/h for this tile's q^2 test and gate: 0 skips and
    // gates out nothing ((r2 0) 0 is 0 or NaN)
    float ih_tile[PW_TPT];
#pragma unroll
    for (int u = 0; u < PW_TPT; ++u) {
      const bool all_pairs = tile_bad || target_bad[u];
      ih_tile[u] = all_pairs ? 0.0f : ih[u];
    }
    // the terms of target u and a source (1/h jh, mass m) that the q^2
    // test kept (d = x_i - x_j, r2 = |d|^2 with multiply-adds); `other`:
    // 1, or 0 for the self pair, which the plain version weighs with m = 0
    // and does not count
    auto near = [&](int u, float jh, float m, float dxx, float dxy,
                    float dxz, float r2, int other) {
      const float r = sqrtf(__fadd_rn(
          __fadd_rn(__fmul_rn(dxx, dxx), __fmul_rn(dxy, dxy)),
          __fmul_rn(dxz, dxz)));
      const float qi = __fmul_rn(r, ih[u]);
      const float qj = __fmul_rn(r, jh);
      if (!(__fmul_rn(r, ih_tile[u]) >= 2.0f && qj >= 2.0f)) {
        const float cj = PSPH_INV_PI * (jh * jh * jh);
        rho[u] += m * 0.5f * (pw_spline_w(qi, ci[u]) + pw_spline_w(qj, cj));
        nn[u] += qi < 2.0f ? other : 0;
      }
      if (GRAV)
        psph_p2p_pair(m, dxx, dxy, dxz, r2,
                      RECV ? ih[u] : psph_min(ih[u], jh), acc[u]);
    };
    // the tile's sweep: the q^2 test of every (target, source) pair; a
    // pair outside both supports adds gravity's outer branch at once, one
    // the test keeps is listed (source k, target u, the self bit);
    // whenever the list may not hold the next source's pairs, and at the
    // tile's end, the listed pairs go to near() in the order listed, so
    // each target's pairs inside the supports are added in source order.
    // `diag`: the tile's source range meets the block's targets, and the
    // self pair is visited only by a flagged target
    auto sweep = [&](bool diag) {
      int k = 0;
      do {
        unsigned short* qw = qbase;
        for (; k < cnt; ++k) {
          const float4 p = src[k];
          const float jh = sih[k];
#pragma unroll
          for (int u = 0; u < PW_TPT; ++u) {
            const bool self = diag && base + k == ti[u];
            const float dxx = x[u] - p.x;
            const float dxy = y[u] - p.y;
            const float dxz = z[u] - p.z;
            const float r2 = fmaf(dxz, dxz, fmaf(dxy, dxy, dxx * dxx));
            const float ihm = psph_min(ih_tile[u], jh);
            const float s2 = (r2 * ihm) * ihm;
            const bool skip = s2 > PSPH_Q2_SKIP;
            if (GRAV) {
              // a skipped pair: gravity's outer branch, m/r and m/r^3, 1/r
              // from s2 = (r ihm)^2 >= 4 (no denormal); the others add 0
              // here and all their terms in near()
              const float inv_r = psph_rsqrt_ftz(s2) * ihm;
              const float mr = skip ? p.w * inv_r : 0.0f;
              const float mag = skip ? mr * inv_r * inv_r : 0.0f;
              acc[u][0] -= mr;
              acc[u][1] = fmaf(dxx, mag, acc[u][1]);
              acc[u][2] = fmaf(dxy, mag, acc[u][2]);
              acc[u][3] = fmaf(dxz, mag, acc[u][3]);
            }
            if (!skip && (!self || target_bad[u])) {
              *qw = (unsigned short)(k | (u << 8) | (self ? 512 : 0));
              qw += PW_THREADS;
            }
          }
          if (qw > qlast) {
            ++k;
            break;
          }
        }
        for (const unsigned short* q = qbase; q < qw; q += PW_THREADS) {
          const int v = *q;
          const int kk = v & 255;
          const float4 p = src[kk];
          const float jh = sih[kk];
          const bool self = (v & 512) != 0;
          auto visit = [&](int u) {
            const float dxx = x[u] - p.x;
            const float dxy = y[u] - p.y;
            const float dxz = z[u] - p.z;
            near(u, jh, self ? 0.0f : p.w, dxx, dxy, dxz,
                 fmaf(dxz, dxz, fmaf(dxy, dxy, dxx * dxx)), self ? 0 : 1);
          };
          if (v & 256)
            visit(1);
          else
            visit(0);
        }
      } while (k < cnt);
    };
    if (base < lo + PW_TARGETS && base + cnt > lo)
      sweep(true);
    else
      sweep(false);
    __syncthreads();
  }
  const int sources = max(0, j1 - j0);
#pragma unroll
  for (int u = 0; u < PW_TPT; ++u) {
    if (ti[u] >= n) continue;
    float* pf = part_f + (size_t)blockIdx.y * 5 * n + ti[u];
    pf[0] = rho[u];
#pragma unroll
    for (int c = 0; c < 4; ++c) pf[(size_t)(c + 1) * n] = acc[u][c];
    int* pi = part_i + (size_t)blockIdx.y * 2 * n + ti[u];
    pi[0] = nn[u];
    pi[(size_t)n] =
        GRAV ? sources - (ti[u] >= j0 && ti[u] < j1 ? 1 : 0) : 0;
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
  const dim3 grid((n + PW_TARGETS - 1) / PW_TARGETS, splits);
  const int chunk = (n + splits - 1) / splits;
  cudaStream_t st = (cudaStream_t)stream;
  if (!do_gravity)
    pairwise_pass1_kernel<false, false><<<grid, PW_THREADS, 0, st>>>(
        pos, inv_h, mass, part_f, part_i, n, chunk);
  else if (receiver_soft)
    pairwise_pass1_kernel<true, true><<<grid, PW_THREADS, 0, st>>>(
        pos, inv_h, mass, part_f, part_i, n, chunk);
  else
    pairwise_pass1_kernel<true, false><<<grid, PW_THREADS, 0, st>>>(
        pos, inv_h, mass, part_f, part_i, n, chunk);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  pairwise_pass1_reduce<<<(n + PW_THREADS - 1) / PW_THREADS, PW_THREADS, 0,
                          st>>>(part_f, part_i, inv_h, mass, rho, nn, phi,
                                gphi, nd, n, splits, g_const);
  return (int)cudaGetLastError();
}
