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
// without multiply-adds for the sake of the count. What held the second
// back: the SPH half's test, list and selects on every pair, though a
// pair outside both supports needs only gravity's outer branch: some 29
// instructions a pair against 14. This design:
// - the plan (pairwise.plan, from PLAN_MIN_N particles on): the sweep
//   runs in a Morton order of the particles, so that a warp's PSPH_SUB
//   targets and each sub-tile of PSPH_SUB sources are compact boxes
//   (common.cuh). pairwise_pass1_keys forms the keys, one stable sort
//   orders them (PyTorch), pairwise_pass1_stage copies the particles into
//   that order and writes the boxes, and the reduce writes each output
//   back to its particle's own index, so the caller sees its own order.
//   Under a plan each warp works on its own (no barrier spans the block):
//   it takes its split's sub-tiles, every splits-th one rather than one
//   range, and stages each in its quarter of the tile's shared memory,
//   its two loads a lane issued before either store. As ranges, a warp's
//   near sub-tiles, which cluster about its own place in the order, fell
//   to a few splits whose blocks then ran long while the rest idled; and
//   with block-wide tiles every warp waited at the barrier for the one
//   with the most near sub-tiles (on the H100 at n = 32,768 the first
//   took 1.15 ms and the second 0.96 against 1.20 without the cull; this
//   design 0.93). Without a plan the sweep is block-wide, in the
//   particles' order, targets i and i + PW_THREADS, one range a split;
// - the cull: each warp tests its own box against the sub-tiles'
//   (psph_box_far, one lane a sub-tile, a ballot for 32 of them). A far
//   (warp, sub-tile) pair holds no pair the q^2 test keeps (PSPH_FAR_Q2's
//   note), so its sources need gravity's outer branch alone: the far
//   sweep, m/r and m/r^3 with the bare rsqrt (the box test keeps r2 at or
//   above the plain version's clamp), and no 1/h, test, list or self
//   pair, some 14.5 instructions a pair. Without gravity a far sub-tile is
//   neither staged nor swept. A near sub-tile runs the sweep below
//   unchanged, so the counts stay exact and the sums inside a support are
//   formed as before. The plan's counters take one atomic add a warp,
//   spread over PSPH_PLAN_SLOTS addresses;
// - PW_TPT = 2 targets a thread, which share each source's shared loads:
//   a float4 (x, y, z, m) and a float 1/h (two beat one in every case on
//   the H100); under a plan the two are neighbours in the warp's box;
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
// - the pairs the test keeps are listed, per thread, in shared memory
//   (source, target, self bit) and evaluated by near() after the sweep of
//   the tile (of a near sub-tile under a plan), or when the list may not
//   hold the next source's pairs: evaluated inline, their square root and
//   splines sat in the sweep's loop and a warp ran them whenever one of
//   its 64 (target, source) pairs needed them. near() forms r2 again as the plain version does,
//   with __fmul_rn and __fadd_rn (never contracted), q = sqrtf(r2) ih
//   with __fmul_rn, and keeps the exact gate "not (r ih_i >= 2 and q_j >=
//   2)", so the q < 2 count equals the plain version's with multiply-adds
//   allowed in the rest of the file; its gravity is psph_p2p_pair
//   (common.cuh): the outer branch first, the inner one selected into it,
//   rsqrtf(psph_max(r2, 1e-30f)) and min-h softening psph_min;
// - the self pair can lie only in a tile whose source range meets the
//   block's targets (under a plan: in the warp's own box): only such a
//   diagonal tile runs the sweep with the test j == i; every other tile
//   runs one without it;
// - a NaN or an infinity must reach the outputs as in the plain version,
//   which multiplies a pair outside both supports by a weight of 0 (a
//   non-finite field times 0 is NaN): a box with a non-finite staged value
//   is flagged and never far, nor is a warp's own box when one of its
//   targets is flagged; a tile (a plan's sub-tile) in which a staged field
//   is not finite, and a target whose own x, y, z or 1/h is not finite,
//   skip nothing (all_pairs: set once a tile at the staging and once a
//   target; it
//   zeroes the target's 1/h of the test and the gate for the tile, so s2
//   is 0 or NaN and the gate leaves out nothing), and a NaN in r2 or
//   either 1/h fails the test and is listed. The self pair, which the
//   plain version weighs with m = 0, is listed so (and not counted) by a
//   flagged target, where 0 times its own non-finite value is NaN;
// - the targets alone are only n/256 blocks, so blockIdx.y splits the
//   sources (under a plan every splits-th sub-tile); each split
//   writes its partial sums to a [splits, 7, n] scratch and a second
//   small kernel adds them in split order, so the sums are repeatable and
//   the counts exact (no float atomics). nd of a split is its source count
//   less the self pair.
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
static_assert(PW_TPT * 32 == PSPH_SUB && PW_TILE % PSPH_SUB == 0,
              "a warp's targets are one box, a tile whole boxes");

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

// The sweep. PLAN false: the particles in their own order, a thread's
// targets i and i + PW_THREADS of the block's, the split's sources the
// range [j0, j1) of `chunk`, staged by the block a tile at a time, every
// pair tested. PLAN true: pos, inv_h and mass in a plan's Morton order
// (pairwise_pass1_stage's copies), `box` its boxes and `counts` its
// counters; each warp's targets are one box (PW_TPT neighbouring ones a
// lane), and each warp on its own takes the split's sub-tiles, every
// gridDim.y-th (sub-tile t of split y is y + t gridDim.y: a warp's near
// sub-tiles cluster about its own place in the order, and so spread over
// the splits), staging each in its quarter of the tile's shared memory;
// a near sub-tile is swept as without a plan, a far one for gravity's
// outer branch alone.
template <bool GRAV, bool RECV, bool PLAN>
__global__ void __launch_bounds__(PW_THREADS) pairwise_pass1_kernel(
    const float* __restrict__ pos, const float* __restrict__ inv_h,
    const float* __restrict__ mass, const float4* __restrict__ box,
    int* __restrict__ counts, float* __restrict__ part_f,
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
  const int lane = threadIdx.x & 31;
  // the warp's box (a plan's): its first target; a warp past the end has
  // nothing to do (no barrier spans the block's warps under a plan)
  const int wlo = lo + (threadIdx.x >> 5) * PSPH_SUB;
  if (PLAN && wlo >= n) return;
  const int j0 = blockIdx.y * chunk;
  const int j1 = min(n, j0 + chunk);
  int ti[PW_TPT];
  float x[PW_TPT], y[PW_TPT], z[PW_TPT], ih[PW_TPT], ci[PW_TPT];
  bool target_bad[PW_TPT];
  float rho[PW_TPT], acc[PW_TPT][4];     // acc: phi, gx, gy, gz
  int nn[PW_TPT];
#pragma unroll
  for (int u = 0; u < PW_TPT; ++u) {
    ti[u] = PLAN ? wlo + PW_TPT * lane + u : lo + threadIdx.x + u * PW_THREADS;
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
  // each target's 1/h for the staged sources' q^2 test and gate: 0 skips
  // and gates out nothing ((r2 0) 0 is 0 or NaN)
  float ih_tile[PW_TPT];
  auto set_tile = [&](bool tile_bad) {
#pragma unroll
    for (int u = 0; u < PW_TPT; ++u) {
      const bool all_pairs = tile_bad || target_bad[u];
      ih_tile[u] = all_pairs ? 0.0f : ih[u];
    }
  };
  // the terms of target u and a source (1/h jh, mass m) that the q^2 test
  // kept (d = x_i - x_j, r2 = |d|^2 with multiply-adds); `other`: 1, or 0
  // for the self pair, which the plain version weighs with m = 0 and does
  // not count
  auto near = [&](int u, float jh, float m, float dxx, float dxy, float dxz,
                  float r2, int other) {
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
  // the sweep of `cnt` staged sources (sp: x, y, z, m; sh: 1/h), the first
  // source `base`: the q^2 test of every (target, source) pair; a pair
  // outside both supports adds gravity's outer branch at once, one the
  // test keeps is listed (source k, target u, the self bit); whenever the
  // list may not hold the next source's pairs, and at the end, the listed
  // pairs go to near() in the order listed, so each target's pairs inside
  // the supports are added in source order. `diag`: the sources meet the
  // targets, and the self pair is visited only by a flagged target
  auto sweep = [&](const float4* sp, const float* sh, int base, bool diag,
                   int cnt) {
    int k = 0;
    do {
      unsigned short* qw = qbase;
      for (; k < cnt; ++k) {
        const float4 p = sp[k];
        const float jh = sh[k];
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
        const float4 p = sp[kk];
        const float jh = sh[kk];
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
  // the split's sources, and whether each target's own place lies among
  // them (its self pair)
  int sources = 0;
  bool own_split = false;
  if constexpr (!PLAN) {
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
      set_tile(tile_bad);
      // the self pair lies only in a tile whose source range meets the
      // block's targets
      if (base < lo + PW_TARGETS && base + cnt > lo)
        sweep(src, sih, base, true, cnt);
      else
        sweep(src, sih, base, false, cnt);
      __syncthreads();
    }
    sources = max(0, j1 - j0);
  } else {
    float4* const wsrc = src + (threadIdx.x >> 5) * PSPH_SUB;
    float* const wsih = sih + (threadIdx.x >> 5) * PSPH_SUB;
    const float4 tlo = box[2 * (wlo / PSPH_SUB)];
    const float4 thi = box[2 * (wlo / PSPH_SUB) + 1];
    const int nsub = (n + PSPH_SUB - 1) / PSPH_SUB;
    const int stride = gridDim.y;
    int near_subs = 0, subs = 0;
    for (int s0 = blockIdx.y; s0 < nsub; s0 += 32 * stride) {
      // lane l decides sub-tile s0 + l stride; the warp takes them in order
      const int sb = s0 + lane * stride;
      const bool live = sb < nsub;
      const bool keep = live && !psph_box_far(tlo, thi, box[2 * sb],
                                              box[2 * sb + 1]);
      const unsigned lives = __ballot_sync(0xffffffffu, live);
      const unsigned keeps = __ballot_sync(0xffffffffu, keep);
      subs += __popc(lives);
      near_subs += __popc(keeps);
      // without gravity a far sub-tile adds nothing and is not staged
      for (unsigned todo = GRAV ? lives : keeps; todo; todo &= todo - 1) {
        const int b = __ffs(todo) - 1;
        const bool far = !((keeps >> b) & 1u);
        const int base = (s0 + b * stride) * PSPH_SUB;
        const int cnt = min(PSPH_SUB, n - base);
        sources += cnt;
        // the lane's sources k = lane + 32 t, all loaded before any is
        // stored (a source past the end loads the last one's values); a
        // far sub-tile's 1/h is not read, its box says its values are
        // finite
        float v[PSPH_SUB / 32][5];
#pragma unroll
        for (int t = 0; t < PSPH_SUB / 32; ++t) {
          const size_t j = (size_t)base + min(lane + 32 * t, cnt - 1);
          v[t][0] = pos[3 * j];
          v[t][1] = pos[3 * j + 1];
          v[t][2] = pos[3 * j + 2];
          v[t][3] = far ? 1.0f : inv_h[j];
          v[t][4] = mass[j];
        }
        bool bad = false;
#pragma unroll
        for (int t = 0; t < PSPH_SUB / 32; ++t) {
          const int k = lane + 32 * t;
          if (k >= cnt) continue;
          wsrc[k] = make_float4(v[t][0], v[t][1], v[t][2], v[t][4]);
          wsih[k] = v[t][3];
          bad = bad || !psph_all_finite(v[t]);
        }
        const bool tile_bad = __any_sync(0xffffffffu, bad);
        __syncwarp();
        if (far) {
          // gravity's outer branch alone, m/r and m/r^3: every pair of the
          // sub-tile lies outside both supports (x = r/a >= 2), none is the
          // self pair, and r2 >= PSPH_R2_FLOOR, which the plain version's
          // clamp leaves
#pragma unroll 4
          for (int k = 0; k < cnt; ++k) {
            const float4 p = wsrc[k];
#pragma unroll
            for (int u = 0; u < PW_TPT; ++u) {
              const float dxx = x[u] - p.x;
              const float dxy = y[u] - p.y;
              const float dxz = z[u] - p.z;
              const float r2 = fmaf(dxz, dxz, fmaf(dxy, dxy, dxx * dxx));
              const float inv_r = psph_rsqrt_ftz(r2);
              const float mr = p.w * inv_r;
              const float mag = mr * inv_r * inv_r;
              acc[u][0] -= mr;
              acc[u][1] = fmaf(dxx, mag, acc[u][1]);
              acc[u][2] = fmaf(dxy, mag, acc[u][2]);
              acc[u][3] = fmaf(dxz, mag, acc[u][3]);
            }
          }
        } else {
          set_tile(tile_bad);
          // the self pair lies only in the warp's own box
          sweep(wsrc, wsih, base, base == wlo, cnt);
        }
        __syncwarp();
      }
    }
    if (lane == 0) {
      const int slot = ((blockIdx.y * gridDim.x + blockIdx.x) * PW_THREADS +
                        threadIdx.x) / 32 % PSPH_PLAN_SLOTS;
      atomicAdd(counts + slot, near_subs);
      atomicAdd(counts + PSPH_PLAN_SLOTS + slot, subs);
    }
    own_split = (wlo / PSPH_SUB) % stride == blockIdx.y;
  }
#pragma unroll
  for (int u = 0; u < PW_TPT; ++u) {
    if (ti[u] >= n) continue;
    float* pf = part_f + (size_t)blockIdx.y * 5 * n + ti[u];
    pf[0] = rho[u];
#pragma unroll
    for (int c = 0; c < 4; ++c) pf[(size_t)(c + 1) * n] = acc[u][c];
    int* pi = part_i + (size_t)blockIdx.y * 2 * n + ti[u];
    pi[0] = nn[u];
    // the split's sources less the self pair
    const bool own = PLAN ? own_split : ti[u] >= j0 && ti[u] < j1;
    pi[(size_t)n] = GRAV ? sources - (own ? 1 : 0) : 0;
  }
}

// A plan's particles in its order: position p of the sweep is particle
// perm[p]. Copies x, y, z, 1/h and m there and writes the boxes, one warp
// a box (lane l takes positions l and l + 32 of it); a box is flagged
// when one of those values is not finite.
__global__ void __launch_bounds__(PW_THREADS) pairwise_pass1_stage(
    const float* __restrict__ pos, const float* __restrict__ inv_h,
    const float* __restrict__ mass, const long long* __restrict__ perm,
    float* __restrict__ spos, float* __restrict__ sih,
    float* __restrict__ sm, float4* __restrict__ box, int n) {
  const int sub = (blockIdx.x * PW_THREADS + threadIdx.x) >> 5;
  if (sub * PSPH_SUB >= n) return;
  float4 lo, hi;
  psph_box_empty(lo, hi);
  bool bad = false;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int p = sub * PSPH_SUB + (threadIdx.x & 31) + 32 * u;
    if (p >= n) continue;
    const size_t i = (size_t)perm[p];
    const float v[5] = {pos[3 * i], pos[3 * i + 1], pos[3 * i + 2],
                        inv_h[i], mass[i]};
    spos[3 * (size_t)p] = v[0];
    spos[3 * (size_t)p + 1] = v[1];
    spos[3 * (size_t)p + 2] = v[2];
    sih[p] = v[3];
    sm[p] = v[4];
    psph_box_add(lo, hi, v[0], v[1], v[2], v[3]);
    bad = bad || !psph_all_finite(v);
  }
  psph_box_store(lo, hi, bad, box + 2 * (size_t)sub);
}

// adds the splits' partial sums in split order, the self-density term and
// the gravitational constant; sweep position p is particle perm[p] (p
// itself without a plan)
__global__ void pairwise_pass1_reduce(
    const float* __restrict__ part_f, const int* __restrict__ part_i,
    const long long* __restrict__ perm, const float* __restrict__ inv_h,
    const float* __restrict__ mass, float* __restrict__ rho,
    int* __restrict__ nn, float* __restrict__ phi, float* __restrict__ gphi,
    int* __restrict__ nd, int n, int splits, float g_const) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  float f[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  int c[2] = {0, 0};
  for (int s = 0; s < splits; ++s) {
    for (int k = 0; k < 5; ++k) f[k] += part_f[((size_t)s * 5 + k) * n + p];
    for (int k = 0; k < 2; ++k) c[k] += part_i[((size_t)s * 2 + k) * n + p];
  }
  const size_t i = perm ? (size_t)perm[p] : (size_t)p;
  const float ih = inv_h[i];
  rho[i] = mass[i] * PSPH_INV_PI * ih * ih * ih + f[0];
  nn[i] = c[0];
  phi[i] = g_const * f[1];
  gphi[3 * i] = g_const * f[2];
  gphi[3 * i + 1] = g_const * f[3];
  gphi[3 * i + 2] = g_const * f[4];
  nd[i] = c[1];
}

// The Morton keys of a plan: the bounds of the positions (NaN when one is
// NaN, as torch's min and max), then each particle's 30-bit key over them
// with ops/morton.encode's arithmetic (its float to int conversion
// truncates and saturates, NaN to 0, as a CUDA cast does). Every block
// forms the bounds over all n itself (n is at most some 10^5 on the
// exact path: a few hundred kB, read from L2 by blocks in parallel, where
// one block for all n took 18 us at n = 32,768 on the H100) and then the
// keys of its own PW_KEY_THREADS particles; block 0 zeroes the plan's
// counters.
#define PW_KEY_THREADS 1024
__device__ __forceinline__ int pw_dilate(int q) {
  unsigned x = (unsigned)q & 0x3FFu;
  x = (x | (x << 16)) & 0x030000FFu;
  x = (x | (x << 8)) & 0x0300F00Fu;
  x = (x | (x << 4)) & 0x030C30C3u;
  x = (x | (x << 2)) & 0x09249249u;
  return (int)x;
}

__global__ void __launch_bounds__(PW_KEY_THREADS) pairwise_pass1_keys(
    const float* __restrict__ pos, int* __restrict__ keys,
    int* __restrict__ counts, int n) {
  __shared__ float red[6][PW_KEY_THREADS / 32];
  __shared__ float bound[6];
  const float inf = __int_as_float(0x7f800000);
  float b[6] = {inf, inf, inf, -inf, -inf, -inf};   // lo x, y, z; hi
  for (int i = threadIdx.x; i < n; i += PW_KEY_THREADS) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float v = pos[3 * (size_t)i + c];
      b[c] = psph_min(b[c], v);
      b[c + 3] = psph_max(b[c + 3], v);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      b[c] = psph_min(b[c], __shfl_xor_sync(0xffffffffu, b[c], o));
      b[c + 3] =
          psph_max(b[c + 3], __shfl_xor_sync(0xffffffffu, b[c + 3], o));
    }
  }
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0)
    for (int c = 0; c < 6; ++c) red[c][w] = b[c];
  __syncthreads();
  if (threadIdx.x < 6) {
    float v = red[threadIdx.x][0];
    for (int k = 1; k < PW_KEY_THREADS / 32; ++k)
      v = threadIdx.x < 3 ? psph_min(v, red[threadIdx.x][k])
                          : psph_max(v, red[threadIdx.x][k]);
    bound[threadIdx.x] = v;
  }
  if (blockIdx.x == 0 && threadIdx.x < 2 * PSPH_PLAN_SLOTS)
    counts[threadIdx.x] = 0;
  __syncthreads();
  const int i = blockIdx.x * PW_KEY_THREADS + threadIdx.x;
  if (i >= n) return;
  int q[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float span = psph_max(bound[c + 3] - bound[c], 1e-30f);
    const float u = (pos[3 * (size_t)i + c] - bound[c]) / span;
    q[c] = min(max(__float2int_rz(u * 1024.0f), 0), 1023);
  }
  keys[i] = pw_dilate(q[0]) | (pw_dilate(q[1]) << 1) | (pw_dilate(q[2]) << 2);
}

extern "C" int psph_pairwise_plan(const float* pos, int* keys, int* counts,
                                  int n, void* stream) {
  const int blocks = n > 0 ? (n + PW_KEY_THREADS - 1) / PW_KEY_THREADS : 1;
  pairwise_pass1_keys<<<blocks, PW_KEY_THREADS, 0, (cudaStream_t)stream>>>(
      pos, keys, counts, n);
  return (int)cudaGetLastError();
}

// `perm` null: the sweep in the particles' own order. Otherwise the plan's
// order: `work` holds the staged copies (x, y, z [3n], 1/h, m [n]) and,
// from float 5n rounded up to a multiple of 4, the ceil(n / PSPH_SUB)
// boxes; `counts` its counters.
extern "C" int psph_pairwise_pass1(
    const float* pos, const float* inv_h, const float* mass,
    const long long* perm, float* work, int* counts, float* rho, int* nn,
    float* phi, float* gphi, int* nd, float* part_f, int* part_i, int n,
    int splits, int do_gravity, int receiver_soft, float g_const,
    void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const dim3 grid((n + PW_TARGETS - 1) / PW_TARGETS, splits);
  const int chunk = (n + splits - 1) / splits;
  cudaStream_t st = (cudaStream_t)stream;
  // what the sweep reads: the particles, or the plan's staged copies
  const float *sp = pos, *si = inv_h, *sm = mass;
  const float4* box = nullptr;
  if (perm) {
    float* const spos = work;
    float* const sih = work + 3 * (size_t)n;
    float* const smass = work + 4 * (size_t)n;
    float4* const sbox = (float4*)(work + (5 * (size_t)n + 3) / 4 * 4);
    const int subs = (n + PSPH_SUB - 1) / PSPH_SUB;
    pairwise_pass1_stage<<<(subs + 3) / 4, PW_THREADS, 0,
                           st>>>(pos, inv_h, mass, perm, spos, sih, smass,
                                 sbox, n);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    sp = spos;
    si = sih;
    sm = smass;
    box = sbox;
  }
  // the instance: gravity, receiver softening, a plan
  void (*kernel)(const float*, const float*, const float*, const float4*,
                 int*, float*, int*, int, int) =
      !do_gravity    ? (perm ? &pairwise_pass1_kernel<false, false, true>
                             : &pairwise_pass1_kernel<false, false, false>)
      : receiver_soft ? (perm ? &pairwise_pass1_kernel<true, true, true>
                              : &pairwise_pass1_kernel<true, true, false>)
                      : (perm ? &pairwise_pass1_kernel<true, false, true>
                              : &pairwise_pass1_kernel<true, false, false>);
  kernel<<<grid, PW_THREADS, 0, st>>>(sp, si, sm, box, counts, part_f, part_i,
                                      n, chunk);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  pairwise_pass1_reduce<<<(n + PW_THREADS - 1) / PW_THREADS, PW_THREADS, 0,
                          st>>>(part_f, part_i, perm, inv_h, mass, rho, nn,
                                phi, gphi, nd, n, splits, g_const);
  return (int)cudaGetLastError();
}
