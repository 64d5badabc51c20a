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
// Bound on the H100: pair arithmetic, as pass 1; only a few per mille of
// the pairs lie inside a support, and every term of a pair carries a
// kernel-gradient factor, so a pair outside both supports adds exactly 0.
// What held the first design back: one thread a target and six scalar
// shared loads a pair, m read before the gate; the IEEE square root, both
// q and the gate on every pair; the self test j == i in the inner loop of
// every tile. What held the second back: it still tested every pair, some
// 17 instructions each, to find the 0.2 % inside a support. This design
// (pairwise_pass1.cu's):
// - the plan's Morton order and boxes (pairwise_pass1.cu's note;
//   pairwise_pass2_stage copies this pass's fields into that order and
//   writes its own boxes, flagged by every value it copies and by the
//   factors P/rho, P/rho^2 the sweep forms): a sub-tile far from the
//   warp's box holds no pair the q^2 test keeps, so the warp neither
//   stages nor sweeps it; what bounds the pass is then the near
//   sub-tiles' pairs. Under a plan each warp works on its own and takes
//   every splits-th sub-tile of its split, so that the near work, which
//   clusters about each warp's own place in the order, spreads over the
//   splits. Without a plan every tile is staged by the block and swept
//   whole;
// - PW_TPT = 2 targets a thread, which share each source's shared loads
//   (two beat one in every case on the H100; under a plan neighbours in
//   the warp's box); the source's x, y, z and 1/h are staged as one
//   float4, so a pair the test leaves out costs one 16-byte shared load
//   for two targets; m, the pressure factor and the viscosity fields are
//   read only for a pair that passes;
// - the q^2 test before the square root, ihm = psph_min(ih_i, ih_j): a
//   pair with (r2 ihm) ihm > PSPH_Q2_SKIP lies outside both supports and
//   adds nothing; the exact gate "r/h_i >= 2 and r/h_j >= 2" stays for the
//   pairs that pass;
// - the pairs the test keeps are listed, per thread, in shared memory and
//   evaluated after the sweep of the tile (of a near sub-tile under a
//   plan), or when the list may not hold the next source's pairs
//   (pairwise_pass1.cu's list): the sweep's loop holds only the test;
// - diagonal tiles apart: only a tile whose source range meets the block's
//   targets (under a plan: the warp's own box) runs the sweep with the
//   self test;
// - a NaN or an infinity reaches the sums as in the plain version, which
//   multiplies a pair outside both supports by a gradient of 0 (a
//   non-finite field times 0 is NaN): a flagged box is never far; a tile
//   in which a staged field (or the factor formed from them) is not
//   finite, and a target with a non-finite value in what it reads of
//   itself, skip nothing (all_pairs: set once a tile at the staging and
//   once a target; it zeroes the target's 1/h of the test and the gate
//   for the tile), and a NaN in r2 or either 1/h fails the test and is
//   listed. A flagged target also visits its self pair with m = 0, as
//   the plain version weighs it;
// - the per-source factor P_j/rho_j (or P_j/rho_j^2) is formed once when
//   the tile is staged;
// - blockIdx.y splits the sources (under a plan every splits-th
//   sub-tile) and a second kernel adds the splits' partial sums in split
//   order (no atomics), writing each to its particle's own index.
// This kernel decides only through q < 1, q < 2 inside continuous
// functions and v.x < 0, its sums are held to a tolerance, and it keeps
// multiply-add contraction.
#include "common.cuh"

#define PW_THREADS 128
#define PW_TPT 2
#define PW_TARGETS (PW_THREADS * PW_TPT)
#define PW_TILE PW_TARGETS
// pairs the q^2 test keeps that a thread lists before it evaluates them
#define PW_DEFER 16
// a listed pair: source k (8 bits), target u (bit 8), the self pair (bit 9)
static_assert(PW_TILE <= 256 && PW_TPT == 2, "the list's entries");
static_assert(PW_TPT * 32 == PSPH_SUB && PW_TILE % PSPH_SUB == 0,
              "a warp's targets are one box, a tile whole boxes");

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

// The sweep, with (PLAN) and without a plan as pairwise_pass1_kernel's
// (its note); under a plan each warp stages and sweeps only the sub-tiles
// near its box.
template <bool AV, bool BAL, bool PLAN>
__global__ void __launch_bounds__(PW_THREADS) pairwise_pass2_kernel(
    const float* __restrict__ pos, const float* __restrict__ inv_h,
    const float* __restrict__ mass, const float* __restrict__ rho,
    const float* __restrict__ prs, const float* __restrict__ vel,
    const float* __restrict__ hh, const float* __restrict__ cs,
    const float* __restrict__ fb, const float4* __restrict__ box,
    int* __restrict__ counts, float* __restrict__ part, int n, int chunk,
    int asymmetric, int sign_bug, float av_alpha, float av_beta) {
  constexpr int NOUT = BAL ? 7 : 3;
  __shared__ __align__(16) float4 geo[PW_TILE];    // x, y, z, ih
  __shared__ float cm[PW_TILE], cp[PW_TILE];
  __shared__ float cvx[AV ? PW_TILE : 1], cvy[AV ? PW_TILE : 1],
      cvz[AV ? PW_TILE : 1], chh[AV ? PW_TILE : 1], ccs[AV ? PW_TILE : 1],
      crho[AV ? PW_TILE : 1], cfb[BAL ? PW_TILE : 1];
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
  const float lin = sign_bug ? 3.0f : -3.0f;
  int ti[PW_TPT];
  float x[PW_TPT], y[PW_TPT], z[PW_TPT], ih[PW_TPT], ri[PW_TPT],
      pi_i[PW_TPT];
  float vx[PW_TPT], vy[PW_TPT], vz[PW_TPT], hi[PW_TPT], csi[PW_TPT],
      fbi[PW_TPT];
  bool target_bad[PW_TPT];
  float acc[PW_TPT][NOUT];
#pragma unroll
  for (int u = 0; u < PW_TPT; ++u) {
    const int i = ti[u] =
        PLAN ? wlo + PW_TPT * lane + u : lo + threadIdx.x + u * PW_THREADS;
    x[u] = y[u] = z[u] = pi_i[u] = 0.0f;
    ih[u] = ri[u] = 1.0f;
    vx[u] = vy[u] = vz[u] = csi[u] = 0.0f;
    hi[u] = fbi[u] = 1.0f;
    if (i < n) {
      x[u] = pos[3 * (size_t)i];
      y[u] = pos[3 * (size_t)i + 1];
      z[u] = pos[3 * (size_t)i + 2];
      ih[u] = inv_h[i];
      ri[u] = rho[i];
      pi_i[u] = prs[i] / (ri[u] * ri[u]);
      if constexpr (AV) {
        vx[u] = vel[3 * (size_t)i];
        vy[u] = vel[3 * (size_t)i + 1];
        vz[u] = vel[3 * (size_t)i + 2];
        hi[u] = hh[i];
        csi[u] = cs[i];
      }
      if constexpr (BAL) fbi[u] = fb[i];
    }
    const float own[12] = {x[u], y[u], z[u], ih[u], ri[u], pi_i[u],
                           vx[u], vy[u], vz[u], hi[u], csi[u], fbi[u]};
    target_bad[u] = !psph_all_finite(own);
#pragma unroll
    for (int k = 0; k < NOUT; ++k) acc[u][k] = 0.0f;
  }
  // source j's staged values: x, y, z, 1/h, m, the factor P/rho (or
  // P/rho^2), rho and (with viscosity) v, h, c_s, (with Balsara) f
  auto fetch = [&](size_t j, float (&v)[13]) {
    const float rj = rho[j];
    v[0] = pos[3 * j];
    v[1] = pos[3 * j + 1];
    v[2] = pos[3 * j + 2];
    v[3] = inv_h[j];
    v[4] = mass[j];
    v[5] = asymmetric ? prs[j] / rj : prs[j] / (rj * rj);
    v[6] = rj;
    v[7] = v[8] = v[9] = v[10] = v[11] = v[12] = 0.0f;
    if constexpr (AV) {
      v[7] = vel[3 * j];
      v[8] = vel[3 * j + 1];
      v[9] = vel[3 * j + 2];
      v[10] = hh[j];
      v[11] = cs[j];
    }
    if constexpr (BAL) v[12] = fb[j];
  };
  // stages them in slot k of the tile (or of the warp's quarter of it);
  // false if one is not finite
  auto put = [&](int k, const float (&v)[13]) {
    geo[k] = make_float4(v[0], v[1], v[2], v[3]);
    cm[k] = v[4];
    cp[k] = v[5];
    if constexpr (AV) {
      cvx[k] = v[7];
      cvy[k] = v[8];
      cvz[k] = v[9];
      chh[k] = v[10];
      ccs[k] = v[11];
      crho[k] = v[6];
    }
    if constexpr (BAL) cfb[k] = v[12];
    return psph_all_finite(v);
  };
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
  // the terms of target u and staged source k that the q^2 test kept (d =
  // x_i - x_j, r2 = |d|^2); `self`: the self pair, which the plain version
  // weighs with m = 0
  auto near = [&](int u, int k, float jh, float dxx, float dxy, float dxz,
                  float r2, bool self) {
    const float r = sqrtf(r2);
    const float qi = r * ih[u];
    const float qj = r * jh;
    if (r * ih_tile[u] >= 2.0f && qj >= 2.0f) return;
    const float m = self ? 0.0f : cm[k];
    const float gw =
        0.5f * (pw_gw(r, qi, ih[u], lin) + pw_gw(r, qj, jh, lin));
    float coef = asymmetric ? m * cp[k] * gw
                            : m * (pi_i[u] + cp[k]) * ri[u] * gw;
    if constexpr (AV) {
      const float dvx = vx[u] - cvx[k];
      const float dvy = vy[u] - cvy[k];
      const float dvz = vz[u] - cvz[k];
      const float vdotr = dvx * dxx + dvy * dxy + dvz * dxz;
      const float gs_av =
          sign_bug ? 0.5f * (pw_gw(r, qi, ih[u], -3.0f)
                             + pw_gw(r, qj, jh, -3.0f))
                   : gw;
      if (vdotr < 0.0f) {
        const float hbar = 0.5f * (hi[u] + chh[k]);
        const float mu = hbar * vdotr / (r2 + 0.01f * hbar * hbar);
        const float cbar = 0.5f * (csi[u] + ccs[k]);
        const float rhobar = 0.5f * (ri[u] + crho[k]);
        float pij = (-av_alpha * cbar * mu + av_beta * mu * mu) / rhobar;
        if constexpr (BAL) pij *= 0.5f * (fbi[u] + cfb[k]);
        coef += m * pij * gs_av * ri[u];
      }
      if constexpr (BAL) {
        const float g_dc = m * gs_av;
        acc[u][3] += g_dc * vdotr;
        acc[u][4] += g_dc * (dvy * dxz - dvz * dxy);
        acc[u][5] += g_dc * (dvz * dxx - dvx * dxz);
        acc[u][6] += g_dc * (dvx * dxy - dvy * dxx);
      }
    }
    acc[u][0] += dxx * coef;
    acc[u][1] += dxy * coef;
    acc[u][2] += dxz * coef;
  };
  // the sweep of `cnt` staged sources from slot k0, the first source
  // `base`: the q^2 test of every (target, source) pair, each pair it
  // keeps listed (slot k, target u, the self bit); whenever a list may not
  // hold the next source's pairs, and at the end, the listed pairs go to
  // near() in the order listed, so each target's pairs are added in source
  // order. `diag`: the sources meet the targets, and the self pair is
  // visited only by a flagged target
  auto sweep = [&](int k0, int base, bool diag, int cnt) {
    int k = k0;
    do {
      unsigned short* qw = qbase;
      for (; k < k0 + cnt; ++k) {
        const float4 p = geo[k];
#pragma unroll
        for (int u = 0; u < PW_TPT; ++u) {
          const bool self = diag && base + (k - k0) == ti[u];
          const float dxx = x[u] - p.x;
          const float dxy = y[u] - p.y;
          const float dxz = z[u] - p.z;
          const float r2 = fmaf(dxz, dxz, fmaf(dxy, dxy, dxx * dxx));
          const float ihm = psph_min(ih_tile[u], p.w);
          if (!((r2 * ihm) * ihm > PSPH_Q2_SKIP) &&
              (!self || target_bad[u])) {
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
        const float4 p = geo[kk];
        auto visit = [&](int u) {
          const float dxx = x[u] - p.x;
          const float dxy = y[u] - p.y;
          const float dxz = z[u] - p.z;
          near(u, kk, p.w, dxx, dxy, dxz,
               dxx * dxx + dxy * dxy + dxz * dxz, (v & 512) != 0);
        };
        if (v & 256)
          visit(1);
        else
          visit(0);
      }
    } while (k < k0 + cnt);
  };
  if constexpr (!PLAN) {
    for (int base = j0; base < j1; base += PW_TILE) {
      const int cnt = min(PW_TILE, j1 - base);
      bool bad = false;
      for (int k = threadIdx.x; k < cnt; k += PW_THREADS) {
        float v[13];
        fetch((size_t)base + k, v);
        if (!put(k, v)) bad = true;
      }
      const bool tile_bad = __syncthreads_or(bad) != 0;
      set_tile(tile_bad);
      // the self pair lies only in a tile whose source range meets the
      // block's targets
      if (base < lo + PW_TARGETS && base + cnt > lo)
        sweep(0, base, true, cnt);
      else
        sweep(0, base, false, cnt);
      __syncthreads();
    }
  } else {
    const int k0 = (threadIdx.x >> 5) * PSPH_SUB;   // the warp's slots
    const float4 tlo = box[2 * (wlo / PSPH_SUB)];
    const float4 thi = box[2 * (wlo / PSPH_SUB) + 1];
    const int nsub = (n + PSPH_SUB - 1) / PSPH_SUB;
    const int stride = gridDim.y;
    int near_subs = 0, subs = 0;
    for (int s0 = blockIdx.y; s0 < nsub; s0 += 32 * stride) {
      // lane l decides sub-tile s0 + l stride; a far one adds nothing and
      // is not staged
      const int sb = s0 + lane * stride;
      const bool live = sb < nsub;
      const bool keep = live && !psph_box_far(tlo, thi, box[2 * sb],
                                              box[2 * sb + 1]);
      const unsigned keeps = __ballot_sync(0xffffffffu, keep);
      subs += __popc(__ballot_sync(0xffffffffu, live));
      near_subs += __popc(keeps);
      for (unsigned todo = keeps; todo; todo &= todo - 1) {
        const int base = (s0 + (__ffs(todo) - 1) * stride) * PSPH_SUB;
        const int cnt = min(PSPH_SUB, n - base);
        // the lane's sources k = lane + 32 t, all loaded before any is
        // stored (a source past the end loads the last one's values)
        float v[PSPH_SUB / 32][13];
#pragma unroll
        for (int t = 0; t < PSPH_SUB / 32; ++t)
          fetch((size_t)base + min(lane + 32 * t, cnt - 1), v[t]);
        bool bad = false;
#pragma unroll
        for (int t = 0; t < PSPH_SUB / 32; ++t)
          if (lane + 32 * t < cnt && !put(k0 + lane + 32 * t, v[t]))
            bad = true;
        const bool tile_bad = __any_sync(0xffffffffu, bad);
        __syncwarp();
        set_tile(tile_bad);
        // the self pair lies only in the warp's own box
        sweep(k0, base, base == wlo, cnt);
        __syncwarp();
      }
    }
    if (lane == 0) {
      const int slot = ((blockIdx.y * gridDim.x + blockIdx.x) * PW_THREADS +
                        threadIdx.x) / 32 % PSPH_PLAN_SLOTS;
      atomicAdd(counts + slot, near_subs);
      atomicAdd(counts + PSPH_PLAN_SLOTS + slot, subs);
    }
  }
#pragma unroll
  for (int u = 0; u < PW_TPT; ++u) {
    if (ti[u] >= n) continue;
    float* p = part + (size_t)blockIdx.y * NOUT * n + ti[u];
#pragma unroll
    for (int k = 0; k < NOUT; ++k) p[(size_t)k * n] = acc[u][k];
  }
}

// A plan's particles in its order (position p of the sweep is particle
// perm[p]): copies x, y, z, 1/h, m, rho, P and, with `av`, the velocity,
// h and sound speed, with `bal` the limiter factor; writes the boxes, one
// warp a box (lane l takes positions l and l + 32 of it). A box is flagged
// when one of those values is not finite, or a value the sweep forms of
// them as a source (P/rho or P/rho^2) or a target (P/rho^2).
template <bool AV, bool BAL>
__global__ void __launch_bounds__(PW_THREADS) pairwise_pass2_stage(
    const float* __restrict__ pos, const float* __restrict__ inv_h,
    const float* __restrict__ mass, const float* __restrict__ rho,
    const float* __restrict__ prs, const float* __restrict__ vel,
    const float* __restrict__ hh, const float* __restrict__ cs,
    const float* __restrict__ fb, const long long* __restrict__ perm,
    float* __restrict__ work, float4* __restrict__ box, int n,
    int asymmetric) {
  const int sub = (blockIdx.x * PW_THREADS + threadIdx.x) >> 5;
  if (sub * PSPH_SUB >= n) return;
  float4 lo, hi;
  psph_box_empty(lo, hi);
  bool bad = false;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const size_t p = (size_t)sub * PSPH_SUB + (threadIdx.x & 31) + 32 * u;
    if (p >= (size_t)n) continue;
    const size_t i = (size_t)perm[p];
    const float rj = rho[i];
    float v[14] = {pos[3 * i], pos[3 * i + 1], pos[3 * i + 2], inv_h[i],
                   mass[i], rj, prs[i],
                   asymmetric ? prs[i] / rj : prs[i] / (rj * rj),
                   prs[i] / (rj * rj), 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int c = 0; c < 3; ++c) work[3 * p + c] = v[c];
#pragma unroll
    for (int c = 3; c < 7; ++c) work[c * (size_t)n + p] = v[c];
    if constexpr (AV) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        work[7 * (size_t)n + 3 * p + c] = v[9 + c] = vel[3 * i + c];
      work[10 * (size_t)n + p] = v[12] = hh[i];
      work[11 * (size_t)n + p] = v[13] = cs[i];
    }
    if constexpr (BAL) {
      work[12 * (size_t)n + p] = fb[i];
      bad = bad || !isfinite(fb[i]);
    }
    psph_box_add(lo, hi, v[0], v[1], v[2], v[3]);
    bad = bad || !psph_all_finite(v);
  }
  psph_box_store(lo, hi, bad, box + 2 * (size_t)sub);
}

// adds the splits' partial sums in split order into grad P [n,3] and, with
// nout = 7, the div/curl sums dc [n,4]; sweep position p is particle
// perm[p] (p itself without a plan)
__global__ void pairwise_pass2_reduce(const float* __restrict__ part,
                                      const long long* __restrict__ perm,
                                      float* __restrict__ gp,
                                      float* __restrict__ dc, int n,
                                      int splits, int nout) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const size_t i = perm ? (size_t)perm[p] : (size_t)p;
  for (int k = 0; k < nout; ++k) {
    float f = 0.0f;
    for (int s = 0; s < splits; ++s)
      f += part[((size_t)s * nout + k) * n + p];
    if (k < 3)
      gp[3 * i + k] = f;
    else
      dc[4 * i + (k - 3)] = f;
  }
}

template <bool AV, bool BAL>
static int pw_pass2(const float* pos, const float* inv_h, const float* mass,
                    const float* rho, const float* prs, const float* vel,
                    const float* hh, const float* cs, const float* fb,
                    const long long* perm, float* work, int* counts,
                    float* gp, float* dc, float* part, int n, int splits,
                    int asymmetric, int sign_bug, float av_alpha,
                    float av_beta, cudaStream_t st) {
  const dim3 grid((n + PW_TARGETS - 1) / PW_TARGETS, splits);
  const int chunk = (n + splits - 1) / splits;
  const float4* box = nullptr;
  if (perm) {
    float4* const sbox = (float4*)(work + (13 * (size_t)n + 3) / 4 * 4);
    const int subs = (n + PSPH_SUB - 1) / PSPH_SUB;
    pairwise_pass2_stage<AV, BAL>
        <<<(subs + 3) / 4, PW_THREADS, 0, st>>>(
            pos, inv_h, mass, rho, prs, vel, hh, cs, fb, perm, work, sbox, n,
            asymmetric);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    const size_t m = n;
    pos = work;
    inv_h = work + 3 * m;
    mass = work + 4 * m;
    rho = work + 5 * m;
    prs = work + 6 * m;
    if (AV) {
      vel = work + 7 * m;
      hh = work + 10 * m;
      cs = work + 11 * m;
    }
    if (BAL) fb = work + 12 * m;
    box = sbox;
  }
  void (*kernel)(const float*, const float*, const float*, const float*,
                 const float*, const float*, const float*, const float*,
                 const float*, const float4*, int*, float*, int, int, int,
                 int, float, float) =
      perm ? &pairwise_pass2_kernel<AV, BAL, true>
           : &pairwise_pass2_kernel<AV, BAL, false>;
  kernel<<<grid, PW_THREADS, 0, st>>>(pos, inv_h, mass, rho, prs, vel, hh,
                                      cs, fb, box, counts, part, n, chunk,
                                      asymmetric, sign_bug, av_alpha,
                                      av_beta);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  pairwise_pass2_reduce<<<(n + PW_THREADS - 1) / PW_THREADS, PW_THREADS, 0,
                          st>>>(part, perm, gp, dc, n, splits, BAL ? 7 : 3);
  return (int)cudaGetLastError();
}

// `perm` null: the sweep in the particles' own order. Otherwise the plan's
// order: `work` holds the staged copies (x, y, z [3n], 1/h, m, rho, P
// [n], v [3n], h, c_s, f [n]) and, from float 13n rounded up to a
// multiple of 4, the ceil(n / PSPH_SUB) boxes; `counts` its counters.
extern "C" int psph_pairwise_pass2(
    const float* pos, const float* inv_h, const float* mass,
    const float* rho, const float* prs, const float* vel, const float* hh,
    const float* cs, const float* fb, const long long* perm, float* work,
    int* counts, float* gp, float* dc, float* part, int n, int splits,
    int asymmetric, int sign_bug, int av, int balsara, float av_alpha,
    float av_beta, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (av && balsara)
    return pw_pass2<true, true>(pos, inv_h, mass, rho, prs, vel, hh, cs, fb,
                                perm, work, counts, gp, dc, part, n, splits,
                                asymmetric, sign_bug, av_alpha, av_beta, st);
  if (av)
    return pw_pass2<true, false>(pos, inv_h, mass, rho, prs, vel, hh, cs, fb,
                                 perm, work, counts, gp, dc, part, n, splits,
                                 asymmetric, sign_bug, av_alpha, av_beta, st);
  return pw_pass2<false, false>(pos, inv_h, mass, rho, prs, vel, hh, cs, fb,
                                perm, work, counts, gp, dc, part, n, splits,
                                asymmetric, sign_bug, av_alpha, av_beta, st);
}
