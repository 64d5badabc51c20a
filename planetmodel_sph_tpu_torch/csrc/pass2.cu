// Pressure-gradient sweep over the SPH window, in every form the block
// pipeline asks for: three pressure coefficients, fused artificial
// viscosity with the Balsara limiter's div/curl sums, the conjugate energy
// equation, and fused near-field gravity with or without the merged
// residual-P2P window.
//
// Replaces: planetmodel_sph_tpu/ops/pallas/groups2.py pass2 (:649), body
// _pass2_kernel (:440), every flag.
//
// Per target i of group g, over the SPH window (nv[g] slots, rows x, y, z,
// ih, m, cc), with gw(q, h) = (dW/dr)/r and gsym = (gw_i + gw_j)/2:
//   MODE_GRADH: gp_i += m_j (tc_i gw_i + cc_j gw_j) d,
//               tc = cc = P/(Omega rho^2)
//   MODE_ASYM:  gp_i += m_j cc_j gsym d, cc = P/rho, no tc
//   MODE_SYM:   gp_i += m_j (tc_i + cc_j) gsym d, tc = cc = P/rho^2
//   SIGN_BUG:   the inner branch of gw takes +3 for -3 (the modelled
//               project's kernel derivative bug), in gp only;
//   AV (rows vx, vy, vz, h, cs, rho more, and as many target columns):
//     mu = hbar v.d / (r^2 + 0.01 hbar^2), Pi = (-alpha cbar mu
//     + beta mu^2) / rhobar on approaching pairs (v.d < 0), else 0;
//     av_i += m_j Pi gsym d, gsym WITHOUT the sign bug;
//   BALSARA (one more row and column, f): Pi *= (f_i + f_j)/2, and the raw
//     sums div_i += m_j gsym v.d, curl_i += m_j gsym (v x d) for the next
//     step's limiter;
//   ENERGY (the evolved specific internal energy; without AV three more
//     rows and columns, vx, vy, vz; not under MODE_ASYM, which has no
//     conjugate energy equation): du_i += tc_i m_j gw_i v.d under
//     MODE_GRADH, else coef v.d / 2 with the pressure coefficient above;
//     with AV also m_j Pi gsym v.d / 2, the shock heating;
//   GRAV_FUSED / GRAV_MERGED: Dyer-Ip phi, g and the count of m_j > 0 on
//     the same pair geometry, softened with 1/a = ih_i (RECV) or
//     min(ih_i, ih_j); GRAV_MERGED also sweeps the residual-P2P window
//     (nv2[g] slots, rows x, y, z, [ih,] m) into the same gravity sums.
// Outputs gp and av unscaled (the caller applies rho_i), div/curl raw, du
// complete as summed (no caller scale), g_const * (phi, g) and the direct
// count; the self pair is included in
// both windows' gravity terms and adds 0 to every gradient sum (d = 0).
//
// The kernel visits only the slots below nv, so a slot past the window
// never reaches the divisions of the viscosity term.
//
// Bound on the H100: f32 operations. Every live pair of both windows
// costs its geometry and, with gravity, its Dyer-Ip term (about 40
// operations); only the few per cent of SPH pairs inside either support
// add the pressure, viscosity and energy terms (60 to 120 more). The rows
// (24 to 52 bytes a slot) are read once per group and shared by its 64
// targets. What held the first design back: every slot below nv took both
// kernel gradients, the coefficient and the viscosity's division, dead
// slots (m = 0) and pairs outside both supports alike; one block of 64
// threads per group left the card half occupied in one ragged wave, each
// thread walking up to 2,560 SPH and 3,584 P2P slots alone; and each tile
// was loaded synchronously before its sweep. This design (common.cuh,
// psph_window):
// - tiles of PSPH_TILE slots are copied asynchronously (cp.async, 16 bytes
//   a copy), the copy of tile t + 1 in flight while tile t is swept;
// - each staged tile is compacted to its live slots (m != 0) with a
//   ballot per warp, into a slot-major layout of float4s (x, y, z, m),
//   (ih, cc, vx, vy), (vz, h, cs, rho), (f): two 16-byte shared loads a
//   pair outside the support, all of them inside;
// - per live pair the geometry and one rsqrtf(psph_max(r2, 1e-30f)) as
//   before, the Dyer-Ip term with gravity, and the SPH block only when
//   r ih_i < 2 or r ih_j < 2, or either product is NaN: outside it both
//   gw are 0, and with them every pressure, viscosity, Balsara and energy
//   term; a NaN reaches the outputs as in the plain version. A tile in
//   which a live slot holds a non-finite value in any staged row, and a
//   target with a non-finite value in any of its columns, gate out
//   nothing (all_pairs: the flag is set once a tile at the compaction and
//   once a target, and zeroes the gate's ih_i for the tile, so that the
//   gate costs what it did), since there a NaN or an infinity times a gw
//   of 0 is NaN in the plain version;
// - gravity softens with min(ih_i, ih_j) that is NaN when either is
//   (psph_min), as the plain version's torch.minimum;
// - the count of m > 0 slots (n_direct) comes from the compaction, once
//   per group;
// - the merged residual-P2P window goes through the same staging,
//   compaction and slices, in its own loop;
// - 64 targets x 4 slot slices = 256 threads a group; the slices' sums are
//   added in slice order at the end, with no atomics, so the result is
//   the same on every run. A group of more than 256 targets takes one
//   block of 256 per 256 targets (psph_grid).
// The flags are template parameters: each combination is its own kernel
// with only its rows staged and only its sums kept in registers.
#include "common.cuh"

enum { MODE_GRADH = 0, MODE_ASYM = 1, MODE_SYM = 2 };
enum { GRAV_NONE = 0, GRAV_FUSED = 1, GRAV_MERGED = 2 };

// (dW/dr)/r with its prefactors; finite at r = 0 (inner branch, no 1/r)
template <bool SIGN_BUG>
__device__ __forceinline__ float gw_from(float q, float inv_h, float inv_h4,
                                         float inv_r) {
  float val = 0.0f;
  if (q < 1.0f) {
    val = ((SIGN_BUG ? 3.0f : -3.0f) + 2.25f * q) * inv_h;
  } else if (q < 2.0f) {
    const float t = 2.0f - q;
    val = (-0.75f * t * t) * inv_r;
  }
  return (PSPH_INV_PI * inv_h4) * val;
}

// source rows in staging order; the AV block follows the six SPH rows
enum { R_X, R_Y, R_Z, R_IH, R_M, R_CC, R_VX, R_VY, R_VZ, R_H, R_CS, R_RHO,
       R_FB, R_MAX };

struct Pass2Args {
  const float* t[4];     // x, y, z, ih
  const float* tc;       // null under MODE_ASYM
  const float* tav[6];   // vx, vy, vz (AV or ENERGY), h, cs, rho (AV)
  const float* tfb;      // Balsara factor (BALSARA)
  const float* s[R_MAX];
  const float* p[5];     // residual P2P: x, y, z, ih (null under RECV), m
  const int* nv;
  const int* nv2;
  float* gp[3];
  float* av[3];
  float* dc[4];
  float* du;
  float* grav[4];
  int* nd;
  int b, s_w, s2;
  float av_alpha, av_beta, g_const;
  int ns;        // slot slices (psph_slices)
  int vec, vec2;  // the SPH and P2P rows take 16-byte copies
};

// The compacted slots are float4s: (x, y, z, m), (ih, cc, vx, vy),
// (vz, h, cs, rho), (f). row_of(c): the staged row of position c, the
// staging order with m and ih swapped.
__device__ __forceinline__ constexpr int row_of(int c) {
  return c == R_IH ? R_M : c == R_M ? R_IH : c;
}

// At most 64 registers a thread, so that four blocks of 256 threads fit
// an SM: the viscosity and Balsara forms sit at that edge, and with the
// non-finite flag the compiler otherwise takes 71-77 registers and three
// blocks an SM, which was slower than a few bytes of spill (PERF.md).
template <int MODE, bool SIGN_BUG, bool AV, bool BALSARA, int GRAV,
          bool RECV, bool ENERGY>
__global__ void __launch_bounds__(PSPH_WIN_THREADS, 4)
    pass2_kernel(const Pass2Args a) {
  constexpr bool VEL = AV || ENERGY;
  constexpr int NROWS = 6 + (AV ? 6 : (ENERGY ? 3 : 0)) + (BALSARA ? 1 : 0);
  constexpr int NQ = (NROWS + 3) / 4;
  // the sums: grad P, then the viscosity, div/curl, du and gravity blocks
  constexpr int I_AV = 3;
  constexpr int I_DC = I_AV + (AV ? 3 : 0);
  constexpr int I_DU = I_DC + (BALSARA ? 4 : 0);
  constexpr int I_GR = I_DU + (ENERGY ? 1 : 0);
  constexpr int NSUM = I_GR + (GRAV != GRAV_NONE ? 4 : 0);
  static_assert(NSUM * PSPH_WIN_THREADS <= 2 * NROWS * PSPH_TILE,
                "the slices' sums are combined in the staging buffer");
  constexpr int NP = RECV ? 4 : 5;   // residual-P2P rows: x, y, z, [ih,] m
  __shared__ __align__(16) float raw[2][NROWS][PSPH_TILE];
  __shared__ __align__(16) float4 comp[NQ][PSPH_TILE];
  __shared__ int wtab[64];
  const int g = blockIdx.x;
  const PsphShare my = psph_share(a.b);
  const int k = my.k;
  const int ns = a.ns;
  const float av_alpha = a.av_alpha, av_beta = a.av_beta;
  const size_t t = my.t;
  const float x = a.t[0][t], y = a.t[1][t], z = a.t[2][t], ih = a.t[3][t];
  float tcv = 0.0f;
  if (MODE != MODE_ASYM) tcv = a.tc[t];
  float vx = 0.0f, vy = 0.0f, vz = 0.0f, th = 0.0f, tcs = 0.0f,
        trho = 0.0f, tfb = 0.0f;
  if (VEL) vx = a.tav[0][t], vy = a.tav[1][t], vz = a.tav[2][t];
  if (AV) th = a.tav[3][t], tcs = a.tav[4][t], trho = a.tav[5][t];
  if (BALSARA) tfb = a.tfb[t];
  const float own[12] = {x, y, z, ih, tcv, vx, vy, vz, th, tcs, trho, tfb};
  const bool target_bad = !psph_all_finite(own);
  float tih4 = ih * ih;
  tih4 = tih4 * tih4;
  float acc[NSUM];
#pragma unroll
  for (int q = 0; q < NSUM; ++q) acc[q] = 0.0f;
  int nd = 0;

  // the SPH window
  const float* rows[NROWS];
#pragma unroll
  for (int r = 0; r < NROWS; ++r) rows[r] = a.s[r];
  psph_window<NROWS>(rows, (size_t)g * a.s_w, min(a.nv[g], a.s_w),
                     a.vec != 0, raw, [&](float (*st)[PSPH_TILE], int c) {
    bool tile_bad;
    const int live = psph_compact(st[R_M], c, wtab, nd, tile_bad,
                                  [&](int j, int at) {
      bool ok = true;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = 4 * q + e;
          v[e] = p < NROWS ? st[p < NROWS ? row_of(p) : 0][j] : 0.0f;
        }
        comp[q][at] = make_float4(v[0], v[1], v[2], v[3]);
        ok = ok && psph_all_finite(v);
      }
      return !ok;
    });
    const bool all_pairs = tile_bad || target_bad;
    // the gate's ih for this tile: 0 opens it for every pair (r 0 is 0
    // or NaN, never >= 2)
    const float ih_gate = all_pairs ? 0.0f : ih;
    for (int j = my.from; j < live; j += ns) {
      const float4 q0 = comp[0][j];
      const float4 q1 = comp[1][j];
      const float dxx = x - q0.x;
      const float dxy = y - q0.y;
      const float dxz = z - q0.z;
      const float r2 = dxx * dxx + dxy * dxy + dxz * dxz;
      const float m = q0.w;
      const float jh = q1.x;
      const float inv_r = rsqrtf(psph_max(r2, 1e-30f));
      const float r = r2 * inv_r;
      if (!(r * ih_gate >= 2.0f && r * jh >= 2.0f)) {
        // inside the support of i or j, or a NaN in r, ih or jh: the SPH
        // terms (r min(ih, jh) rounds as min(r ih, r jh) for r >= 0)
        const float cc = q1.y;
        float4 q2 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        float fb = 0.0f;
        if (NQ > 2) q2 = comp[NQ > 2 ? 2 : 0][j];
        if (BALSARA) fb = comp[NQ > 3 ? 3 : 0][j].x;
        float jh4 = jh * jh;
        jh4 = jh4 * jh4;
        const float q = r * ih;
        const float qj = r * jh;
        const float gw_i = gw_from<SIGN_BUG>(q, ih, tih4, inv_r);
        const float gw_j = gw_from<SIGN_BUG>(qj, jh, jh4, inv_r);
        float coef;
        if (MODE == MODE_GRADH)
          coef = m * (tcv * gw_i + cc * gw_j);
        else if (MODE == MODE_ASYM)
          coef = m * cc * (0.5f * (gw_i + gw_j));
        else
          coef = m * (tcv + cc) * (0.5f * (gw_i + gw_j));
        acc[0] += dxx * coef;
        acc[1] += dxy * coef;
        acc[2] += dxz * coef;
        float dvx = 0.0f, dvy = 0.0f, dvz = 0.0f, vdotr = 0.0f, cav = 0.0f;
        if (VEL) {
          dvx = vx - q1.z;
          dvy = vy - q1.w;
          dvz = vz - q2.x;
          vdotr = dvx * dxx + dvy * dxy + dvz * dxz;
        }
        if (AV) {
          const float hbar = 0.5f * (th + q2.y);
          const float mu = hbar * vdotr / (r2 + 0.01f * hbar * hbar);
          const float cbar = 0.5f * (tcs + q2.z);
          const float rhobar = 0.5f * (trho + q2.w);
          float pi_ij = 0.0f;
          if (vdotr < 0.0f)
            pi_ij = (-av_alpha * cbar * mu + av_beta * mu * mu) / rhobar;
          if (BALSARA) pi_ij = pi_ij * (0.5f * (tfb + fb));
          // the viscosity always takes the correct derivative
          const float gs_av =
              SIGN_BUG ? 0.5f * (gw_from<false>(q, ih, tih4, inv_r) +
                                 gw_from<false>(qj, jh, jh4, inv_r))
                       : 0.5f * (gw_i + gw_j);
          cav = m * pi_ij * gs_av;
          acc[I_AV] += dxx * cav;
          acc[I_AV + 1] += dxy * cav;
          acc[I_AV + 2] += dxz * cav;
          if (BALSARA) {
            const float g_dc = m * gs_av;
            acc[I_DC] += g_dc * vdotr;
            acc[I_DC + 1] += g_dc * (dvy * dxz - dvz * dxy);
            acc[I_DC + 2] += g_dc * (dvz * dxx - dvx * dxz);
            acc[I_DC + 3] += g_dc * (dvx * dxy - dvy * dxx);
          }
        }
        if (ENERGY) {
          // conjugate energy equation on the same pair quantities: the
          // pressure work, and half the viscous dissipation
          float du_p = MODE == MODE_GRADH ? tcv * (m * gw_i) * vdotr
                                          : 0.5f * coef * vdotr;
          if (AV) du_p = du_p + 0.5f * cav * vdotr;
          acc[I_DU] += du_p;
        }
      }
      if (GRAV != GRAV_NONE)
        psph_dyer_ip(m, dxx, dxy, dxz, r2, inv_r,
                     RECV ? ih : psph_min(ih, jh), acc[I_GR],
                     acc[I_GR + 1], acc[I_GR + 2], acc[I_GR + 3]);
    }
  });

  // the residual-P2P window into the same gravity sums
  if (GRAV == GRAV_MERGED) {
    const float* prow[NP];
    prow[0] = a.p[0];
    prow[1] = a.p[1];
    prow[2] = a.p[2];
    if (!RECV) prow[3] = a.p[3];
    prow[NP - 1] = a.p[4];
    auto praw = reinterpret_cast<float (*)[NP][PSPH_TILE]>(&raw[0][0][0]);
    psph_window<NP>(prow, (size_t)g * a.s2, min(a.nv2[g], a.s2),
                    a.vec2 != 0, praw, [&](float (*st)[PSPH_TILE], int c) {
      bool unused;    // gravity leaves out no pair
      const int live = psph_compact(st[NP - 1], c, wtab, nd, unused,
                                    [&](int j, int at) {
        comp[0][at] = make_float4(st[0][j], st[1][j], st[2][j],
                                  st[NP - 1][j]);
        if (!RECV) comp[1][at].x = st[RECV ? 0 : 3][j];
        return false;
      });
      for (int j = my.from; j < live; j += ns) {
        const float4 q0 = comp[0][j];
        const float dxx = x - q0.x;
        const float dxy = y - q0.y;
        const float dxz = z - q0.z;
        const float r2 = dxx * dxx + dxy * dxy + dxz * dxz;
        const float inv_r = rsqrtf(psph_max(r2, 1e-30f));
        const float inv_a = RECV ? ih : psph_min(ih, comp[1][j].x);
        psph_dyer_ip(q0.w, dxx, dxy, dxz, r2, inv_r, inv_a, acc[I_GR],
                     acc[I_GR + 1], acc[I_GR + 2], acc[I_GR + 3]);
      }
    });
  }

  psph_combine(acc, &raw[0][0][0], my.bt, ns);
  if (k != 0 || !my.on) return;
  a.gp[0][t] = acc[0];
  a.gp[1][t] = acc[1];
  a.gp[2][t] = acc[2];
  if (AV) {
    a.av[0][t] = acc[I_AV];
    a.av[1][t] = acc[I_AV + 1];
    a.av[2][t] = acc[I_AV + 2];
  }
  if (BALSARA) {
#pragma unroll
    for (int q = 0; q < 4; ++q) a.dc[q][t] = acc[I_DC + q];
  }
  if (ENERGY) a.du[t] = acc[I_DU];
  if (GRAV != GRAV_NONE) {
#pragma unroll
    for (int q = 0; q < 4; ++q) a.grav[q][t] = a.g_const * acc[I_GR + q];
    a.nd[t] = nd;
  }
}

// Runtime flags to template parameters, one level per flag. Only the
// combinations the block pipeline can ask for exist: BALSARA needs AV,
// RECV matters only with gravity, and ENERGY has no MODE_ASYM form.
template <int MODE, bool SB, bool AV, bool BAL, int GRAV, bool RECV>
static void launch6(const Pass2Args& a, int g, int energy, cudaStream_t st) {
  if constexpr (MODE != MODE_ASYM) {
    if (energy) {
      pass2_kernel<MODE, SB, AV, BAL, GRAV, RECV, true>
          <<<psph_grid(g, a.b), psph_block(a.b, a.ns), 0, st>>>(a);
      return;
    }
  }
  pass2_kernel<MODE, SB, AV, BAL, GRAV, RECV, false>
      <<<psph_grid(g, a.b), psph_block(a.b, a.ns), 0, st>>>(a);
}

template <int MODE, bool SB, bool AV, bool BAL>
static void launch4(const Pass2Args& a, int g, int grav, int recv,
                    int energy, cudaStream_t st) {
  if (grav == GRAV_NONE)
    launch6<MODE, SB, AV, BAL, GRAV_NONE, false>(a, g, energy, st);
  else if (grav == GRAV_FUSED)
    recv ? launch6<MODE, SB, AV, BAL, GRAV_FUSED, true>(a, g, energy, st)
         : launch6<MODE, SB, AV, BAL, GRAV_FUSED, false>(a, g, energy, st);
  else
    recv ? launch6<MODE, SB, AV, BAL, GRAV_MERGED, true>(a, g, energy, st)
         : launch6<MODE, SB, AV, BAL, GRAV_MERGED, false>(a, g, energy, st);
}

template <int MODE, bool SB>
static void launch2(const Pass2Args& a, int g, int av, int bal, int grav,
                    int recv, int energy, cudaStream_t st) {
  if (!av)
    launch4<MODE, SB, false, false>(a, g, grav, recv, energy, st);
  else if (!bal)
    launch4<MODE, SB, true, false>(a, g, grav, recv, energy, st);
  else
    launch4<MODE, SB, true, true>(a, g, grav, recv, energy, st);
}

template <int MODE>
static void launch1(const Pass2Args& a, int g, int sb, int av, int bal,
                    int grav, int recv, int energy, cudaStream_t st) {
  sb ? launch2<MODE, true>(a, g, av, bal, grav, recv, energy, st)
     : launch2<MODE, false>(a, g, av, bal, grav, recv, energy, st);
}

// Pointers a flag switches off are null: tc under mode 1; the velocity
// columns and rows without av and energy, the other AV columns and rows
// without av; tfb, sfb and the dc outputs without balsara; du without
// energy; the P2P rows and nv2 unless grav == 2 (pih also under
// receiver_soft); the gravity outputs when grav == 0.
extern "C" int psph_pass2(
    const float* tx, const float* ty, const float* tz, const float* tih,
    const float* tc, const float* tvx, const float* tvy, const float* tvz,
    const float* th, const float* tcs, const float* trho, const float* tfb,
    const float* sx, const float* sy, const float* sz, const float* sih,
    const float* sm, const float* scc, const float* svx, const float* svy,
    const float* svz, const float* sh, const float* scs, const float* srho,
    const float* sfb, const float* px, const float* py, const float* pz,
    const float* pih, const float* pm, const int* nv, const int* nv2,
    float* gpx, float* gpy, float* gpz, float* avx, float* avy, float* avz,
    float* dv, float* cvx, float* cvy, float* cvz, float* du, float* phi,
    float* gx, float* gy, float* gz, int* nd, int g, int b, int s, int s2,
    int mode, int sign_bug, int av, int balsara, int energy, int grav,
    int receiver_soft, float av_alpha, float av_beta, float g_const,
    void* stream) {
  if (mode < MODE_GRADH || mode > MODE_SYM || grav < GRAV_NONE ||
      grav > GRAV_MERGED || (balsara && !av) ||
      (energy && mode == MODE_ASYM))
    return (int)cudaErrorInvalidValue;
  Pass2Args a = {{tx, ty, tz, tih}, tc, {tvx, tvy, tvz, th, tcs, trho}, tfb,
                 {sx, sy, sz, sih, sm, scc, svx, svy, svz, sh, scs, srho,
                  sfb},
                 {px, py, pz, pih, pm}, nv, nv2, {gpx, gpy, gpz},
                 {avx, avy, avz}, {dv, cvx, cvy, cvz}, du, {phi, gx, gy, gz},
                 nd,
                 b, s, s2, av_alpha, av_beta, g_const,
                 psph_slices(b), 0, 0};
  if (g > 0 && a.ns == 0) return (int)cudaErrorInvalidValue;
  a.vec = psph_vec_rows(a.s, R_MAX, s) ? 1 : 0;
  a.vec2 = psph_vec_rows(a.p, 5, s2) ? 1 : 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (g > 0) {
    if (mode == MODE_GRADH)
      launch1<MODE_GRADH>(a, g, sign_bug, av, balsara, grav, receiver_soft,
                          energy, st);
    else if (mode == MODE_ASYM)
      launch1<MODE_ASYM>(a, g, sign_bug, av, balsara, grav, receiver_soft,
                          energy, st);
    else
      launch1<MODE_SYM>(a, g, sign_bug, av, balsara, grav, receiver_soft,
                          energy, st);
  }
  return (int)cudaGetLastError();
}
