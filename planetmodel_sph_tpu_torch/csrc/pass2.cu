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
// Bound on the H100: 60 to 160 f32 operations per SPH slot, by the flags,
// and 30 per P2P slot for each of the group's 64 targets, against 24 to 52
// bytes of source row per slot read once per group: pair arithmetic bounds
// it. Design: one thread block per target group, one thread per target,
// source slots staged PSPH_TILE at a time in shared memory, sums in
// registers, loops that stop at nv and nv2. The flags are template
// parameters: each combination is its own kernel with only its rows staged
// and only its sums kept in registers. r and 1/r come from one
// rsqrtf(max(r2, 1e-30)) per pair.
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
};

template <int MODE, bool SIGN_BUG, bool AV, bool BALSARA, int GRAV,
          bool RECV, bool ENERGY>
__global__ void pass2_kernel(const Pass2Args a) {
  constexpr bool VEL = AV || ENERGY;
  constexpr int NROWS = 6 + (AV ? 6 : (ENERGY ? 3 : 0)) + (BALSARA ? 1 : 0);
  __shared__ float c[NROWS][PSPH_TILE];
  const int g = blockIdx.x;
  const int i = threadIdx.x;
  const size_t t = (size_t)g * a.b + i;
  const float x = a.t[0][t], y = a.t[1][t], z = a.t[2][t], ih = a.t[3][t];
  float tcv = 0.0f;
  if (MODE != MODE_ASYM) tcv = a.tc[t];
  float vx = 0.0f, vy = 0.0f, vz = 0.0f, th = 0.0f, tcs = 0.0f,
        trho = 0.0f, tfb = 0.0f;
  if (VEL) vx = a.tav[0][t], vy = a.tav[1][t], vz = a.tav[2][t];
  if (AV) th = a.tav[3][t], tcs = a.tav[4][t], trho = a.tav[5][t];
  if (BALSARA) tfb = a.tfb[t];
  float tih4 = ih * ih;
  tih4 = tih4 * tih4;
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  float vax = 0.0f, vay = 0.0f, vaz = 0.0f;
  float dv = 0.0f, cvx = 0.0f, cvy = 0.0f, cvz = 0.0f;
  float du = 0.0f;
  float phi = 0.0f, gx = 0.0f, gy = 0.0f, gz = 0.0f;
  int nd = 0;

  const size_t row = (size_t)g * a.s_w;
  const int n = min(a.nv[g], a.s_w);
  for (int base = 0; base < n; base += PSPH_TILE) {
    const int cnt = min(PSPH_TILE, n - base);
    for (int j = i; j < cnt; j += blockDim.x) {
#pragma unroll
      for (int k = 0; k < NROWS; ++k) c[k][j] = a.s[k][row + base + j];
    }
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const float dxx = x - c[R_X][j];
      const float dxy = y - c[R_Y][j];
      const float dxz = z - c[R_Z][j];
      const float r2 = dxx * dxx + dxy * dxy + dxz * dxz;
      const float m = c[R_M][j];
      const float jh = c[R_IH][j];
      const float inv_r = rsqrtf(fmaxf(r2, 1e-30f));
      const float r = r2 * inv_r;
      float jh4 = jh * jh;
      jh4 = jh4 * jh4;
      const float q = r * ih;
      const float qj = r * jh;
      const float gw_i = gw_from<SIGN_BUG>(q, ih, tih4, inv_r);
      const float gw_j = gw_from<SIGN_BUG>(qj, jh, jh4, inv_r);
      float coef;
      if (MODE == MODE_GRADH)
        coef = m * (tcv * gw_i + c[R_CC][j] * gw_j);
      else if (MODE == MODE_ASYM)
        coef = m * c[R_CC][j] * (0.5f * (gw_i + gw_j));
      else
        coef = m * (tcv + c[R_CC][j]) * (0.5f * (gw_i + gw_j));
      ax += dxx * coef;
      ay += dxy * coef;
      az += dxz * coef;
      float dvx = 0.0f, dvy = 0.0f, dvz = 0.0f, vdotr = 0.0f, cav = 0.0f;
      if (VEL) {
        dvx = vx - c[R_VX][j];
        dvy = vy - c[R_VY][j];
        dvz = vz - c[R_VZ][j];
        vdotr = dvx * dxx + dvy * dxy + dvz * dxz;
      }
      if (AV) {
        const float hbar = 0.5f * (th + c[R_H][j]);
        const float mu = hbar * vdotr / (r2 + 0.01f * hbar * hbar);
        const float cbar = 0.5f * (tcs + c[R_CS][j]);
        const float rhobar = 0.5f * (trho + c[R_RHO][j]);
        float pi_ij = 0.0f;
        if (vdotr < 0.0f)
          pi_ij = (-a.av_alpha * cbar * mu + a.av_beta * mu * mu) / rhobar;
        if (BALSARA) pi_ij = pi_ij * (0.5f * (tfb + c[R_FB][j]));
        // the viscosity always takes the correct derivative
        const float gs_av =
            SIGN_BUG ? 0.5f * (gw_from<false>(q, ih, tih4, inv_r) +
                               gw_from<false>(qj, jh, jh4, inv_r))
                     : 0.5f * (gw_i + gw_j);
        cav = m * pi_ij * gs_av;
        vax += dxx * cav;
        vay += dxy * cav;
        vaz += dxz * cav;
        if (BALSARA) {
          const float g_dc = m * gs_av;
          dv += g_dc * vdotr;
          cvx += g_dc * (dvy * dxz - dvz * dxy);
          cvy += g_dc * (dvz * dxx - dvx * dxz);
          cvz += g_dc * (dvx * dxy - dvy * dxx);
        }
      }
      if (ENERGY) {
        // conjugate energy equation on the same pair quantities: the
        // pressure work, and half the viscous dissipation
        float du_p = MODE == MODE_GRADH ? tcv * (m * gw_i) * vdotr
                                        : 0.5f * coef * vdotr;
        if (AV) du_p = du_p + 0.5f * cav * vdotr;
        du += du_p;
      }
      if (GRAV != GRAV_NONE) {
        psph_dyer_ip(m, dxx, dxy, dxz, r2, inv_r,
                     RECV ? ih : fminf(ih, jh), phi, gx, gy, gz);
        nd += (m > 0.0f) ? 1 : 0;
      }
    }
    __syncthreads();
  }

  // residual-P2P window into the same gravity sums
  if (GRAV == GRAV_MERGED)
    psph_p2p_window<RECV>(a.p[0], a.p[1], a.p[2], a.p[3], a.p[4],
                          (size_t)g * a.s2, min(a.nv2[g], a.s2), x, y, z,
                          ih, c, phi, gx, gy, gz, nd);

  a.gp[0][t] = ax;
  a.gp[1][t] = ay;
  a.gp[2][t] = az;
  if (AV) {
    a.av[0][t] = vax;
    a.av[1][t] = vay;
    a.av[2][t] = vaz;
  }
  if (BALSARA) {
    a.dc[0][t] = dv;
    a.dc[1][t] = cvx;
    a.dc[2][t] = cvy;
    a.dc[3][t] = cvz;
  }
  if (ENERGY) a.du[t] = du;
  if (GRAV != GRAV_NONE) {
    a.grav[0][t] = a.g_const * phi;
    a.grav[1][t] = a.g_const * gx;
    a.grav[2][t] = a.g_const * gy;
    a.grav[3][t] = a.g_const * gz;
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
          <<<g, a.b, 0, st>>>(a);
      return;
    }
  }
  pass2_kernel<MODE, SB, AV, BAL, GRAV, RECV, false><<<g, a.b, 0, st>>>(a);
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
                 b, s, s2, av_alpha, av_beta, g_const};
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
