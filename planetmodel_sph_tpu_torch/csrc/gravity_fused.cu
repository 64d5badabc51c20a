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
// Bound on the H100: f32 operations. Per group the [NBpad] accept row
// (10 KB at 100k) is read once and every accepted live far entry costs
// about 64 f32 operations per target (23 monopole, 41 quadrupole); the
// far moment rows (nm x NBpad floats) are shared by all groups and stay
// in L2. What held the first design back: one block of 64 threads per
// group, each thread walking the whole ring and far scan alone (two warps
// a block; at parity3k's 55 groups 77 of the 132 SMs idle); ten scalar
// shared loads an evaluation; and every staged entry tested inside the
// loop, where about a third of the far entries are not accepted or carry
// m = 0. This design (common.cuh):
// - b targets x ns slot slices (psph_slices: 64 x 4 = 256 threads a
//   group); thread t serves target t % b and slice t / b, and slice k
//   visits the entries k, k + ns, ... of every compacted tile; the near
//   tier's window is split the same way (psph_p2p_window's slice);
// - tiles of PSPH_TILE entries are copied asynchronously (psph_window:
//   cp.async, 16 bytes a copy where the rows allow), the copy of tile
//   t + 1 in flight while tile t is swept;
// - each staged tile is compacted to its live entries before the sweep
//   (psph_compact_if): far entries with accept > 0.5 and m > 0, ring and
//   blk slots below nv with m > 0, exactly the entries the reference's
//   live mask keeps. An entry's fields go to three float4s (one for
//   monopoles), so an evaluation takes wide broadcast loads and no test;
//   n_approx is the number kept, the same in every thread;
// - the slices' sums are added in slice order at the end (psph_combine),
//   with no atomics, so a second launch gives the same bits.
// Entries that are not kept add exactly 0 in the reference: its live mask
// multiplies the quadrupole powers first, so that an entry at r ~ 0 cannot
// produce inf * 0; a compacted entry is live, so the rule holds here
// without a multiply.
#include "common.cuh"

struct Rows {
  const float* f[11];

  // the first N row pointers, as the staging takes them
  template <int N>
  __device__ __forceinline__ const float* const (&first() const)[N] {
    return *reinterpret_cast<const float* const(*)[N]>(f);
  }
  // these rows after the row `r`
  __device__ __forceinline__ Rows after(const float* r) const {
    Rows out;
    out.f[0] = r;
    for (int k = 0; k < 10; ++k) out.f[k + 1] = f[k];
    return out;
  }
};

struct GravArgs {
  const float *tx, *ty, *tz, *tih;
  Rows p2p, ring, blk, far;
  const int *nv_p2p, *nv_ring, *nv_blk;   // nv_blk null without the blk tier
  const float* accept;
  float *phi, *gx, *gy, *gz;
  int *nd, *na;
  int b, sp, sr, sb, nbpad, ns;
  int vec_ring, vec_blk, vec_far;          // psph_stage may copy 16 bytes
  float g_const;
};

// One moment entry's terms for target (x, y, z), added into acc (phi, gx,
// gy, gz): e[0] = (m, cmx, cmy, cmz), then for NM = 10 (Qxx, Qxy, Qxz,
// Qyy) and (Qyz, Qzz, -, -). The terms are the reference's, each added
// with a multiply-add: phi -= m/r + (d.Q.d)/(2 r^5), g += d (m/r^3
// + (5/2)(d.Q.d)/r^7) - (Q d)/r^5.
template <int NM>
__device__ __forceinline__ void mono_quad(float4 (*e)[PSPH_TILE], int j,
                                          float x, float y, float z,
                                          float (&acc)[4]) {
  const float4 p = e[0][j];
  const float m = p.x;
  const float dxx = x - p.y;
  const float dxy = y - p.z;
  const float dxz = z - p.w;
  const float r2 = dxx * dxx + dxy * dxy + dxz * dxz;
  const float inv_r = rsqrtf(psph_max(r2, 1e-30f));
  const float ir2 = inv_r * inv_r;
  const float ir3 = ir2 * inv_r;
  float radial = m * ir3;                  // g's factor along d
  acc[0] = fmaf(-m, inv_r, acc[0]);
  if constexpr (NM == 10) {
    const float4 q0 = e[1][j], q1 = e[2][j];
    const float qxx = q0.x, qxy = q0.y, qxz = q0.z;
    const float qyy = q0.w, qyz = q1.x, qzz = q1.y;
    const float qdx = qxx * dxx + qxy * dxy + qxz * dxz;
    const float qdy = qxy * dxx + qyy * dxy + qyz * dxz;
    const float qdz = qxz * dxx + qyz * dxy + qzz * dxz;
    const float dqd = dxx * qdx + dxy * qdy + dxz * qdz;
    const float ir5 = ir3 * ir2;
    const float dqd5 = dqd * ir5;
    acc[0] = fmaf(-0.5f, dqd5, acc[0]);
    radial = fmaf(2.5f, dqd5 * ir2, radial);
    acc[1] = fmaf(-qdx, ir5, acc[1]);
    acc[2] = fmaf(-qdy, ir5, acc[2]);
    acc[3] = fmaf(-qdz, ir5, acc[3]);
  }
  acc[1] = fmaf(dxx, radial, acc[1]);
  acc[2] = fmaf(dxy, radial, acc[2]);
  acc[3] = fmaf(dxz, radial, acc[3]);
}

// One moment tier: the first n entries of NR staged rows starting at
// `row`, of which the last NM hold the moment fields (far: the accept row
// first). Each tile is compacted to the entries for which live(st, j)
// holds, and the thread's slice of them is evaluated. Adds the number
// kept to na. Every thread of the block calls it.
template <int NM, int NR, typename Live>
__device__ __forceinline__ void moment_tier(
    const float* const (&rows)[NR], size_t row, int n, bool vec,
    float (*raw)[NR][PSPH_TILE], float4 (*e)[PSPH_TILE], int* wtab,
    float x, float y, float z, int k, int ns, float (&acc)[4], int& na,
    Live live) {
  constexpr int F = NR - NM;                // the first moment row
  psph_window<NR>(rows, row, n, vec, raw,
                  [&](float (*st)[PSPH_TILE], int c) {
    const int kept = psph_compact_if(c, wtab,
                                     [&](int j) { return live(st, j); },
                                     [&](int j, int at) {
      e[0][at] = make_float4(st[F][j], st[F + 1][j], st[F + 2][j],
                             st[F + 3][j]);
      if constexpr (NM == 10) {
        e[1][at] = make_float4(st[F + 4][j], st[F + 5][j], st[F + 6][j],
                               st[F + 7][j]);
        e[2][at] = make_float4(st[F + 8][j], st[F + 9][j], 0.0f, 0.0f);
      }
    });
    na += kept;
#pragma unroll 1
    for (int j = k; j < kept; j += ns) mono_quad<NM>(e, j, x, y, z, acc);
  });
}

// HAS_P2P: 0 no near tier, 1 min-h softening, 2 receiver softening;
// NM: 4 (monopoles) or 10 (+ traceless quadrupoles) moment fields
template <int HAS_P2P, int NM>
__global__ void __launch_bounds__(PSPH_WIN_THREADS, 4)
    gravity_fused_kernel(const GravArgs a) {
  constexpr int NQ = NM == 10 ? 3 : 1;       // float4s an entry
  __shared__ __align__(16) float raw[2][NM + 1][PSPH_TILE];
  __shared__ __align__(16) float4 e[NQ][PSPH_TILE];
  __shared__ int wtab[32];
  const int g = blockIdx.x;
  const int i = threadIdx.x % a.b, k = threadIdx.x / a.b;
  const size_t t = (size_t)g * a.b + i;
  const float x = a.tx[t], y = a.ty[t], z = a.tz[t];
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};    // phi, gx, gy, gz
  int nd[1] = {0};
  int na = 0;

  // near tier: P2P over the sub-block window
  if (HAS_P2P)
    psph_p2p_window<HAS_P2P == 2>(
        a.p2p.f[0], a.p2p.f[1], a.p2p.f[2], a.p2p.f[3], a.p2p.f[4],
        (size_t)g * a.sp, min(a.nv_p2p[g], a.sp), x, y, z, a.tih[t],
        &raw[0][0], acc[0], acc[1], acc[2], acc[3], nd[0], k, a.ns);

  // ring tier, then the blk tier (the same test for every thread of the
  // grid): windowed moments, slots below nv with m > 0
  const auto m_pos = [](float (*st)[PSPH_TILE], int j) {
    return st[0][j] > 0.0f;
  };
  auto wraw = reinterpret_cast<float (*)[NM][PSPH_TILE]>(&raw[0][0][0]);
  moment_tier<NM, NM>(a.ring.first<NM>(), (size_t)g * a.sr,
                      min(a.nv_ring[g], a.sr), a.vec_ring != 0, wraw, e,
                      wtab, x, y, z, k, a.ns, acc, na, m_pos);
  if (a.nv_blk != nullptr)
    moment_tier<NM, NM>(a.blk.first<NM>(), (size_t)g * a.sb,
                        min(a.nv_blk[g], a.sb), a.vec_blk != 0, wraw, e,
                        wtab, x, y, z, k, a.ns, acc, na, m_pos);

  // far tier: the shared block (or supergroup) moments under the group's
  // frozen mask, staged beside the mask
  const Rows far = a.far.after(a.accept + (size_t)g * a.nbpad);
  moment_tier<NM, NM + 1>(far.first<NM + 1>(), 0, a.nbpad, a.vec_far != 0,
                          raw, e, wtab, x,
                          y, z, k, a.ns, acc, na,
                          [](float (*st)[PSPH_TILE], int j) {
                            return st[0][j] > 0.5f && st[1][j] > 0.0f;
                          });

  psph_combine(acc, &raw[0][0][0], a.b, a.ns);
  psph_combine(nd, reinterpret_cast<int*>(&raw[1][0][0]), a.b, a.ns);
  if (k != 0) return;
  a.phi[t] = a.g_const * acc[0];
  a.gx[t] = a.g_const * acc[1];
  a.gy[t] = a.g_const * acc[2];
  a.gz[t] = a.g_const * acc[3];
  a.nd[t] = nd[0];
  a.na[t] = na;
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
  const int ns = psph_slices(b);
  if (g > 0 && (ns == 0 || (nm != 4 && nm != 10)))
    return (int)cudaErrorInvalidValue;
  GravArgs a = {tx, ty, tz, tih,
                {{px, py, pz, pih, pm, 0, 0, 0, 0, 0}},
                {{r0, r1, r2, r3, r4, r5, r6, r7, r8, r9}},
                {{b0, b1, b2, b3, b4, b5, b6, b7, b8, b9}},
                {{f0, f1, f2, f3, f4, f5, f6, f7, f8, f9}},
                nv_p2p, nv_ring, nv_blk, accept,
                phi, gx, gy, gz, nd, na,
                b, sp, sr, sb, nbpad, ns, 0, 0, 0, g_const};
  a.vec_ring = psph_vec_rows(a.ring.f, nm, sr) ? 1 : 0;
  a.vec_blk = nv_blk != nullptr && psph_vec_rows(a.blk.f, nm, sb) ? 1 : 0;
  a.vec_far = psph_vec_rows(a.far.f, nm, nbpad) &&
                      psph_vec_rows(&accept, 1, nbpad) ? 1 : 0;
  cudaStream_t st = (cudaStream_t)stream;
#define PSPH_GF(P, M) gravity_fused_kernel<P, M><<<g, b * ns, 0, st>>>(a)
  if (g > 0) {
    const int p = !has_p2p ? 0 : (!receiver_soft ? 1 : 2);
    if (nm == 10) {
      if (p == 0) PSPH_GF(0, 10);
      else if (p == 1) PSPH_GF(1, 10);
      else PSPH_GF(2, 10);
    } else {
      if (p == 0) PSPH_GF(0, 4);
      else if (p == 1) PSPH_GF(1, 4);
      else PSPH_GF(2, 4);
    }
  }
#undef PSPH_GF
  return (int)cudaGetLastError();
}
