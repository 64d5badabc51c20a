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
// only), and the pair math in f32 or in bf16 (grav_pair_dtype="bfloat16",
// :866-891 and :904-913: the near tier's pair polynomial and each moment
// entry's monopole in bf16, the quadrupole terms in f32 on the f32
// separations, the sums f32; common.cuh gives the rounding points).
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
// m = 0. What held the second design's near tier back: it staged each
// tile of the P2P window synchronously (two barriers a tile, no copy in
// flight), visited every slot below nv, dead ones included, with five
// scalar shared loads a pair, and branched on x < 1 inside a warp; in
// bf16 it filled both lanes of every packed operation with one pair, and
// the monopoles of the moment tiers did the same with one entry. This
// design (common.cuh):
// - b targets x ns slot slices (psph_slices: 64 x 4 = 256 threads a
//   group; a group of more than 256 targets takes one block of 256 per
//   256 targets, psph_share); thread t serves target t % b and slice
//   t / b, and slice k visits the entries k, k + ns, ... of every
//   compacted tile, in every tier;
// - tiles of PSPH_TILE entries are copied asynchronously (psph_window:
//   cp.async, 16 bytes a copy where the rows allow), the copy of tile
//   t + 1 in flight while tile t is swept, the near tier's P2P window
//   too;
// - each staged tile is compacted to what it evaluates: far entries with
//   accept > 0.5 and m > 0, ring and blk slots below nv with m > 0
//   (psph_compact_if), exactly the entries the reference's live mask
//   keeps; near-tier slots with p2p.cu's predicate (psph_compact_where):
//   m != 0, a dead slot whose x, y, z or ih is not finite (the plain
//   version forms NaN there) and every slot in a block one of whose
//   targets has a non-finite column, n_direct the compaction's count of
//   m > 0. An entry's fields go to three float4s (one for monopoles), a
//   near slot to a float4 (x, y, z, m) and, under min-h softening, a
//   float ih, so an evaluation takes wide broadcast loads and no test;
//   n_approx is the number kept, the same in every thread;
// - the near tier's f32 pairs through psph_p2p_pair (the Dyer-Ip
//   branches selected: a NaN x takes the outer one, the self pair's
//   1/r from max(r2, 1e-30f) keeps a NaN r2), one pair an iteration (the
//   loop unrolled by 2 or 4 was 2-6 % slower in turns on the H100, and a
//   warp vote before the inner polynomial slower still);
// - BF16: a slice's near slots, and its ring, blk and far entries, two a
//   bf16x2 lane pair (k and k + ns, then k + 2 ns and k + 3 ns, ...): the
//   near tier on psph_dyer_ip_bf2, the monopoles' m, 1/r, dx, dy and dz
//   packed and ((m 1/r) 1/r) 1/r three packed products; the f32 geometry
//   and quadrupole per entry; lane 0 added before lane 1, in slot order;
//   under receiver softening 1/a and its cube rounded once a thread;
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
  int vec_p2p, vec_ring, vec_blk, vec_far; // psph_stage may copy 16 bytes
  float g_const;
};

// An entry's traceless quadrupole terms for separation d, added into acc
// (phi, gx, gy, gz) and `radial` (g's factor along d): e[1] = (Qxx, Qxy,
// Qxz, Qyy), e[2] = (Qyz, Qzz, -, -); phi -= (d.Q.d)/(2 r^5), g +=
// d (5/2)(d.Q.d)/r^7 - (Q d)/r^5, each added with a multiply-add.
__device__ __forceinline__ void quad_terms(float4 (*e)[PSPH_TILE], int j,
                                           float dxx, float dxy, float dxz,
                                           float ir2, float ir3,
                                           float& radial, float (&acc)[4]) {
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

// One moment entry's terms for target (x, y, z) in f32, added into acc
// (phi, gx, gy, gz): e[0] = (m, cmx, cmy, cmz), then for NM = 10 the
// quadrupole (quad_terms). phi -= m/r, g += d m/r^3, each added with a
// multiply-add.
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
  const float inv_r = psph_rsqrt_ftz(psph_max(r2, 1e-30f));
  const float ir2 = inv_r * inv_r;
  const float ir3 = ir2 * inv_r;
  float radial = m * ir3;
  acc[0] = fmaf(-m, inv_r, acc[0]);
  if constexpr (NM == 10)
    quad_terms(e, j, dxx, dxy, dxz, ir2, ir3, radial, acc);
  acc[1] = fmaf(dxx, radial, acc[1]);
  acc[2] = fmaf(dxy, radial, acc[2]);
  acc[3] = fmaf(dxz, radial, acc[3]);
}

// Two moment entries ja and jb (lanes 0 and 1) for target (x, y, z) with
// the monopole in bf16: m, 1/r, dx, dy and dz packed two entries a
// bf16x2 word, mag = ((m (1/r)) (1/r)) (1/r) three packed products, phi
// -= m (1/r) and g += d mag as exact products of the bf16 factors; r2
// rounded as the plain version's separate operations round it. The
// quadrupole stays f32, on each entry's f32 separations. Entry ja's terms
// are added first, then jb's where `two` (otherwise jb repeats ja and adds
// nothing), so the sums follow the slot order.
template <int NM>
__device__ __forceinline__ void mono_quad_bf2(float4 (*e)[PSPH_TILE], int ja,
                                              int jb, bool two, float x,
                                              float y, float z,
                                              float (&acc)[4]) {
  const float4 pa = e[0][ja], pb = e[0][jb];
  const float d[2][3] = {{x - pa.y, y - pa.z, z - pa.w},
                         {x - pb.y, y - pb.z, z - pb.w}};
  float ir[2];
#pragma unroll
  for (int u = 0; u < 2; ++u)
    ir[u] = psph_rsqrt_ftz(
        psph_max(psph_r2_rn(d[u][0], d[u][1], d[u][2]), 1e-30f));
  const unsigned mb = psph_bf2(pa.x, pb.x), irb = psph_bf2(ir[0], ir[1]);
  const unsigned mag = psph_bmul(psph_bmul(mb, irb), irb);
  const unsigned mag3 = psph_bmul(mag, irb);
  const unsigned bx = psph_bf2(d[0][0], d[1][0]);
  const unsigned by = psph_bf2(d[0][1], d[1][1]);
  const unsigned bz = psph_bf2(d[0][2], d[1][2]);
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (u == 1 && !two) break;
    const float mg = psph_lane(mag3, u);
    acc[0] = fmaf(-psph_lane(mb, u), psph_lane(irb, u), acc[0]);
    acc[1] = fmaf(psph_lane(bx, u), mg, acc[1]);
    acc[2] = fmaf(psph_lane(by, u), mg, acc[2]);
    acc[3] = fmaf(psph_lane(bz, u), mg, acc[3]);
    if constexpr (NM == 10) {
      const float ir2 = ir[u] * ir[u];
      float radial = 0.0f;
      quad_terms(e, u ? jb : ja, d[u][0], d[u][1], d[u][2], ir2,
                 ir2 * ir[u], radial, acc);
      acc[1] = fmaf(d[u][0], radial, acc[1]);
      acc[2] = fmaf(d[u][1], radial, acc[2]);
      acc[3] = fmaf(d[u][2], radial, acc[3]);
    }
  }
}

// One moment tier: the first n entries of NR staged rows starting at
// `row`, of which the last NM hold the moment fields (far: the accept row
// first). Each tile is compacted to the entries for which live(st, j)
// holds, and the thread's slice of them is evaluated (BF16: the slice's
// entries two a lane pair, k and k + ns, then k + 2 ns and k + 3 ns, ...).
// Adds the number kept to na. Every thread of the block calls it.
template <int NM, bool BF16, int NR, typename Live>
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
    if constexpr (BF16) {
#pragma unroll 1
      for (int j = k; j < kept; j += 2 * ns) {
        const bool two = j + ns < kept;
        mono_quad_bf2<NM>(e, j, two ? j + ns : j, two, x, y, z, acc);
      }
    } else {
#pragma unroll 1
      for (int j = k; j < kept; j += ns) mono_quad<NM>(e, j, x, y, z, acc);
    }
  });
}

// The near tier: the first n slots of the P2P rows (x, y, z, [ih,] m;
// RECV: the ih row is not read) from `row`, Dyer-Ip softened with 1/a =
// ih (RECV) or min(ih, ih_j), NaN when either is. Staged with psph_window
// into raw, each tile compacted (psph_compact_where, p2p.cu's predicate)
// to the slots with m != 0, the dead ones of which x, y, z or ih is not
// finite, and every slot where `keep_all` (a target of the block has a
// non-finite column); a slot goes to pos (x, y, z, m) and, under min-h
// softening, cih. Adds the count of slots with m > 0 to nd (the same in
// every thread). f32: every pair through psph_p2p_pair; BF16: the slice's
// slots two a lane pair (k and k + ns, then k + 2 ns and k + 3 ns, ...)
// through psph_dyer_ip_bf2, lane 0 added before lane 1. Every thread of
// the block calls it.
template <bool RECV, bool BF16>
__device__ __forceinline__ void near_tier(
    const Rows& p2p, size_t row, int n, bool vec, float* raw_base,
    float4* pos, float* cih, int* wtab, float x, float y, float z,
    float ih, bool keep_all, int k, int ns, float (&acc)[4], int& nd) {
  constexpr int NR = RECV ? 4 : 5;
  // x, y, z, [ih,] m: under receiver softening the m row stands in for ih
  const float* const all[5] = {p2p.f[0], p2p.f[1], p2p.f[2],
                               RECV ? p2p.f[4] : p2p.f[3], p2p.f[4]};
  const float* const (&rows)[NR] =
      *reinterpret_cast<const float* const(*)[NR]>(&all);
  auto raw = reinterpret_cast<float (*)[NR][PSPH_TILE]>(raw_base);
  // receiver softening: 1/a and its cube in bf16 once, not for every slot
  const unsigned ia_t = BF16 && RECV ? psph_bf2(ih, ih) : 0u;
  const unsigned ia3_t = BF16 && RECV ? psph_bcube(ia_t) : 0u;
  psph_window<NR>(rows, row, n, vec, raw,
                  [&](float (*st)[PSPH_TILE], int c) {
    bool tile_bad;
    const int kept = psph_compact_where(
        st[NR - 1], c, wtab, nd, tile_bad,
        [&](int j, float m) {
          const float v[4] = {st[0][j], st[1][j], st[2][j],
                              RECV ? 0.0f : st[3][j]};
          return m != 0.0f || keep_all || !psph_all_finite(v);
        },
        [&](int j, int at) {
          pos[at] = make_float4(st[0][j], st[1][j], st[2][j], st[NR - 1][j]);
          if (!RECV) cih[at] = st[3][j];
          return false;
        });
    if constexpr (BF16) {
#pragma unroll 1
      for (int j = k; j < kept; j += 2 * ns) {
        const bool two = j + ns < kept;
        const int jb = two ? j + ns : j;
        const float ia[2] = {RECV ? ih : psph_min(ih, cih[j]),
                             RECV ? ih : psph_min(ih, cih[jb])};
        const float4 pa = pos[j], pb = pos[jb];
        const PsphBfPair q[2] = {psph_bf_geometry(x, y, z, pa, ia[0]),
                                 psph_bf_geometry(x, y, z, pb, ia[1])};
        const unsigned in = (q[0].x < 1.0f ? 0xffffu : 0u) |
                            (q[1].x < 1.0f ? 0xffff0000u : 0u);
        const unsigned iab = RECV ? ia_t : psph_bf2(ia[0], ia[1]);
        unsigned mag, p;
        psph_dyer_ip_bf2(psph_bf2(pa.w, pb.w), psph_bf2(q[0].x, q[1].x),
                         iab, RECV ? ia3_t : psph_bcube(iab),
                         psph_bf2(q[0].ir, q[1].ir), in, mag, p);
        const unsigned bx = psph_bf2(q[0].dx, q[1].dx);
        const unsigned by = psph_bf2(q[0].dy, q[1].dy);
        const unsigned bz = psph_bf2(q[0].dz, q[1].dz);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (u == 1 && !two) break;
          const float mg = psph_lane(mag, u);
          acc[0] -= psph_lane(p, u);
          acc[1] = fmaf(psph_lane(bx, u), mg, acc[1]);
          acc[2] = fmaf(psph_lane(by, u), mg, acc[2]);
          acc[3] = fmaf(psph_lane(bz, u), mg, acc[3]);
        }
      }
    } else {
#pragma unroll 1
      for (int j = k; j < kept; j += ns) {
        const float4 p = pos[j];
        const float dxx = x - p.x, dxy = y - p.y, dxz = z - p.z;
        psph_p2p_pair(p.w, dxx, dxy, dxz, dxx * dxx + dxy * dxy + dxz * dxz,
                      RECV ? ih : psph_min(ih, cih[j]), acc);
      }
    }
  });
}

// HAS_P2P: 0 no near tier, 1 min-h softening, 2 receiver softening;
// NM: 4 (monopoles) or 10 (+ traceless quadrupoles) moment fields; BF16:
// the pair math in bf16
template <int HAS_P2P, int NM, bool BF16>
__global__ void __launch_bounds__(PSPH_WIN_THREADS, 4)
    gravity_fused_kernel(const GravArgs a) {
  constexpr int NQ = NM == 10 ? 3 : 1;       // float4s an entry
  __shared__ __align__(16) float raw[2][NM + 1][PSPH_TILE];
  __shared__ __align__(16) float4 e[NQ][PSPH_TILE];
  __shared__ float cih[HAS_P2P == 1 ? PSPH_TILE : 1];
  __shared__ int wtab[64];
  const int g = blockIdx.x;
  const PsphShare my = psph_share(a.b);
  const size_t t = my.t;
  const float x = a.tx[t], y = a.ty[t], z = a.tz[t];
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};    // phi, gx, gy, gz
  int nd = 0;
  int na = 0;

  // near tier: P2P over the sub-block window
  if constexpr (HAS_P2P != 0) {
    const float ih = a.tih[t];
    const float own[4] = {x, y, z, ih};
    // some target of the block has a non-finite column: keep every slot
    const bool keep_all =
        __syncthreads_or(my.on && !psph_all_finite(own)) != 0;
    near_tier<HAS_P2P == 2, BF16>(
        a.p2p, (size_t)g * a.sp, min(a.nv_p2p[g], a.sp), a.vec_p2p != 0,
        &raw[0][0][0], e[0], cih, wtab, x, y, z, ih, keep_all, my.from,
        a.ns, acc, nd);
  }

  // ring tier, then the blk tier (the same test for every thread of the
  // grid): windowed moments, slots below nv with m > 0
  const auto m_pos = [](float (*st)[PSPH_TILE], int j) {
    return st[0][j] > 0.0f;
  };
  auto wraw = reinterpret_cast<float (*)[NM][PSPH_TILE]>(&raw[0][0][0]);
  moment_tier<NM, BF16, NM>(a.ring.first<NM>(), (size_t)g * a.sr,
                            min(a.nv_ring[g], a.sr), a.vec_ring != 0, wraw,
                            e, wtab, x, y, z, my.from, a.ns, acc, na,
                            m_pos);
  if (a.nv_blk != nullptr)
    moment_tier<NM, BF16, NM>(a.blk.first<NM>(), (size_t)g * a.sb,
                              min(a.nv_blk[g], a.sb), a.vec_blk != 0, wraw,
                              e, wtab, x, y, z, my.from, a.ns, acc, na,
                              m_pos);

  // far tier: the shared block (or supergroup) moments under the group's
  // frozen mask, staged beside the mask
  const Rows far = a.far.after(a.accept + (size_t)g * a.nbpad);
  moment_tier<NM, BF16, NM + 1>(far.first<NM + 1>(), 0, a.nbpad,
                                a.vec_far != 0, raw, e, wtab, x, y, z,
                                my.from, a.ns, acc, na,
                                [](float (*st)[PSPH_TILE], int j) {
                                  return st[0][j] > 0.5f && st[1][j] > 0.0f;
                                });

  psph_combine(acc, &raw[0][0][0], my.bt, a.ns);
  if (my.k != 0 || !my.on) return;
  a.phi[t] = a.g_const * acc[0];
  a.gx[t] = a.g_const * acc[1];
  a.gy[t] = a.g_const * acc[2];
  a.gz[t] = a.g_const * acc[3];
  a.nd[t] = nd;
  a.na[t] = na;
}

// Launch the instance of near tier P, BF16 and the nm moment fields
template <int P, bool BF16>
static void launch_nm(const GravArgs& a, int g, int nm, cudaStream_t st) {
  const dim3 grid = psph_grid(g, a.b);
  const int threads = psph_block(a.b, a.ns);
  if (nm == 10)
    gravity_fused_kernel<P, 10, BF16><<<grid, threads, 0, st>>>(a);
  else
    gravity_fused_kernel<P, 4, BF16><<<grid, threads, 0, st>>>(a);
}

// ... of near tier p (0 none, 1 min-h, 2 receiver softening)
template <bool BF16>
static void launch_near(const GravArgs& a, int g, int nm, int p,
                        cudaStream_t st) {
  if (p == 0) launch_nm<0, BF16>(a, g, nm, st);
  else if (p == 1) launch_nm<1, BF16>(a, g, nm, st);
  else launch_nm<2, BF16>(a, g, nm, st);
}

// The P2P rows and nv_p2p are null when has_p2p == 0, pih also under
// receiver_soft; the blk rows and nv_blk are null without the supergroup
// tier; ring, blk and far rows 4..9 are null when nm == 4. bf16 != 0: the
// pair math in bfloat16.
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
    int receiver_soft, int bf16, float g_const, void* stream) {
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
                b, sp, sr, sb, nbpad, ns, 0, 0, 0, 0, g_const};
  a.vec_p2p = has_p2p && psph_vec_rows(a.p2p.f, 5, sp) ? 1 : 0;
  a.vec_ring = psph_vec_rows(a.ring.f, nm, sr) ? 1 : 0;
  a.vec_blk = nv_blk != nullptr && psph_vec_rows(a.blk.f, nm, sb) ? 1 : 0;
  a.vec_far = psph_vec_rows(a.far.f, nm, nbpad) &&
                      psph_vec_rows(&accept, 1, nbpad) ? 1 : 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (g > 0) {
    const int p = !has_p2p ? 0 : (!receiver_soft ? 1 : 2);
    if (bf16) launch_near<true>(a, g, nm, p, st);
    else launch_near<false>(a, g, nm, p, st);
  }
  return (int)cudaGetLastError();
}
