// Near-field gravity over the P2P sub-block window (Dyer-Ip softened).
//
// Replaces: planetmodel_sph_tpu/ops/pallas/groups2.py p2p (:797), body
// _p2p_kernel (:711), both branches: f32 and bf16 (:747-763,
// grav_pair_dtype="bfloat16").
//
// Per target i of group g, over the first nv[g] source slots j (rows x, y,
// z, ih, m; under receiver softening the ih row is absent):
//   x = r / a,  a = h_i (receiver) or max(h_i, h_j), i.e. 1/a = min(ih)
//   x <  1: phi -= (m/a)(2.4 - 4 x^2 + 3 x^3 - 0.4 x^5),
//           g   += d (m/a^3)(8 - 9 x + 2 x^3)
//   x >= 1: phi -= m/r,  g += d m/r^3
//   nd = #{j : m_j > 0}
// Outputs g_const * (phi, g) and nd. The self pair is included: dx = 0
// gives no force and the finite potential -2.4 m/a, which the caller adds
// back, and it counts in nd.
//
// Bound on the H100: f32 operations, about 35 a live pair against 20 bytes
// a slot shared by the group's 64 targets. What held the first design
// back (a synchronous window sweep, since removed; gravity_fused's near
// tier now follows this design): one block of 64 threads per group, each
// thread walking every slot below nv alone, dead slots included; each
// tile loaded synchronously, five scalar shared loads a pair; and the
// Dyer-Ip branch on x < 1, which diverges inside a warp. This design
// (common.cuh, psph_window):
// - tiles of PSPH_TILE slots are copied asynchronously (cp.async, 16 bytes
//   a copy), the copy of tile t + 1 in flight while tile t is swept;
// - each staged tile is compacted with a ballot per warp to its live
//   slots (m != 0), to the dead ones of which x, y, z or ih is not finite
//   (with m = 0 the plain version still forms d (m/r) r^-2 = inf * 0 =
//   NaN there, and (m/a^3) = 0 * inf for an ih of -inf) and, in a block
//   one of whose targets has a non-finite column, to every slot (each
//   then adds what it adds in the plain version, NaN where it is NaN).
//   A slot goes to a float4 (x, y, z, m) and, under min-h softening, a
//   float ih: one or two shared loads a pair. nd is the compaction's count
//   of m > 0, once per group;
// - both branches of the Dyer-Ip term are formed, the inner one's
//   polynomials as multiply-adds, and the one x takes is selected, so no
//   warp diverges (psph_p2p_pair, common.cuh); a NaN x selects the outer
//   branch, as the plain version's torch.where does. The self pair keeps
//   1/r of max(r2, 1e-30f), with psph_max, which keeps a NaN r2 as
//   torch.clamp does, and min-h softening psph_min (NaN when either ih
//   is);
// - P2P_TPT = 2 targets a thread (targets i and i + ceil(b / 2), which
//   share each slot's shared loads; an odd b leaves the last thread one
//   target, its second masked) and 8 slot slices: 32 x 8 = 256 threads a
//   group of 64; the slices' sums are added in slice order at the end,
//   with no atomics, so the result is the same on every run. A group of
//   more than 512 targets takes one block of 256 threads per 512 targets,
//   each sweeping the whole window for its own.
// BF16 (grav_pair_dtype="bfloat16"): the same staging, compaction and
// slice order; the geometry and the x < 1 test stay f32 per target (r2
// and x rounded as the plain version's separate operations round them,
// psph_bf_geometry), and the thread's two targets' pairs with a slot form
// the two lanes of each packed bf16x2 operation of the pair polynomial
// (psph_dyer_ip_bf2, common.cuh), each lane's branch selected by its own
// x < 1. phi and the three exact products d mag are added into f32 sums.
// What does not change from slot to slot is rounded once: m into both
// lanes when the slot is compacted, and under receiver softening the two
// targets' 1/a and its cube once a thread. What held the first bf16 loop
// back: 7 conversions and the cube of 1/a for every slot, around the
// packed polynomial.
#include "common.cuh"

// targets a thread: two share each slot's shared loads (faster in turns
// than one on the H100 at sym100k's and sg100k's windows, min-h and
// receiver softening)
#define P2P_TPT 2

// Threads of a slot slice for a group of b targets: ceil(b / P2P_TPT),
// at most PSPH_WIN_THREADS (a larger group takes several blocks)
__host__ __device__ __forceinline__ int p2p_slice_threads(int b) {
  const int bt = (b + P2P_TPT - 1) / P2P_TPT;
  return bt < PSPH_WIN_THREADS ? bt : PSPH_WIN_THREADS;
}

template <bool RECV, bool BF16>
__global__ void __launch_bounds__(PSPH_WIN_THREADS) p2p_kernel(
    const float* __restrict__ tx, const float* __restrict__ ty,
    const float* __restrict__ tz, const float* __restrict__ tih,
    const float* __restrict__ sx, const float* __restrict__ sy,
    const float* __restrict__ sz, const float* __restrict__ sih,
    const float* __restrict__ sm, const int* __restrict__ nv,
    float* __restrict__ phi_out, float* __restrict__ gx_out,
    float* __restrict__ gy_out, float* __restrict__ gz_out,
    int* __restrict__ nd_out, int b, int s, int ns, int vec,
    float g_const) {
  constexpr int NR = RECV ? 4 : 5;
  __shared__ __align__(16) float raw[2][NR][PSPH_TILE];
  __shared__ __align__(16) float4 pos[PSPH_TILE];    // x, y, z, m
  __shared__ float cih[RECV ? 1 : PSPH_TILE];
  __shared__ int wtab[64];
  const int g = blockIdx.x;
  // threads of one slice; block y takes the group's targets [y P2P_TPT bt,
  // (y + 1) P2P_TPT bt), thread i0 of a slice targets i0 + u bt of them
  const int bt = p2p_slice_threads(b);
  const int i0 = threadIdx.x % bt, k = threadIdx.x / bt;
  const int first = blockIdx.y * P2P_TPT * bt;
  float x[P2P_TPT], y[P2P_TPT], z[P2P_TPT], ih[P2P_TPT];
  bool on[P2P_TPT];
  bool target_bad = false;
#pragma unroll
  for (int u = 0; u < P2P_TPT; ++u) {
    const int it = first + i0 + u * bt;
    on[u] = it < b;
    // past the group's last target: the block's first, summed unwritten
    const size_t t = (size_t)g * b + (on[u] ? it : first);
    x[u] = tx[t];
    y[u] = ty[t];
    z[u] = tz[t];
    ih[u] = tih[t];
    const float own[4] = {x[u], y[u], z[u], ih[u]};
    target_bad = target_bad || (on[u] && !psph_all_finite(own));
  }
  // some target of the block has a non-finite column: keep every slot
  const bool keep_all = __syncthreads_or(target_bad) != 0;
  const int n = min(nv[g], s);
  // x, y, z, [ih,] m: the ih row is absent under receiver softening
  const float* const all[5] = {sx, sy, sz, RECV ? sm : sih, sm};
  const float* const (&rows)[NR] =
      *reinterpret_cast<const float* const(*)[NR]>(&all);
  float acc[P2P_TPT][4] = {};
  int npos = 0;
  // receiver softening: the two targets' 1/a and its cube in bf16 once,
  // not for every slot
  const unsigned ia_r = BF16 && RECV ? psph_bf2(ih[0], ih[P2P_TPT - 1]) : 0u;
  const unsigned ia3_r = BF16 && RECV ? psph_bcube(ia_r) : 0u;
  psph_window<NR>(rows, (size_t)g * s, n, vec != 0, raw,
                  [&](float (*st)[PSPH_TILE], int c) {
    bool tile_bad;
    const int kept = psph_compact_where(
        st[NR - 1], c, wtab, npos, tile_bad,
        [&](int j, float m) {
          const float v[4] = {st[0][j], st[1][j], st[2][j],
                              RECV ? 0.0f : st[3][j]};
          return m != 0.0f || keep_all || !psph_all_finite(v);
        },
        [&](int j, int at) {
          // BF16: m rounded into both lanes once, as the word's bits
          const float m = st[NR - 1][j];
          pos[at] = make_float4(st[0][j], st[1][j], st[2][j],
                                BF16 ? __uint_as_float(psph_bf2(m, m)) : m);
          if (!RECV) cih[at] = st[3][j];
          return false;
        });
#pragma unroll 2
    for (int j = k; j < kept; j += ns) {
      const float4 p = pos[j];
      const float jh = RECV ? 0.0f : cih[j];
      if constexpr (BF16) {
        static_assert(P2P_TPT == 2, "a bf16x2 lane a target");
        PsphBfPair q[2];
        unsigned in = 0u;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          q[u] = psph_bf_geometry(x[u], y[u], z[u], p,
                                  RECV ? ih[u] : psph_min(ih[u], jh));
          in |= q[u].x < 1.0f ? 0xffffu << (16 * u) : 0u;
        }
        const unsigned iab = RECV ? ia_r
                                  : psph_bf2(psph_min(ih[0], jh),
                                             psph_min(ih[1], jh));
        unsigned mag, ph;
        psph_dyer_ip_bf2(__float_as_uint(p.w), psph_bf2(q[0].x, q[1].x), iab,
                         RECV ? ia3_r : psph_bcube(iab),
                         psph_bf2(q[0].ir, q[1].ir), in, mag, ph);
        const unsigned bx = psph_bf2(q[0].dx, q[1].dx);
        const unsigned by = psph_bf2(q[0].dy, q[1].dy);
        const unsigned bz = psph_bf2(q[0].dz, q[1].dz);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float mg = psph_lane(mag, u);
          acc[u][0] -= psph_lane(ph, u);
          acc[u][1] = fmaf(psph_lane(bx, u), mg, acc[u][1]);
          acc[u][2] = fmaf(psph_lane(by, u), mg, acc[u][2]);
          acc[u][3] = fmaf(psph_lane(bz, u), mg, acc[u][3]);
        }
      } else {
#pragma unroll
        for (int u = 0; u < P2P_TPT; ++u) {
          const float dxx = x[u] - p.x, dxy = y[u] - p.y, dxz = z[u] - p.z;
          psph_p2p_pair(p.w, dxx, dxy, dxz,
                        dxx * dxx + dxy * dxy + dxz * dxz,
                        RECV ? ih[u] : psph_min(ih[u], jh), acc[u]);
        }
      }
    }
  });
#pragma unroll
  for (int u = 0; u < P2P_TPT; ++u) {
    psph_combine(acc[u], &raw[0][0][0], bt, ns);
    if (k == 0 && on[u]) {
      const size_t t = (size_t)g * b + first + i0 + u * bt;
      phi_out[t] = g_const * acc[u][0];
      gx_out[t] = g_const * acc[u][1];
      gy_out[t] = g_const * acc[u][2];
      gz_out[t] = g_const * acc[u][3];
      nd_out[t] = npos;
    }
  }
}

// sih is null under receiver softening (receiver_soft != 0); bf16 != 0:
// the pair polynomial in bfloat16
extern "C" int psph_p2p(
    const float* tx, const float* ty, const float* tz, const float* tih,
    const float* sx, const float* sy, const float* sz, const float* sih,
    const float* sm, const int* nv, float* phi, float* gx, float* gy,
    float* gz, int* nd, int g, int b, int s, int receiver_soft, int bf16,
    float g_const, void* stream) {
  // P2P_TPT targets a thread: slices of p2p_slice_threads(b) threads, as
  // many as fit PSPH_WIN_THREADS up to PSPH_SLICES * P2P_TPT
  if (g > 0 && b < 1) return (int)cudaErrorInvalidValue;
  const int bt = p2p_slice_threads(b);
  int ns = PSPH_SLICES * P2P_TPT;
  while (ns > 1 && bt * ns > PSPH_WIN_THREADS) ns >>= 1;
  const dim3 grid(g, (b + P2P_TPT * bt - 1) / (P2P_TPT * bt));
  const float* rows[5] = {sx, sy, sz, sih, sm};
  const int vec = psph_vec_rows(rows, 5, s) ? 1 : 0;
  cudaStream_t st = (cudaStream_t)stream;
#define PSPH_P2P(R, H)                                                     \
  p2p_kernel<R, H><<<grid, bt * ns, 0, st>>>(tx, ty, tz, tih, sx, sy, sz,  \
                                             sih, sm, nv, phi, gx, gy, gz, \
                                             nd, b, s, ns, vec, g_const)
  if (g > 0) {
    if (receiver_soft) {
      if (bf16) PSPH_P2P(true, true);
      else PSPH_P2P(true, false);
    } else {
      if (bf16) PSPH_P2P(false, true);
      else PSPH_P2P(false, false);
    }
  }
#undef PSPH_P2P
  return (int)cudaGetLastError();
}
