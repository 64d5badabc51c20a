// Near-field gravity over the P2P sub-block window (Dyer-Ip softened).
//
// Replaces: planetmodel_sph_tpu/ops/pallas/groups2.py p2p (:797), body
// _p2p_kernel (:711), its f32 branch.
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
// back (psph_p2p_window, which gravity_fused's near tier and pass 2's
// merged window still take): one block of 64 threads per group, each
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
//   warp diverges; a NaN x selects the outer branch, as the plain
//   version's torch.where does. The self pair keeps rsqrtf(max(r2,
//   1e-30f)), with psph_max, which keeps a NaN r2 as torch.clamp does,
//   and min-h softening psph_min (NaN when either ih is);
// - P2P_TPT = 2 targets a thread (targets i and i + b / 2, which share
//   each slot's shared loads) and 8 slot slices: 32 x 8 = 256 threads a
//   group of 64; the slices' sums are added in slice order at the end,
//   with no atomics, so the result is the same on every run.
#include "common.cuh"

// targets a thread: two share each slot's shared loads (faster in turns
// than one on the H100 at sym100k's and sg100k's windows, min-h and
// receiver softening)
#define P2P_TPT 2

// One pair's Dyer-Ip term added into acc (phi, gx, gy, gz): the plain
// version's expressions, the outer branch's (x >= 1, or NaN) first, then
// the inner one's, its polynomials as multiply-adds, selected into them
// where x < 1. The same selection written as one select between the two
// finished terms was slower on the H100, and so were a branch on x < 1
// and a warp vote before it.
__device__ __forceinline__ void p2p_pair(float m, float dxx, float dxy,
                                         float dxz, float inv_a,
                                         float (&acc)[4]) {
  const float r2 = dxx * dxx + dxy * dxy + dxz * dxz;
  const float inv_r = rsqrtf(psph_max(r2, 1e-30f));
  const float x = (r2 * inv_r) * inv_a;
  const float mr = m * inv_r;
  const bool in = x < 1.0f;
  // x >= 1: m/r^3, m/r
  float mag = mr * inv_r * inv_r;
  float p = mr;
  // x < 1: (m/a^3)(8 - 9 x + 2 x^3), (m/a)(2.4 - 4 x^2 + 3 x^3 - 0.4 x^5)
  const float x2 = x * x;
  const float inv_a3 = inv_a * inv_a * inv_a;
  mag = in ? (m * inv_a3) * fmaf(fmaf(2.0f, x2, -9.0f), x, 8.0f) : mag;
  p = in ? (m * inv_a) * fmaf(x2, fmaf(x, fmaf(-0.4f, x2, 3.0f), -4.0f),
                              2.4f)
         : p;
  acc[0] -= p;
  acc[1] = fmaf(dxx, mag, acc[1]);
  acc[2] = fmaf(dxy, mag, acc[2]);
  acc[3] = fmaf(dxz, mag, acc[3]);
}

template <bool RECV>
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
  const int bt = b / P2P_TPT;            // threads of one slice
  const int i0 = threadIdx.x % bt, k = threadIdx.x / bt;
  float x[P2P_TPT], y[P2P_TPT], z[P2P_TPT], ih[P2P_TPT];
  bool target_bad = false;
#pragma unroll
  for (int u = 0; u < P2P_TPT; ++u) {
    const size_t t = (size_t)g * b + i0 + u * bt;
    x[u] = tx[t];
    y[u] = ty[t];
    z[u] = tz[t];
    ih[u] = tih[t];
    const float own[4] = {x[u], y[u], z[u], ih[u]};
    target_bad = target_bad || !psph_all_finite(own);
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
          pos[at] = make_float4(st[0][j], st[1][j], st[2][j], st[NR - 1][j]);
          if (!RECV) cih[at] = st[3][j];
          return false;
        });
#pragma unroll 2
    for (int j = k; j < kept; j += ns) {
      const float4 p = pos[j];
      const float jh = RECV ? 0.0f : cih[j];
#pragma unroll
      for (int u = 0; u < P2P_TPT; ++u)
        p2p_pair(p.w, x[u] - p.x, y[u] - p.y, z[u] - p.z,
                 RECV ? ih[u] : psph_min(ih[u], jh), acc[u]);
    }
  });
#pragma unroll
  for (int u = 0; u < P2P_TPT; ++u) {
    psph_combine(acc[u], &raw[0][0][0], bt, ns);
    if (k == 0) {
      const size_t t = (size_t)g * b + i0 + u * bt;
      phi_out[t] = g_const * acc[u][0];
      gx_out[t] = g_const * acc[u][1];
      gy_out[t] = g_const * acc[u][2];
      gz_out[t] = g_const * acc[u][3];
      nd_out[t] = npos;
    }
  }
}

// sih is null under receiver softening (receiver_soft != 0)
extern "C" int psph_p2p(
    const float* tx, const float* ty, const float* tz, const float* tih,
    const float* sx, const float* sy, const float* sz, const float* sih,
    const float* sm, const int* nv, float* phi, float* gx, float* gy,
    float* gz, int* nd, int g, int b, int s, int receiver_soft,
    float g_const, void* stream) {
  // P2P_TPT targets a thread: slices of b / P2P_TPT threads, as many as
  // fit PSPH_WIN_THREADS up to PSPH_SLICES * P2P_TPT
  const int bt = b % P2P_TPT == 0 ? b / P2P_TPT : 0;
  int ns = psph_slices(bt) == 0 ? 0 : PSPH_SLICES * P2P_TPT;
  while (ns > 1 && bt * ns > PSPH_WIN_THREADS) ns >>= 1;
  if (g > 0 && ns == 0) return (int)cudaErrorInvalidValue;
  const float* rows[5] = {sx, sy, sz, sih, sm};
  const int vec = psph_vec_rows(rows, 5, s) ? 1 : 0;
  if (g > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    if (receiver_soft)
      p2p_kernel<true><<<g, bt * ns, 0, st>>>(
          tx, ty, tz, tih, sx, sy, sz, sih, sm, nv, phi, gx, gy, gz, nd, b,
          s, ns, vec, g_const);
    else
      p2p_kernel<false><<<g, bt * ns, 0, st>>>(
          tx, ty, tz, tih, sx, sy, sz, sih, sm, nv, phi, gx, gy, gz, nd, b,
          s, ns, vec, g_const);
  }
  return (int)cudaGetLastError();
}
