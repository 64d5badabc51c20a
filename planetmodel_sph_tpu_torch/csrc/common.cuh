// Shared definitions of the windowed block-pair kernels.
//
// Layout contract (the same as the reference's Pallas sweeps): targets are
// [G*B] columns in the Morton-sorted padded layout, one group of B targets
// per thread block (or per psph_grid's blocks of a group) and one target
// per thread; sources are [G, S] window
// rows, of which the first nv[g] slots are valid. Padding and duplicate
// source slots carry m = 0, so they add exactly 0 to every sum. The self
// pair is included; callers correct it.
#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

// source slots staged in shared memory per sweep step
#define PSPH_TILE 256

// 1/pi rounded once to float, as the plain versions' scalar is
#define PSPH_INV_PI 0.3183098861837907f

// min(a, b), NaN when either operand is NaN, as torch.minimum and
// jnp.minimum are (fminf returns the other operand)
__device__ __forceinline__ float psph_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// max(a, b), NaN when either operand is NaN, as torch.maximum and
// jnp.maximum are (fmaxf returns the other operand)
__device__ __forceinline__ float psph_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// 1/sqrt(s) for s >= FLT_MIN (no denormal to scale), NaN-keeping: the bare
// approximate instruction, where rsqrtf scales a denormal first
__device__ __forceinline__ float psph_rsqrt_ftz(float s) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(s));
  return r;
}

// Dyer-Ip softened point-mass term, accumulated into (phi, g), branching on
// x < 1 (pass2.cu's merged near window). Finite at r = 0 (x = 0 takes the
// inner branch, dx = 0 kills the force); phi then holds the -2.4 m/a self
// term that the caller removes.
__device__ __forceinline__ void psph_dyer_ip(
    float m, float dxx, float dxy, float dxz, float r2, float inv_r,
    float inv_a, float& phi, float& gx, float& gy, float& gz) {
  const float x = (r2 * inv_r) * inv_a;
  const float x2 = x * x;
  const float x3 = x2 * x;
  float mag, p;
  if (x < 1.0f) {
    const float inv_a3 = inv_a * inv_a * inv_a;
    mag = (m * inv_a3) * (8.0f - 9.0f * x + 2.0f * x3);
    p = -(m * inv_a) * (2.4f - 4.0f * x2 + 3.0f * x3 - 0.4f * x2 * x3);
  } else {
    const float mr = m * inv_r;
    mag = mr * inv_r * inv_r;
    p = -mr;
  }
  phi += p;
  gx += dxx * mag;
  gy += dxy * mag;
  gz += dxz * mag;
}

// One pair's Dyer-Ip term added into acc (phi, gx, gy, gz), r2 = |d|^2:
// the plain versions' expressions, the outer branch's (x >= 1, or NaN)
// first, then the inner one's, its polynomials as multiply-adds, selected
// into them where x < 1. The same selection written as one select between
// the two finished terms was slower on the H100 in p2p, and so were a
// branch on x < 1 and a warp vote before it (the vote in gravity_fused's
// near tier too). p2p.cu and gravity_fused.cu's near tier evaluate every
// pair they keep with it; pairwise_pass1.cu the pairs its q^2 test does
// not skip. 1/r = psph_rsqrt_ftz(max(r2, 1e-30)): max.NaN keeps a NaN r2
// as torch.clamp does, and past the floor no denormal is left for
// rsqrtf's scaling, so the bare instruction gives rsqrtf's bits.
__device__ __forceinline__ void psph_p2p_pair(float m, float dxx, float dxy,
                                              float dxz, float r2,
                                              float inv_a,
                                              float (&acc)[4]) {
  const float inv_r = psph_rsqrt_ftz(psph_max(r2, 1e-30f));
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

// bfloat16 pair math (grav_pair_dtype="bfloat16", the reference's
// bf16 branch of _p2p_kernel and _gravity_fused_kernel): the separations,
// r2, 1/r, x, the x < 1 test and the m > 0 count stay f32, with r2 and x
// rounded after each operation as the plain versions' separate operations
// round them (psph_r2_rn), so that the values rounded to bf16 are the
// plain versions' bit for bit; dx, x, m, 1/a and 1/r are rounded to bf16,
// every bf16 operation rounds its result in the reference's order, the
// last product before each cast back to f32 is exact (a bf16 x bf16
// product fits f32: fmaf(f32(d), f32(mag), acc)) and the sums are f32.
// Two bf16 values share a 32-bit word, lane 0 in the low half as in
// __nv_bfloat162, and every operation takes both (Hopper's packed bf16x2
// rate is twice its f32 rate). Each is written in PTX with its rounding
// mode, .rn, which ptxas never contracts into a multiply-add.

// (lo, hi) rounded to nearest even
__device__ __forceinline__ unsigned psph_bf2(float lo, float hi) {
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
__device__ __forceinline__ unsigned psph_bmul(unsigned a, unsigned b) {
  unsigned r;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ unsigned psph_badd(unsigned a, unsigned b) {
  unsigned r;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ unsigned psph_bsub(unsigned a, unsigned b) {
  unsigned r;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
// lane k of a pair as an f32 (exact)
__device__ __forceinline__ float psph_lane(unsigned v, int k) {
  return __uint_as_float(k ? (v & 0xffff0000u) : (v << 16));
}
// |d|^2 rounded after each multiply and add, in the plain versions' order
__device__ __forceinline__ float psph_r2_rn(float dxx, float dxy,
                                            float dxz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dxx, dxx), __fmul_rn(dxy, dxy)),
                   __fmul_rn(dxz, dxz));
}

// The Dyer-Ip polynomials' constants in bf16, in both lanes: the
// reference's Python constants as JAX rounds them to the bf16 operands
// (8, 9, 2, 4 and 3 exactly, 2.4 -> 2.40625, 0.4 -> 0.400390625)
#define PSPH_BF_8 0x41004100u
#define PSPH_BF_9 0x41104110u
#define PSPH_BF_2 0x40004000u
#define PSPH_BF_4 0x40804080u
#define PSPH_BF_3 0x40404040u
#define PSPH_BF_2P4 0x401A401Au
#define PSPH_BF_0P4 0x3ECD3ECDu

// v^3 in bf16, (v v) v rounded after each product, as the plain versions
// form (1/a)^3
__device__ __forceinline__ unsigned psph_bcube(unsigned v) {
  return psph_bmul(psph_bmul(v, v), v);
}

// The Dyer-Ip term of two pairs in bf16, a pair a lane: m, x, 1/a and 1/r
// rounded to bf16, ia3 = psph_bcube(1/a) (a caller whose 1/a does not
// change from slot to slot forms it once), `in` 0xffff in each lane whose
// f32 x < 1 (false for a NaN x: the outer branch, as torch.where selects
// it). Returns the selected mag and p (phi = -p), rounded bf16:
//   x < 1:  mag = (m (1/a)^3) ((8 - 9 x) + 2 x^3),
//           p = (m (1/a)) (((2.4 - 4 x^2) + 3 x^3) - (0.4 x^2) x^3)
//   x >= 1: mag = ((m (1/r)) (1/r)) (1/r),  p = m (1/r)
// The branches are selected per lane, not branched on; the inner one is
// formed only where some lane of the threads here takes it (a pair that
// does not gets the outer branch from the select either way, so the bits
// are the same): 7-10 % faster in turns on the H100 in p2p's and
// gravity_fused's bf16 instances at 100k than forming both for every
// pair, slower only at parity3k's 55 groups (PERF.md).
__device__ __forceinline__ void psph_dyer_ip_bf2(unsigned m, unsigned x,
                                                 unsigned ia, unsigned ia3,
                                                 unsigned ir, unsigned in,
                                                 unsigned& mag,
                                                 unsigned& p) {
  const unsigned mr = psph_bmul(m, ir);
  const unsigned omag = psph_bmul(psph_bmul(mr, ir), ir);
  mag = omag;
  p = mr;
  if (!__any_sync(__activemask(), in != 0u)) return;
  const unsigned x2 = psph_bmul(x, x);
  const unsigned x3 = psph_bmul(x2, x);
  const unsigned imag = psph_bmul(
      psph_bmul(m, ia3),
      psph_badd(psph_bsub(PSPH_BF_8, psph_bmul(PSPH_BF_9, x)),
                psph_bmul(PSPH_BF_2, x3)));
  const unsigned ip = psph_bmul(
      psph_bmul(m, ia),
      psph_bsub(psph_badd(psph_bsub(PSPH_BF_2P4, psph_bmul(PSPH_BF_4, x2)),
                          psph_bmul(PSPH_BF_3, x3)),
                psph_bmul(psph_bmul(PSPH_BF_0P4, x2), x3)));
  mag = (imag & in) | (omag & ~in);
  p = (ip & in) | (mr & ~in);
}

// The f32 geometry of one bf16 pair, target (x, y, z) and slot p: d, r2
// and x rounded as the plain version's separate operations round them, 1/r
// from max(r2, 1e-30) as in psph_p2p_pair, 1/a given
struct PsphBfPair {
  float dx, dy, dz, x, ir;
};
__device__ __forceinline__ PsphBfPair psph_bf_geometry(float x, float y,
                                                       float z, float4 p,
                                                       float inv_a) {
  PsphBfPair q;
  q.dx = x - p.x;
  q.dy = y - p.y;
  q.dz = z - p.z;
  const float r2 = psph_r2_rn(q.dx, q.dy, q.dz);
  q.ir = psph_rsqrt_ftz(psph_max(r2, 1e-30f));
  q.x = __fmul_rn(__fmul_rn(r2, q.ir), inv_a);
  return q;
}

// Staging of the source windows of the two grad-h sweeps (pass1_gradh.cu,
// pass2.cu): double-buffered asynchronous copies of window tiles into
// shared memory, and the block-wide compaction of the live slots.
//
// A block of these sweeps runs bt = min(b, PSPH_WIN_THREADS) targets times
// ns slot slices (bt * ns <= PSPH_WIN_THREADS threads, psph_share): thread
// t serves target t % bt and slice t / bt, and slice k visits the
// compacted slots k, k + ns, ... of
// every tile. Each thread keeps its slice's sums in registers; the
// slices are added in a fixed order at the end (psph_combine), so the
// same inputs give the same bits on every run.
#define PSPH_WIN_THREADS 256

// Start the asynchronous copy of slots [off, off + cnt) of NR rows into
// dst[r][0, cnt): 16 bytes a copy where `vec` (every row pointer 16-byte
// aligned and the row length a multiple of 4, so every tile start is
// aligned), 4 bytes for the rest. Every thread commits once per call, so
// that a wait counts tiles.
template <int NR>
__device__ __forceinline__ void psph_stage(float (*dst)[PSPH_TILE],
                                           const float* const (&rows)[NR],
                                           size_t off, int cnt, bool vec) {
  const int nt = blockDim.x;
  const int quads = vec ? cnt >> 2 : 0;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    for (int q = threadIdx.x; q < quads; q += nt)
      __pipeline_memcpy_async(&dst[r][q << 2], rows[r] + off + (q << 2),
                              16);
    for (int j = (quads << 2) + threadIdx.x; j < cnt; j += nt)
      __pipeline_memcpy_async(&dst[r][j], rows[r] + off + j, 4);
  }
  __pipeline_commit();
}

// Stable compaction of the staged slots [0, cnt) for which keep(j, m)
// holds, m = mrow[j]: put(j, k) stores slot j at compacted position k, k
// counting the kept slots before j, and returns true when one of the
// slot's staged fields is not finite (or out of a sweep's safe range).
// Returns the number kept, adds the number with m > 0, kept or not, to
// npos (n_direct where keep holds wherever m != 0) and sets
// `bad` when some kept slot reported a non-finite field (a sweep that
// leaves out pairs then visits every pair of the tile: in the plain
// versions a NaN or an infinity times a weight of 0 is NaN), all the same
// in every thread. Every thread of the block calls it; it ends with a
// barrier, after which the compacted slots are visible to the whole
// block. wtab: 64 ints of shared memory.
template <typename Keep, typename Put>
__device__ __forceinline__ int psph_compact_where(const float* mrow, int cnt,
                                                  int* wtab, int& npos,
                                                  bool& bad, Keep keep,
                                                  Put put) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  const int here = blockDim.x - (warp << 5);        // threads of this warp
  const unsigned mask = here >= 32 ? 0xffffffffu : (1u << here) - 1u;
  const unsigned below = (1u << lane) - 1u;
  int kept = 0;
  bool any_bad = false;
  for (int base = 0; base < cnt; base += blockDim.x) {
    const int j = base + tid;
    const float m = j < cnt ? mrow[j] : 0.0f;
    const bool take = j < cnt && keep(j, m);
    const unsigned live = __ballot_sync(mask, take);
    const unsigned pos = __ballot_sync(mask, m > 0.0f);
    if (lane == 0) {
      wtab[warp] = __popc(live);
      wtab[32 + warp] = __popc(pos);
    }
    __syncthreads();
    int at = kept + __popc(live & below), all = 0, all_pos = 0;
    for (int w = 0; w < nw; ++w) {
      const int c = wtab[w];
      at += w < warp ? c : 0;
      all += c;
      all_pos += wtab[32 + w];
    }
    bool mine = false;
    if (take) mine = put(j, at);
    kept += all;
    npos += all_pos;
    any_bad |= __syncthreads_or(mine) != 0;
  }
  bad = any_bad;
  return kept;
}

// psph_compact_where keeping the live slots (m != 0): padding and
// duplicates carry m = 0 and add exactly 0 to every sum of the grad-h
// sweeps, whatever their other fields hold.
template <typename Put>
__device__ __forceinline__ int psph_compact(const float* mrow, int cnt,
                                            int* wtab, int& npos, bool& bad,
                                            Put put) {
  return psph_compact_where(mrow, cnt, wtab, npos, bad,
                            [](int, float m) { return m != 0.0f; }, put);
}

// Stable compaction of the staged slots [0, cnt) for which live(j) holds:
// put(j, k) stores slot j at compacted position k, k counting the kept
// slots before j. Returns the number kept, the same in every thread.
// Every thread of the block calls it; it ends with a barrier, after which
// the compacted slots are visible to the whole block. wtab: 32 ints of
// shared memory.
template <typename Live, typename Put>
__device__ __forceinline__ int psph_compact_if(int cnt, int* wtab,
                                               Live live, Put put) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  const int here = blockDim.x - (warp << 5);        // threads of this warp
  const unsigned mask = here >= 32 ? 0xffffffffu : (1u << here) - 1u;
  const unsigned below = (1u << lane) - 1u;
  int kept = 0;
  for (int base = 0; base < cnt; base += blockDim.x) {
    const int j = base + tid;
    const bool mine = j < cnt && live(j);
    const unsigned ballot = __ballot_sync(mask, mine);
    if (lane == 0) wtab[warp] = __popc(ballot);
    __syncthreads();
    int at = kept + __popc(ballot & below), all = 0;
    for (int w = 0; w < nw; ++w) {
      const int c = wtab[w];
      at += w < warp ? c : 0;
      all += c;
    }
    if (mine) put(j, at);
    kept += all;
    __syncthreads();
  }
  return kept;
}

// True when every one of the n values is finite.
template <int N>
__device__ __forceinline__ bool psph_all_finite(const float (&v)[N]) {
  bool ok = true;
#pragma unroll
  for (int e = 0; e < N; ++e) ok = ok && isfinite(v[e]);
  return ok;
}

// Sweep the first n slots of NR window rows starting at `row`, one tile of
// PSPH_TILE slots at a time: the copy of tile t + 1 is in flight while
// tile(staged, cnt) compacts and sweeps tile t from raw[t & 1]. Every
// thread of the block calls it.
template <int NR, typename Tile>
__device__ __forceinline__ void psph_window(const float* const (&rows)[NR],
                                            size_t row, int n, bool vec,
                                            float (*raw)[NR][PSPH_TILE],
                                            Tile tile) {
  const int tiles = (n + PSPH_TILE - 1) / PSPH_TILE;
  if (tiles > 0) psph_stage<NR>(raw[0], rows, row, min(PSPH_TILE, n), vec);
  for (int t = 0; t < tiles; ++t) {
    const int next = (t + 1) * PSPH_TILE;
    if (t + 1 < tiles) {
      psph_stage<NR>(raw[(t + 1) & 1], rows, row + next,
                     min(PSPH_TILE, n - next), vec);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    tile(raw[t & 1], min(PSPH_TILE, n - t * PSPH_TILE));
    __syncthreads();
  }
}

// Add the ns slices' sums of each target in slice order into slice 0's
// registers, through `red` (at least N * blockDim.x values of shared
// memory that no thread still reads). Every thread calls it; afterwards
// the threads of slice 0 hold the totals.
template <typename T, int N>
__device__ __forceinline__ void psph_combine(T (&acc)[N], T* red, int b,
                                             int ns) {
  if (ns == 1) return;
  const int nt = blockDim.x, tid = threadIdx.x;
  __syncthreads();
#pragma unroll
  for (int q = 0; q < N; ++q) red[q * nt + tid] = acc[q];
  __syncthreads();
  if (tid < b) {
#pragma unroll
    for (int q = 0; q < N; ++q)
      for (int k = 1; k < ns; ++k) acc[q] += red[q * nt + k * b + tid];
  }
}

// 4 (1 + 2^-12): r2 ih^2 above this means sqrtf(r2) ih >= 2 in f32 (the
// margin lies far above the rounding of either product), so a pair the
// skip leaves out is outside the support of that ih
#define PSPH_Q2_SKIP 4.0009765625f

// The all-pairs kernels' cull (pairwise_pass1.cu, pairwise_pass2.cu). In
// the Morton order of a plan, box k holds the particles [k PSPH_SUB,
// (k + 1) PSPH_SUB): a warp's targets and a source sub-tile are each one
// box. Box k is two float4 (lo, hi): the bounds of x, y and z, lo.w the
// smallest 1/h of the box, or NaN when a value that a pass reads of one
// of its particles is not finite (hi.w is 0).
#define PSPH_SUB 64

// A plan's two counters (near and tested (warp, sub-tile) pairs) are each
// this many slots, which the warps' atomic adds share round robin: one
// address taken by every warp of a sweep serialises some 10^4 adds
#define PSPH_PLAN_SLOTS 64

// 4 (1 + 2^-10): a box pair with (d2 ihm) ihm above this is far. d2 is
// formed from the gaps between the boxes as r2 is formed from a pair's
// d, every step monotone, so each pair of the two boxes has r2 >= d2; its
// 1/h are >= ihm; its (r2 ihm_pair) ihm_pair is then above PSPH_FAR_Q2,
// which lies above PSPH_Q2_SKIP: the q^2 test skips every pair of a far
// box pair, with 2^-10 - 2^-12 to spare beyond the rounding
#define PSPH_FAR_Q2 4.00390625f

// the plain versions' floor on r2 before 1/sqrt(r2) (torch.clamp): a far
// box pair also has d2 at or above it, so its pairs' r2 needs no clamp
// and leaves no denormal to rsqrtf's scaling
#define PSPH_R2_FLOOR 1e-30f

// the gap between [alo, ahi] and [blo, bhi] on one axis, 0 where they
// meet, NaN where a bound is
__device__ __forceinline__ float psph_gap(float alo, float ahi, float blo,
                                          float bhi) {
  return psph_max(psph_max(alo - bhi, blo - ahi), 0.0f);
}

// Box a (alo, ahi) against box b: true when no pair of them lies inside
// either support, and every pair's r2 is at or above PSPH_R2_FLOOR. NaN
// in a bound or in either lo.w (a flagged box) is never far.
__device__ __forceinline__ bool psph_box_far(float4 alo, float4 ahi,
                                             float4 blo, float4 bhi) {
  const float gx = psph_gap(alo.x, ahi.x, blo.x, bhi.x);
  const float gy = psph_gap(alo.y, ahi.y, blo.y, bhi.y);
  const float gz = psph_gap(alo.z, ahi.z, blo.z, bhi.z);
  const float d2 = fmaf(gz, gz, fmaf(gy, gy, gx * gx));
  const float ihm = psph_min(alo.w, blo.w);
  return (d2 * ihm) * ihm > PSPH_FAR_Q2 && d2 >= PSPH_R2_FLOOR;
}

// One box from a warp's particles: each lane passes the bounds of its own
// (x, y, z and 1/h in lo.w; lo = +inf and hi = -inf for none) and whether
// a value of them is not finite; lane 0 writes the box to box[0..1]. Every
// lane of the warp calls it.
__device__ __forceinline__ void psph_box_store(float4 lo, float4 hi,
                                               bool bad, float4* box) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo.x = psph_min(lo.x, __shfl_xor_sync(0xffffffffu, lo.x, o));
    lo.y = psph_min(lo.y, __shfl_xor_sync(0xffffffffu, lo.y, o));
    lo.z = psph_min(lo.z, __shfl_xor_sync(0xffffffffu, lo.z, o));
    lo.w = psph_min(lo.w, __shfl_xor_sync(0xffffffffu, lo.w, o));
    hi.x = psph_max(hi.x, __shfl_xor_sync(0xffffffffu, hi.x, o));
    hi.y = psph_max(hi.y, __shfl_xor_sync(0xffffffffu, hi.y, o));
    hi.z = psph_max(hi.z, __shfl_xor_sync(0xffffffffu, hi.z, o));
  }
  const bool flagged = __any_sync(0xffffffffu, bad);
  if ((threadIdx.x & 31) == 0) {
    const float ihm = flagged ? __int_as_float(0x7fc00000) : lo.w;
    box[0] = make_float4(lo.x, lo.y, lo.z, ihm);
    box[1] = make_float4(hi.x, hi.y, hi.z, 0.0f);
  }
}

// extends a lane's box bounds by one particle
__device__ __forceinline__ void psph_box_add(float4& lo, float4& hi, float x,
                                             float y, float z, float ih) {
  lo = make_float4(psph_min(lo.x, x), psph_min(lo.y, y), psph_min(lo.z, z),
                   psph_min(lo.w, ih));
  hi = make_float4(psph_max(hi.x, x), psph_max(hi.y, y), psph_max(hi.z, z),
                   0.0f);
}

// the bounds of no particle
__device__ __forceinline__ void psph_box_empty(float4& lo, float4& hi) {
  const float inf = __int_as_float(0x7f800000);
  lo = make_float4(inf, inf, inf, inf);
  hi = make_float4(-inf, -inf, -inf, 0.0f);
}

// Slot slices a group's window is split into (a power of 2): with 4 both
// windowed sweeps ran faster than with 2 on the H100 (PERF.md).
#define PSPH_SLICES 4

// Slot slices for a group of b targets: PSPH_SLICES, halved until a block
// of min(b, PSPH_WIN_THREADS) targets fits PSPH_WIN_THREADS; 0 when b < 1.
static inline int psph_slices(int b) {
  if (b < 1) return 0;
  const int bt = b < PSPH_WIN_THREADS ? b : PSPH_WIN_THREADS;
  int ns = PSPH_SLICES;
  while (ns > 1 && bt * ns > PSPH_WIN_THREADS) ns >>= 1;
  return ns;
}

// The launch shape of a windowed sweep over g groups of b targets with ns
// slot slices. A group of more than PSPH_WIN_THREADS targets is split over
// blocks: block (g, y) takes targets [y bt, min(b, (y + 1) bt)) of group
// g, bt = min(b, PSPH_WIN_THREADS), and sweeps the group's whole window
// for them, so that each target is finished by one block (no sum crosses
// blocks) and a group of at most PSPH_WIN_THREADS targets is one block
// (gridDim.y = 1) as before; a block runs bt * ns threads.
static inline dim3 psph_grid(int g, int b) {
  return dim3(g, (b + PSPH_WIN_THREADS - 1) / PSPH_WIN_THREADS);
}
static inline int psph_block(int b, int ns) {
  return (b < PSPH_WIN_THREADS ? b : PSPH_WIN_THREADS) * ns;
}

// What a thread of a windowed sweep serves (psph_grid): thread
// tid of block (g, y) takes target y bt + tid % bt of the group and slot
// slice k = tid / bt. Past the group's last target (`on` false, in the
// last block of a group whose b is not a multiple of bt) it reads the
// block's first target, stages, compacts and synchronises with the block,
// but visits no slot (`from`, its first compacted slot, is PSPH_TILE,
// past every tile) and writes nothing.
struct PsphShare {
  int bt;       // targets a slice: min(b, PSPH_WIN_THREADS)
  int k;        // the thread's slot slice
  int from;     // its first compacted slot: k, or PSPH_TILE when !on
  bool on;      // it serves a target of the group
  size_t t;     // that target's column
};

__device__ __forceinline__ PsphShare psph_share(int b) {
  const int bt = min(b, PSPH_WIN_THREADS);
  const int i = threadIdx.x % bt, k = threadIdx.x / bt;
  const int first = blockIdx.y * bt;
  const bool on = first + i < b;
  return {bt, k, on ? k : PSPH_TILE, on,
          (size_t)blockIdx.x * b + first + (on ? i : 0)};
}

// True when every row pointer is 16-byte aligned and rows of length s
// keep every tile start aligned (s a multiple of 4): psph_stage may copy
// 16 bytes at a time.
static inline bool psph_vec_rows(const float* const* rows, int nr, int s) {
  if (s % 4 != 0) return false;
  for (int r = 0; r < nr; ++r)
    if (rows[r] != nullptr && ((size_t)rows[r] & 15) != 0) return false;
  return true;
}
