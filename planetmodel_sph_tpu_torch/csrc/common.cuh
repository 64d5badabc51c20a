// Shared definitions of the windowed block-pair kernels.
//
// Layout contract (the same as the reference's Pallas sweeps): targets are
// [G*B] columns in the Morton-sorted padded layout, one group of B targets
// per thread block and one target per thread; sources are [G, S] window
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

// Dyer-Ip softened point-mass term, accumulated into (phi, g). Finite at
// r = 0 (x = 0 takes the inner branch, dx = 0 kills the force); phi then
// holds the -2.4 m/a self term that the caller removes.
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

// Near-field gravity sweep over one window: the first n slots of the rows
// (x, y, z, [ih,] m) starting at `row`, Dyer-Ip softened with
// 1/a = ih_i (RECV: receiver softening, the ih row is not read) or
// min(ih_i, ih_j) (NaN when either is). Adds into (phi, g) and counts the
// slots with m > 0 into nd; the self pair is one of them (dx = 0: no
// force, the finite inner potential -2.4 m/a). `c` is the block's staging
// buffer, at least 5 rows. A block that splits the window into ns slot
// slices calls it with each thread's slice k: the thread then visits the
// slots k, k + ns, ... of every tile (the caller adds the slices' sums).
// Every thread of the block must call it (it synchronises).
template <bool RECV>
__device__ __forceinline__ void psph_p2p_window(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const float* __restrict__ pih,
    const float* __restrict__ pm, size_t row, int n, float x, float y,
    float z, float ih, float (*c)[PSPH_TILE], float& phi, float& gx,
    float& gy, float& gz, int& nd, int k = 0, int ns = 1) {
  const int i = threadIdx.x;
  for (int base = 0; base < n; base += PSPH_TILE) {
    const int cnt = min(PSPH_TILE, n - base);
    for (int j = i; j < cnt; j += blockDim.x) {
      c[0][j] = px[row + base + j];
      c[1][j] = py[row + base + j];
      c[2][j] = pz[row + base + j];
      if (!RECV) c[3][j] = pih[row + base + j];
      c[4][j] = pm[row + base + j];
    }
    __syncthreads();
    for (int j = k; j < cnt; j += ns) {
      const float dxx = x - c[0][j];
      const float dxy = y - c[1][j];
      const float dxz = z - c[2][j];
      const float r2 = dxx * dxx + dxy * dxy + dxz * dxz;
      const float m = c[4][j];
      const float inv_r = rsqrtf(psph_max(r2, 1e-30f));
      const float inv_a = RECV ? ih : psph_min(ih, c[3][j]);
      psph_dyer_ip(m, dxx, dxy, dxz, r2, inv_r, inv_a, phi, gx, gy, gz);
      nd += (m > 0.0f) ? 1 : 0;
    }
    __syncthreads();
  }
}

// Staging of the source windows of the two grad-h sweeps (pass1_gradh.cu,
// pass2.cu): double-buffered asynchronous copies of window tiles into
// shared memory, and the block-wide compaction of the live slots.
//
// A block of these sweeps runs b targets times ns slot slices
// (b * ns <= PSPH_WIN_THREADS threads): thread t serves target t % b and
// slice t / b, and slice k visits the compacted slots k, k + ns, ... of
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
// holds, m = mrow[j] (keep must hold wherever m != 0): put(j, k) stores
// slot j at compacted position k, k counting the kept slots before j, and
// returns true when one of the slot's staged fields is not finite.
// Returns the number kept, adds the number with m > 0 to npos and sets
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

// Slot slices a group's window is split into (a power of 2): with 4 both
// windowed sweeps ran faster than with 2 on the H100 (PERF.md).
#define PSPH_SLICES 4

// Slot slices for a group of b targets: PSPH_SLICES, halved until the
// block fits PSPH_WIN_THREADS; 0 when b does not fit at all.
static inline int psph_slices(int b) {
  if (b < 1 || b > PSPH_WIN_THREADS) return 0;
  int ns = PSPH_SLICES;
  while (ns > 1 && b * ns > PSPH_WIN_THREADS) ns >>= 1;
  return ns;
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
