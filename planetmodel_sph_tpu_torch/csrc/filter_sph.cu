// Rebuild-time true-pair candidate filter over the SPH window.
//
// Replaces: planetmodel_sph_tpu/ops/pallas/groups2.py filter_sph (:382),
// body _filter_kernel (:341).
//
//   keep[g, j] = 1 if some target i of group g has
//                r_ij^2 < (max(tc_i, sc_j) + tsk_i + ssk_j)^2,
//                with j < nv[g] and m_j > 0; else 0 (every slot written).
// tc/sc are kappa*(1+margin)*h scaled by the caller, tsk/ssk the skins.
// The max is NaN when either operand is (psph_max, as torch.maximum and
// jnp.maximum are): a NaN cut then fails the test.
//
// Bound on the H100: the bytes, 24 of source row read per live slot and 4
// of mask written per slot, against about 13 f32 operations per (target,
// slot) test. The filter exists to shrink the window about 5x, so most
// live slots are kept by no target: the first design, threads over slots
// with the group's targets in shared memory, ran all B tests for each of
// those, and a warp waited for its slowest lane. This design:
// - the group's targets are split into boxes of PSPH_FILTER_BOX targets in
//   their Morton order, each with its bounding box, the largest tc and
//   the largest tsk, computed once a block in shared memory; a group of
//   up to 9,820 targets (FILTER_MAX_DYNAMIC: one block's shared memory)
//   is one block (its mask row is the OR over all its targets), the boxes
//   taken 32 at a time, one word of box bits each; a larger group is cut
//   into T tiles of at most that many targets (whole boxes), one block a
//   (group, tile) in one g x T grid (the TILED instance: the same body,
//   the tile's targets read from a tile-major copy, its mask row written
//   to the [T, g, s] partial masks), and a second kernel ORs the T masks
//   of each slot (the same tests, so the same mask, and no atomics);
// - every live slot meets every box as a whole first (the same work in
//   every lane): the squared distance d2 from the slot to the box (per
//   axis the gap lo - x or x - hi, 0 inside) cannot exceed any target's
//   r2 (the same operations on operands no larger, in the same order),
//   and the box's cut, max(tc_max, sc) + tsk_max + ssk, cannot fall below
//   any target's cut when no cut term is negative; so d2 >= cut_max^2
//   PSPH_FILTER_MARGIN means no target of the box keeps the slot, and its
//   targets are not tested (the pre-reject). The margin lies far above
//   the rounding of those few operations;
// - the pre-reject only fires on finite operands: a box with a target
//   whose x, y, z, tc or tsk is not finite, or whose tc or tsk is negative,
//   carries a NaN tc_max, and so does a slot with such a field (sc_pre);
//   d2 >= NaN is false, and those slots meet the exact tests;
// - each (slot, box) pair that the box does not reject joins its warp's
//   queue; once 32 pairs wait, the warp sweeps them, one pair a lane: the
//   box's targets in order, each with the exact test, to the first hit.
//   A lane's work is one box, at most PSPH_FILTER_BOX tests, and every
//   lane of a sweep has a pair, however few slots of a tile survive. The
//   mask is the OR of the tests, the plain version's: each tile writes 0
//   for its slots (one coalesced store), and a hit writes 1;
// - the slots of the two tiles after the current one are loaded before
//   its pairs are swept, so that their loads are in flight meanwhile.
// The library is built with -fmad=false so r2 and cut*cut round exactly
// as the plain version's separate multiplies and adds do: the mask
// matches it bit for bit.
#include "common.cuh"

// targets of a pre-reject box, Morton-contiguous in the group (a slot's
// surviving boxes among 32 are the bits of one word)
#define PSPH_FILTER_BOX 16
// 1 + 2^-10: the box's squared cut is raised by this factor before the
// pre-reject compares it, far above the rounding of its few operations
#define PSPH_FILTER_MARGIN 1.0009765625f
// the cut term a box or slot carries when it must not be pre-rejected
#define PSPH_NAN __int_as_float(0x7fc00000)
#define PSPH_INF __int_as_float(0x7f800000)

#define FILTER_THREADS 256
// the dynamic shared memory a block may take beside its queues: the
// H100's 227 KB a block less the static 16 KB, which holds the targets
// and boxes of a group of up to 9,820 targets
#define FILTER_MAX_DYNAMIC (232448 - 2 * 2 * FILTER_THREADS * 16)

// The boxes among box[0, nbox) (nbox <= 32) that may keep a slot: bit q
// clear where box q pre-rejects it.
__device__ __forceinline__ unsigned filter_boxes(const float4* box,
                                                 int nbox, float cx,
                                                 float cy, float cz,
                                                 float cc, float csk) {
  const float sc_pre = (isfinite(cx) && isfinite(cy) && isfinite(cz) &&
                        isfinite(cc) && isfinite(csk) && cc >= 0.0f &&
                        csk >= 0.0f) ? cc : PSPH_NAN;
  unsigned boxes = 0;
  for (int q = 0; q < nbox; ++q) {
    const float4 lo = box[2 * q], hi = box[2 * q + 1];
    const float ex = fmaxf(fmaxf(lo.x - cx, cx - hi.x), 0.0f);
    const float ey = fmaxf(fmaxf(lo.y - cy, cy - hi.y), 0.0f);
    const float ez = fmaxf(fmaxf(lo.z - cz, cz - hi.z), 0.0f);
    const float d2 = ex * ex + ey * ey + ez * ez;
    const float cut_max = psph_max(lo.w, sc_pre) + hi.w + csk;
    if (!(d2 >= cut_max * cut_max * PSPH_FILTER_MARGIN)) boxes |= 1u << q;
  }
  return boxes;
}

// The exact test of target i against a slot.
__device__ __forceinline__ bool filter_hit(const float4* tgt,
                                           const float* tskin, int i,
                                           float cx, float cy, float cz,
                                           float cc, float csk) {
  const float4 p = tgt[i];
  const float tk = tskin[i];
  const float dxx = p.x - cx;
  const float dxy = p.y - cy;
  const float dxz = p.z - cz;
  const float r2 = dxx * dxx + dxy * dxy + dxz * dxz;
  const float cut = psph_max(p.w, cc) + tk + csk;
  return r2 < cut * cut;
}

struct Slot {
  float m, x, y, z, c, sk;
};

// WIDE: more than 32 boxes a group (b > 512), taken a word of 32 at a
// time; otherwise one word, with no loop over words (slower in turns on
// the H100 at b = 64). TILED: block (g, t) of a g x T grid takes tile t
// of group g, its b targets at ((t G + g) b) of the tile-major copy and
// its mask row at ((t G + g) s) of the [T, G, s] partial masks; the slot
// rows and nv are the group's. Without it the code is the one-block
// path's as it was before the tiles (its SASS unchanged).
template <bool WIDE, bool TILED = false>
__global__ void __launch_bounds__(FILTER_THREADS) filter_sph_kernel(
    const float* __restrict__ tx, const float* __restrict__ ty,
    const float* __restrict__ tz, const float* __restrict__ tc,
    const float* __restrict__ tsk, const float* __restrict__ sx,
    const float* __restrict__ sy, const float* __restrict__ sz,
    const float* __restrict__ sc, const float* __restrict__ ssk,
    const float* __restrict__ sm, const int* __restrict__ nv,
    float* __restrict__ keep, int b, int s) {
  // [b] targets (x, y, z, tc); [nbox] boxes, two float4s each: (lo x, y,
  // z, tc_max), (hi x, y, z, tsk_max); [b] target skins
  extern __shared__ __align__(16) float4 sh[];
  // each warp's queue of (slot, box) pairs, at most 64: the slot's (x, y,
  // z, sc), then (ssk, slot, first target of the box)
  __shared__ float4 qpos[FILTER_THREADS * 2];
  __shared__ float4 qrest[FILTER_THREADS * 2];
  const int nbox = (b + PSPH_FILTER_BOX - 1) / PSPH_FILTER_BOX;
  float4* tgt = sh;
  float4* box = sh + b;
  float* tskin = reinterpret_cast<float*>(sh + b + 2 * nbox);
  const int g = blockIdx.x;
  const size_t cell = TILED ? (size_t)blockIdx.y * gridDim.x + g : g;
  const size_t t0 = cell * b;
  for (int i = threadIdx.x; i < b; i += blockDim.x) {
    tgt[i] = make_float4(tx[t0 + i], ty[t0 + i], tz[t0 + i], tc[t0 + i]);
    tskin[i] = tsk[t0 + i];
  }
  __syncthreads();
  for (int q = threadIdx.x; q < nbox; q += blockDim.x) {
    float4 lo = make_float4(PSPH_INF, PSPH_INF, PSPH_INF, -PSPH_INF);
    float4 hi = make_float4(-PSPH_INF, -PSPH_INF, -PSPH_INF, -PSPH_INF);
    bool finite = true;
    for (int i = q * PSPH_FILTER_BOX; i < min(b, (q + 1) * PSPH_FILTER_BOX);
         ++i) {
      const float4 p = tgt[i];
      const float tk = tskin[i];
      lo = make_float4(fminf(lo.x, p.x), fminf(lo.y, p.y), fminf(lo.z, p.z),
                       fmaxf(lo.w, p.w));
      hi = make_float4(fmaxf(hi.x, p.x), fmaxf(hi.y, p.y), fmaxf(hi.z, p.z),
                       fmaxf(hi.w, tk));
      finite = finite && isfinite(p.x) && isfinite(p.y) && isfinite(p.z) &&
               isfinite(p.w) && isfinite(tk) && p.w >= 0.0f && tk >= 0.0f;
    }
    if (!finite) lo.w = PSPH_NAN;
    box[2 * q] = lo;
    box[2 * q + 1] = hi;
  }
  __syncthreads();

  const size_t row = (size_t)g * s;
  const size_t out = cell * s;         // the mask row (row without TILED)
  const int n = min(nv[g], s);
  const int lane = threadIdx.x & 31;
  float4* qp = qpos + 2 * (threadIdx.x & ~31);
  float4* qr = qrest + 2 * (threadIdx.x & ~31);
  // sweep the warp's first `count` pairs, one a lane
  const auto sweep = [&](int count) {
    __syncwarp();
    if (lane < count) {
      const float4 c = qp[lane], r = qr[lane];
      const int i0 = __float_as_int(r.z);
      const int i1 = min(b, i0 + PSPH_FILTER_BOX);
      for (int i = i0; i < i1; ++i)
        if (filter_hit(tgt, tskin, i, c.x, c.y, c.z, c.w, r.x)) {
          keep[out + __float_as_int(r.y)] = 1.0f;
          break;
        }
    }
    __syncwarp();
  };
  const auto load = [&](int j) {
    Slot v = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (j < n) {
      v.m = sm[row + j];
      v.x = sx[row + j];
      v.y = sy[row + j];
      v.z = sz[row + j];
      v.c = sc[row + j];
      v.sk = ssk[row + j];
    }
    return v;
  };
  // the tiles of blockDim.x slots up to nv; past it every slot is 0
  const int tiles = (n + blockDim.x - 1) / blockDim.x;
  int count = 0;                       // pairs waiting in the warp's queue
  Slot cur = load(threadIdx.x);
  Slot next = load(threadIdx.x + blockDim.x);
  for (int t = 0; t < tiles; ++t) {
    const int j = t * blockDim.x + threadIdx.x;
    const Slot after = load(j + 2 * blockDim.x);
    if (j < s) keep[out + j] = 0.0f;
    for (int q0 = 0; q0 < (WIDE ? nbox : 1); q0 += 32) {
      const int nq = WIDE ? min(32, nbox - q0) : nbox;
      const unsigned boxes =
          cur.m > 0.0f ? filter_boxes(box + 2 * q0, nq, cur.x, cur.y, cur.z,
                                      cur.c, cur.sk)
                       : 0u;
      for (int q = 0; q < nq; ++q) {
        const bool mine = (boxes >> q) & 1u;
        const unsigned pairs = __ballot_sync(0xffffffffu, mine);
        if (mine) {
          const int at = count + __popc(pairs & ((1u << lane) - 1u));
          qp[at] = make_float4(cur.x, cur.y, cur.z, cur.c);
          qr[at] = make_float4(cur.sk, __int_as_float(j),
                               __int_as_float((q0 + q) * PSPH_FILTER_BOX),
                               0.0f);
        }
        count += __popc(pairs);
        if (count >= 32) {
          sweep(32);
          count -= 32;
          if (lane < count) {
            qp[lane] = qp[32 + lane];
            qr[lane] = qr[32 + lane];
          }
          __syncwarp();
        }
      }
    }
    cur = next;
    next = after;
  }
  sweep(count);
  for (int j = tiles * blockDim.x + threadIdx.x; j < s; j += blockDim.x)
    keep[out + j] = 0.0f;
}

// The tiled path's targets, tile-major: column c of tile t of group
// gi at tt[((c T + t) g + gi) tile + i], from target t tile + i of the
// group; past the group's last target, copies of it (a copy tests a slot
// as its original does, so the OR is unchanged, and the last tile's boxes
// bound what the one-block path's do).
__global__ void filter_sph_tile_targets(
    const float* __restrict__ tx, const float* __restrict__ ty,
    const float* __restrict__ tz, const float* __restrict__ tc,
    const float* __restrict__ tsk, float* __restrict__ tt, int g, int b,
    int tile, int tiles) {
  const size_t per = (size_t)tiles * g * tile;   // one column's elements
  for (size_t k = (size_t)blockIdx.x * blockDim.x + threadIdx.x; k < per;
       k += (size_t)gridDim.x * blockDim.x) {
    const int i = (int)(k % tile);
    const int gi = (int)(k / tile % g);
    const int t = (int)(k / tile / g);
    const size_t src = (size_t)gi * b + min(t * tile + i, b - 1);
    tt[k] = tx[src];
    tt[per + k] = ty[src];
    tt[2 * per + k] = tz[src];
    tt[3 * per + k] = tc[src];
    tt[4 * per + k] = tsk[src];
  }
}

// keep[g, j] = 1 where the mask of some tile part[t, g, j] is 1: the OR
// over the tiles' targets, as the one-block path's mask is over all.
__global__ void filter_sph_or(const float* __restrict__ part,
                              float* __restrict__ keep, size_t n,
                              int tiles) {
  for (size_t k = (size_t)blockIdx.x * blockDim.x + threadIdx.x; k < n;
       k += (size_t)gridDim.x * blockDim.x) {
    bool hit = false;
    for (int t = 0; t < tiles; ++t) hit = hit || part[t * n + k] != 0.0f;
    keep[k] = hit ? 1.0f : 0.0f;
  }
}

static unsigned filter_grid(size_t n) {
  const size_t blocks = (n + 255) / 256;
  return (unsigned)(blocks < 65535 ? blocks : 65535);
}

// `scratch` null: a group a block (b at most 9,820). Otherwise the tiled
// path, `tile` targets a tile, T = ceil(b / tile) tiles, one g x T grid:
// scratch holds the T masks [T, g, s] and then the tile-major targets
// [5, T, g, tile].
extern "C" int psph_filter_sph(
    const float* tx, const float* ty, const float* tz, const float* tc,
    const float* tsk, const float* sx, const float* sy, const float* sz,
    const float* sc, const float* ssk, const float* sm, const int* nv,
    float* keep, float* scratch, int g, int b, int s, int tile,
    void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int bb = scratch == nullptr ? b : tile;      // targets a block
  const int nbox = (bb + PSPH_FILTER_BOX - 1) / PSPH_FILTER_BOX;
  const size_t smem = (size_t)(bb + 2 * nbox) * sizeof(float4) +
                      (size_t)bb * sizeof(float);
  if (g > 0 && (bb < 1 || smem > FILTER_MAX_DYNAMIC))
    return (int)cudaErrorInvalidValue;
  const bool tiled = scratch != nullptr;
  const auto kernel =
      tiled ? (nbox > 32 ? filter_sph_kernel<true, true>
                         : filter_sph_kernel<false, true>)
            : (nbox > 32 ? filter_sph_kernel<true> : filter_sph_kernel<false>);
  if (g > 0 && smem > 48 * 1024) {
    // above 48 KB only as opted-in dynamic shared memory
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (g > 0 && !tiled)
    kernel<<<g, FILTER_THREADS, smem, st>>>(
        tx, ty, tz, tc, tsk, sx, sy, sz, sc, ssk, sm, nv, keep, b, s);
  if (g > 0 && tiled) {
    const int tiles = (b + tile - 1) / tile;
    const size_t n = (size_t)g * s, per = (size_t)tiles * g * tile;
    float* tt = scratch + tiles * n;
    filter_sph_tile_targets<<<filter_grid(per), 256, 0, st>>>(
        tx, ty, tz, tc, tsk, tt, g, b, tile, tiles);
    kernel<<<dim3(g, tiles), FILTER_THREADS, smem, st>>>(
        tt, tt + per, tt + 2 * per, tt + 3 * per, tt + 4 * per, sx, sy, sz,
        sc, ssk, sm, nv, scratch, tile, s);
    filter_sph_or<<<filter_grid(n), 256, 0, st>>>(scratch, keep, n, tiles);
  }
  return (int)cudaGetLastError();
}
