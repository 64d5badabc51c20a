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
//   the largest tsk, computed once a block in shared memory; a group is
//   one block whatever its size (its mask row is the OR over all its
//   targets), the boxes taken 32 at a time, one word of box bits each;
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
// the H100 at b = 64)
template <bool WIDE>
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
  const size_t t0 = (size_t)g * b;
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
          keep[row + __float_as_int(r.y)] = 1.0f;
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
    if (j < s) keep[row + j] = 0.0f;
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
    keep[row + j] = 0.0f;
}

extern "C" int psph_filter_sph(
    const float* tx, const float* ty, const float* tz, const float* tc,
    const float* tsk, const float* sx, const float* sy, const float* sz,
    const float* sc, const float* ssk, const float* sm, const int* nv,
    float* keep, int g, int b, int s, void* stream) {
  const int nbox = (b + PSPH_FILTER_BOX - 1) / PSPH_FILTER_BOX;
  const size_t smem = (size_t)(b + 2 * nbox) * sizeof(float4) +
                      (size_t)b * sizeof(float);
  if (g > 0 && smem > FILTER_MAX_DYNAMIC) return (int)cudaErrorInvalidValue;
  const auto kernel =
      nbox > 32 ? filter_sph_kernel<true> : filter_sph_kernel<false>;
  if (g > 0 && smem > 48 * 1024) {
    // above 48 KB only as opted-in dynamic shared memory
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (g > 0)
    kernel<<<g, FILTER_THREADS, smem, (cudaStream_t)stream>>>(
        tx, ty, tz, tc, tsk, sx, sy, sz, sc, ssk, sm, nv, keep, b, s);
  return (int)cudaGetLastError();
}
