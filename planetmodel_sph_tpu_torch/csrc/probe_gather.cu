// Window-row gather probe.
//
// Replaces: tools/microbench.py gather_kernel (:96-97), launched by
// v_pallas (:113): out[g, w, :] = packed[idx[g, w], :], the pattern of
// ops/structure.py _window_gather with scalar-prefetched window ids.
//
// Bound on the H100: bytes. At the reference's shape (packed [2067, 448]
// f32, idx [2067, 96]) the output is 355.6 MB written once and nothing is
// computed; the 3.7 MB table stays in the 50 MB L2, so the write stream
// sets the pace (at the measured stream rate, some 0.12 ms). The first
// design gave each row to one warp, each lane copying 3.5 float4 with a
// load and then a store, so few bytes were in flight per SM, and its
// stores went through L2 like any other, competing with the table.
//
// This design copies whole rows with the Tensor Memory Accelerator:
// - a persistent grid of GATHER_BLOCKS_PER_SM one-warp blocks per SM walks
//   the rows in chunks of GATHER_CHUNK; the warp reads a chunk's ids with
//   coalesced loads and clamps them into [0, nb) (as _window_gather clamps
//   its -1 padding) into shared memory, the counterpart of the TPU's
//   scalar prefetch;
// - one thread keeps GATHER_STAGES - 1 rows in flight: a 1-D bulk copy
//   (cp.async.bulk) of the source row into a stage of shared memory,
//   completed on that stage's mbarrier, then a bulk store of the stage to
//   the output row, with an L2 evict-first policy so that the output
//   streams past L2 and the table stays resident; a stage is loaded again
//   once its store has read it (cp.async.bulk.wait_group.read);
// - a bulk copy needs 16-byte aligned addresses and a size that is a
//   multiple of 16: where the row width is not a multiple of 4 floats, a
//   pointer is not 16-byte aligned, or the stages would not fit in 48 KB
//   of shared memory (rows over 5 KB; the tool's are 1,792 B), a warp
//   copies each row 4 bytes at a time instead.
// The output is the same bits as the plain version's: a copy.
#include <cstdint>

#include <cuda_runtime.h>

#define GATHER_STAGES 8            // rows of shared memory a block cycles
#define GATHER_CHUNK 256           // rows whose ids a block stages at once
#define GATHER_BLOCKS_PER_SM 8
#define GATHER_MAX_STAGE 5120      // bytes a row: 8 stages and the ids
                                   // stay under 48 KB of shared memory
#define ROWS_PER_BLOCK 8           // 4-byte path: one warp a row

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// row `src` of the table into the stage at `dst`, completing on `bar`
__device__ __forceinline__ void row_load(uint32_t dst, const float* src,
                                         uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :
               : "r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :
      : "r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// the stage at `src` to output row `dst`, evict-first in L2
__device__ __forceinline__ void row_store(float* dst, uint32_t src,
                                          uint32_t bytes, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint "
      "[%0], [%1], %2, %3;\n"
      :
      : "l"(dst), "r"(src), "r"(bytes), "l"(policy)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(32) probe_gather_bulk(
    const float* __restrict__ packed, const int* __restrict__ idx,
    float* __restrict__ out, int nb, int width, int rows) {
  extern __shared__ __align__(128) unsigned char stage[];
  __shared__ __align__(8) uint64_t bars[GATHER_STAGES];
  __shared__ int ids[GATHER_CHUNK];
  const int lane = threadIdx.x;
  const uint32_t bytes = (uint32_t)width * 4u;
  const uint32_t base = smem_addr(stage), bar0 = smem_addr(bars);
  uint64_t policy = 0;
  if (lane == 0) {
    for (int k = 0; k < GATHER_STAGES; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :
                   : "r"(bar0 + 8u * k)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                 : "=l"(policy));
  }
  __syncwarp();
  uint32_t parity = 0;      // bit k: the phase stage k waits for next
  const int chunks = (rows + GATHER_CHUNK - 1) / GATHER_CHUNK;
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    const int r0 = c * GATHER_CHUNK, n = min(GATHER_CHUNK, rows - r0);
    for (int j = lane; j < n; j += 32)
      ids[j] = min(max(idx[r0 + j], 0), nb - 1);
    __syncwarp();
    if (lane == 0) {
      // every stage is free here: the previous chunk waited for its
      // stores to read them
      const int ahead = min(GATHER_STAGES - 1, n);
      for (int j = 0; j < ahead; ++j)
        row_load(base + j * bytes, packed + (size_t)ids[j] * width, bytes,
                 bar0 + 8u * j);
      for (int j = 0; j < n; ++j) {
        const int st = j % GATHER_STAGES;
        bar_wait(bar0 + 8u * st, (parity >> st) & 1u);
        parity ^= 1u << st;
        row_store(out + (size_t)(r0 + j) * width, base + st * bytes, bytes,
                  policy);
        const int next = j + GATHER_STAGES - 1;
        if (next < n) {
          // its stage is the one row j - 1's store read from
          asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
          const int sn = next % GATHER_STAGES;
          row_load(base + sn * bytes, packed + (size_t)ids[next] * width,
                   bytes, bar0 + 8u * sn);
        }
      }
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
    __syncwarp();
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Other rows: one warp a row, 4 bytes a copy.
__global__ void probe_gather_scalar(const float* __restrict__ packed,
                                    const int* __restrict__ idx,
                                    float* __restrict__ out, int nb,
                                    int width, int rows) {
  const int row = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* s = packed + (size_t)min(max(idx[row], 0), nb - 1) * width;
  float* d = out + (size_t)row * width;
  for (int k = lane; k < width; k += 32) d[k] = s[k];
}

extern "C" int psph_probe_gather(const float* packed, const int* idx,
                                  float* out, int nb, int width, int rows,
                                  void* stream) {
  if (rows <= 0 || width <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const bool aligned = width % 4 == 0 && (uintptr_t)packed % 16 == 0 &&
                       (uintptr_t)out % 16 == 0;
  if (aligned && width * 4 <= GATHER_MAX_STAGE) {
    static int sms = 0;      // the card's SM count, read once
    if (sms == 0) {
      int dev = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    const int chunks = (rows + GATHER_CHUNK - 1) / GATHER_CHUNK;
    const int grid = min(chunks, sms * GATHER_BLOCKS_PER_SM);
    probe_gather_bulk<<<grid, 32, GATHER_STAGES * width * 4, st>>>(
        packed, idx, out, nb, width, rows);
  } else {
    const int blocks = (rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
    probe_gather_scalar<<<blocks, 32 * ROWS_PER_BLOCK, 0, st>>>(
        packed, idx, out, nb, width, rows);
  }
  return (int)cudaGetLastError();
}
