// Window-row gather probe.
//
// Replaces: tools/microbench.py gather_kernel (:96-97), launched by
// v_pallas (:113): out[g, w, :] = packed[idx[g, w], :], the pattern of
// ops/structure.py _window_gather with scalar-prefetched window ids.
//
// Bound on the H100: bytes. At the reference's shape (packed [2067, 448]
// f32, idx [2067, 96]) the output is 356 MB written once and nothing is
// computed; the 3.7 MB table stays in the 50 MB L2, so the write stream
// sets the pace. Design: one warp per (g, w) row, eight rows per block;
// the warp reads its row id itself (the counterpart of the TPU's scalar
// prefetch), clamps it into [0, nb) as _window_gather clamps its -1
// padding, and copies the row with 16-byte loads and stores, neighbouring
// lanes on neighbouring addresses. A row width that is not a multiple of
// four floats, or an unaligned pointer, takes a 4-byte copy instead.
#include <cstdint>

#include <cuda_runtime.h>

#define ROWS_PER_BLOCK 8

__global__ void probe_gather_kernel(const float* __restrict__ packed,
                                    const int* __restrict__ idx,
                                    float* __restrict__ out, int nb,
                                    int width, int rows, int vec) {
  const int row = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int src = min(max(idx[row], 0), nb - 1);
  const float* s = packed + (size_t)src * width;
  float* d = out + (size_t)row * width;
  if (vec) {
    const float4* s4 = reinterpret_cast<const float4*>(s);
    float4* d4 = reinterpret_cast<float4*>(d);
    for (int k = lane; k < width / 4; k += 32) d4[k] = s4[k];
  } else {
    for (int k = lane; k < width; k += 32) d[k] = s[k];
  }
}

extern "C" int psph_probe_gather(const float* packed, const int* idx,
                                  float* out, int nb, int width, int rows,
                                  void* stream) {
  const int vec = (width % 4 == 0) &&
                  ((uintptr_t)packed % 16 == 0) && ((uintptr_t)out % 16 == 0);
  if (rows > 0 && width > 0)
    probe_gather_kernel<<<(rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK,
                          32 * ROWS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
        packed, idx, out, nb, width, rows, vec);
  return (int)cudaGetLastError();
}
