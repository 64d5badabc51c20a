// Launch-cost probe.
//
// Replaces: tools/roofline.py trivial_kernel (:115-116), launched by
// measure_launch (:118): o = x * 1.000001 over an [8, 128] block.
//
// Bound on the H100: neither bytes (8 KB) nor operations (1,024): a launch
// costs microseconds, the work nanoseconds (about 1 us of device time), so
// what a chain of such launches measures is the fixed cost of one launch.
// Eagerly that is the host's path to the launch: the wrapper's checks, the
// output's allocation, the stream read, ctypes and cudaLaunchKernel. The
// first path read the stream through a new torch.cuda.Stream object at
// every call and checked each tensor twice, and cost twice a torch.mul;
// the wrapper now takes one test for each check that passes, reads the
// raw stream handle and calls a ctypes.PyDLL entry point (launch.py,
// PERF.md). Replayed from a CUDA graph the host drops out and a launch
// costs one graph node on the card (tools/roofline.py graph_launch), the
// counterpart of the reference's launches inside one jitted scan.
// Design: the smallest kernel that does the function, one block of up to
// 1,024 threads, one element per thread; the product is one f32
// multiply, exact against the plain version's.
#include <cuda_runtime.h>

__global__ void probe_launch_kernel(const float* __restrict__ x,
                                    float* __restrict__ o, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    o[i] = x[i] * 1.000001f;
}

extern "C" int psph_probe_launch(const float* x, float* o, int n,
                                 void* stream) {
  if (n > 0)
    probe_launch_kernel<<<1, n < 1024 ? n : 1024, 0,
                          (cudaStream_t)stream>>>(x, o, n);
  return (int)cudaGetLastError();
}
