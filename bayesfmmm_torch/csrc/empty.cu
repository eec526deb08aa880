// An empty kernel: one block of one warp that does nothing.  Its time is
// the floor under every kernel of the port, the cost of a launch alone;
// chip_smoke.py and utils/kernel_bench.py time it beside K1, K2 and K3.
// The sampler never launches it.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int bfmmm_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
