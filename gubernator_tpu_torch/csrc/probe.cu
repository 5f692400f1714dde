// K3: the toolchain probe, an int32 elementwise add, for Hopper.
//
// Replaces the TPU kernel tools/pallas_probe.py › toy.k, the trivial
// Pallas add that checks the TPU compiler can build and run anything at
// all.  Here it checks the same of nvcc, the library load and a launch,
// before the real kernels run.
//
// Design.  One thread per element in a grid-stride loop, coalesced 4-byte
// loads and stores.  The add is taken on uint32 so that it wraps at
// int32 overflow, as the TPU's does (signed overflow is undefined in C++).
//
// Bound.  Bytes: 4 B read from each input and 4 B written per element, at
// 3.35 TB/s; one add per element.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
add_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
           int32_t* __restrict__ out, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride)
    out[i] = (int32_t)((uint32_t)x[i] + (uint32_t)y[i]);
}

}  // namespace

extern "C" {

// Launch K3 on ``stream``: out = x + y over n int32 elements.
// Returns cudaGetLastError() (0 = launched).
int guber_probe_add(const void* x, const void* y, void* out, int64_t n,
                    void* stream) {
  int64_t blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 65535) blocks = 65535;
  if (blocks < 1) blocks = 1;
  add_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, (int32_t*)out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
