// K3: the toolchain probe, an int32 elementwise add, for Hopper.
//
// Replaces the TPU kernel tools/pallas_probe.py › toy.k, the trivial
// Pallas add that checks the TPU compiler can build and run anything at
// all.  Here it checks the same of nvcc, the library load and a launch,
// before the real kernels run.
//
// Bound.  Bytes: 4 B read from each input and 4 B written per element, at
// 3.35 TB/s; one add per element.  The card reaches its memory rate only
// with wide accesses and many of them in flight, so:
//
// - 16-byte accesses: each thread loads int4 vectors (four elements) of
//   x and y and stores an int4 of the sum;
// - UNROLL independent vectors per thread per step, all loads in flight
//   before the adds and stores;
// - a grid stride loop over a grid sized from the SM count: one step per
//   thread up to MAX_BLOCKS_PER_SM blocks on each SM (8,192 blocks for
//   2^24 elements on an H100's 132 SMs), more steps beyond;
// - the scalar head (elements before the first 16-byte boundary) and tail
//   (the last n % 4 after it) in the same kernel.  When x, y and out do
//   not share one offset from a 16-byte boundary, no vector lines up in
//   all three, and the same kernel walks the elements one by one.
//
// On an H100 this comes within 0.5% of torch.add on 2^24 elements; four
// vectors a thread with streaming cache hints (__ldcs / __stcs) took
// ~1.8% longer (chip_ab.py).  Fewer, longer-lived blocks (one resident
// wave) were slower still: the last step of each thread leaves SMs idle.
//
// The add is taken on uint32 so that it wraps at int32 overflow, as the
// TPU's does (signed overflow is undefined in C++).
#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 2;
constexpr int MAX_BLOCKS_PER_SM = 64;

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

__global__ void __launch_bounds__(THREADS)
add_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
           int32_t* __restrict__ out, int64_t n, int64_t head, bool vec) {
  const int64_t tid = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t nthreads = (int64_t)gridDim.x * THREADS;
  if (!vec) {
    for (int64_t i = tid; i < n; i += nthreads) out[i] = wadd(x[i], y[i]);
    return;
  }
  // scalar head and tail
  const int64_t nvec = (n - head) / 4;
  const int64_t tail = head + nvec * 4;
  if (tid < head) out[tid] = wadd(x[tid], y[tid]);
  if (tid < n - tail) out[tail + tid] = wadd(x[tail + tid], y[tail + tid]);
  // the aligned body, UNROLL vectors per thread per step
  const int4* xv = reinterpret_cast<const int4*>(x + head);
  const int4* yv = reinterpret_cast<const int4*>(y + head);
  int4* ov = reinterpret_cast<int4*>(out + head);
  const int64_t step = nthreads * UNROLL;
  for (int64_t base = (int64_t)blockIdx.x * THREADS * UNROLL + threadIdx.x;
       base < nvec; base += step) {
    int4 a[UNROLL], b[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t i = base + u * THREADS;
      if (i < nvec) {
        a[u] = xv[i];
        b[u] = yv[i];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t i = base + u * THREADS;
      if (i < nvec)
        ov[i] = make_int4(wadd(a[u].x, b[u].x), wadd(a[u].y, b[u].y),
                          wadd(a[u].z, b[u].z), wadd(a[u].w, b[u].w));
    }
  }
}

// Each device's SM count, read once (0: not read yet).
constexpr int MAX_DEVICES = 64;
std::atomic<int> sm_count[MAX_DEVICES];

cudaError_t device_sms(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const int known = dev < MAX_DEVICES
      ? sm_count[dev].load(std::memory_order_relaxed) : 0;
  if (known > 0) {
    *sms = known;
    return e;
  }
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && dev < MAX_DEVICES)
    sm_count[dev].store(*sms, std::memory_order_relaxed);
  return e;
}

}  // namespace

extern "C" {

// Launch K3 on ``stream``: out = x + y over n int32 elements.
// Returns cudaGetLastError() (0 = launched).
int guber_probe_add(const void* x, const void* y, void* out, int64_t n,
                    void* stream) {
  int sms = 0;
  const cudaError_t e = device_sms(&sms);
  if (e != cudaSuccess) return (int)e;
  const uintptr_t mis = (uintptr_t)x & 15;
  const bool vec = ((uintptr_t)y & 15) == mis && ((uintptr_t)out & 15) == mis;
  int64_t head = vec ? (int64_t)((16 - mis) & 15) / 4 : 0;
  if (head > n) head = n;
  // one step per thread, at most MAX_BLOCKS_PER_SM blocks on each SM
  const int64_t per_block = vec ? (int64_t)THREADS * UNROLL * 4 : THREADS;
  int64_t blocks = (n + per_block - 1) / per_block;
  const int64_t most = (int64_t)sms * MAX_BLOCKS_PER_SM;
  if (blocks > most) blocks = most;
  if (blocks < 1) blocks = 1;
  add_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, (int32_t*)out, n, head, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
