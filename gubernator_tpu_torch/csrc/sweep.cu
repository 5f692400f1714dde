// K2: the expired-row sweep of the SoA table, fused with the live count,
// for Hopper.
//
// Replaces the TPU kernel gubernator_tpu/ops/pallas_sweep.py ›
// _sweep_kernel (pallas_call in _sweep_2d, wrapped by
// sweep_expired_pallas).  Same function: every row with
// expire_at <= now gets key = 0 and expire_at = 0, and the count of rows
// that are neither expired nor empty comes out of the same pass.
//
// Design.  The TPU kernel splits both int64 columns into hi/lo int32
// words (Mosaic has no 64-bit lanes), walks (8, 128) VMEM tiles in its
// sequential grid and carries the count in SMEM from step to step.  Here
// the columns stay native int64: a grid-stride loop reads key[i] and
// expire_at[i] with coalesced 8-byte loads (neighbouring threads,
// neighbouring rows), compares expire_at <= now as a signed 64-bit value
// (what the split-word compare computes), and writes zeros in place only
// where a dead row still holds something: the TPU kernel rewrites every
// row, the result is the same.  Blocks run in no order, so the count is
// reduced per thread, then per warp with __shfl_down_sync, then per block
// in shared memory, and added once per block with one atomicAdd on an
// unsigned 64-bit counter: exact in any block order.  Nothing is
// allocated here; the wrapper (ops/sweep.py) zeroes the counter.
//
// Bound.  Bytes: 16 B read per row (key, expire_at) plus 16 B written per
// row it reclaims, at 3.35 TB/s; 2^24 rows read 268 MB, 0.080 ms.  The
// arithmetic is one compare and one add per row.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
sweep_kernel(int64_t* __restrict__ key, int64_t* __restrict__ expire_at,
             int64_t n, int64_t now, unsigned long long* __restrict__ live) {
  unsigned long long cnt = 0;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride) {
    const int64_t x = expire_at[i];
    const int64_t k = key[i];
    if (x <= now) {
      if ((k | x) != 0) {  // an empty row is already zero
        key[i] = 0;
        expire_at[i] = 0;
      }
    } else {
      cnt += (k != 0);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
  __shared__ unsigned long long warp_sum[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sum[warp] = cnt;
  __syncthreads();
  if (warp == 0) {
    cnt = lane < WARPS ? warp_sum[lane] : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      cnt += __shfl_down_sync(0xffffffffu, cnt, off);
    if (lane == 0 && cnt) atomicAdd(live, cnt);
  }
}

}  // namespace

extern "C" {

// Launch K2 on ``stream`` over n rows.  ``live`` is one zeroed 64-bit
// counter on the device; the count of live rows is added to it.
// Returns cudaGetLastError() (0 = launched).
int guber_sweep(void* key, void* expire_at, int64_t n, int64_t now,
                void* live, void* stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // enough resident blocks to fill every SM (8 x 256 threads each), no
  // more: the grid-stride loop covers the rest of the rows
  int64_t blocks = (n + THREADS - 1) / THREADS;
  const int64_t full = (int64_t)sms * 8;
  if (blocks > full) blocks = full;
  if (blocks < 1) blocks = 1;
  sweep_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (int64_t*)key, (int64_t*)expire_at, n, now,
      (unsigned long long*)live);
  return (int)cudaGetLastError();
}

}  // extern "C"
