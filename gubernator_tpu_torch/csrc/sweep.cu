// K2: the expired-row sweep of the SoA table, fused with the live count,
// for Hopper.
//
// Replaces the TPU kernel gubernator_tpu/ops/pallas_sweep.py ›
// _sweep_kernel (pallas_call in _sweep_2d, wrapped by
// sweep_expired_pallas).  Same function: every row with
// expire_at <= now gets key = 0 and expire_at = 0, and the count of rows
// that are neither expired nor empty comes out of the same pass.  The
// TPU kernel splits both int64 columns into hi/lo int32 words (Mosaic
// has no 64-bit lanes), walks (8, 128) VMEM tiles in its sequential grid
// and carries the count in SMEM from step to step.  Here the columns
// stay native int64 and the compare is a signed 64-bit one (what the
// split-word compare computes).
//
// Bound.  Bytes: 16 B read per row (key, expire_at) plus 16 B written per
// row it reclaims (dead and not empty), at 3.35 TB/s.  On chip_smoke.py's
// phase 6 table (2^24 rows, 2,963,467 reclaimed) that is 16 B x
// (16,777,216 + 2,963,467) = 316 MB, 0.0943 ms.  The arithmetic is a
// compare and an add per row.  The reclaimed rows lie where the hash
// put their keys, and a fit of the times with nothing and with
// everything expired points at write-backs in 64-byte units (not
// observed): with 18% of the rows reclaimed, ~79% of each column's
// 64-byte chunks.  On an H100 the sweep takes ~0.157 ms, which would be
// ~3 TB/s over what it then moves, the rate a pure read of both columns
// reaches (~0.089 ms, with nothing expired).
//
// Design.  A stream at the memory rate needs ~2.3 MB in flight across
// the card (3.35 TB/s x ~0.7 us), ~18 KB per SM, and wide accesses:
//
// - 16-byte vectors: each thread loads one longlong2 (two rows) of
//   expire_at and one of key per step, both before any compare: 32 B a
//   thread, ~48 KB per SM at 6 resident blocks;
// - a grid sized from the SM count (read once per device): one step per
//   thread up to BLOCKS_PER_SM blocks on each SM, more steps beyond
//   (~4 on 2^24 rows);
// - zeros are written only where a dead row still holds something (the
//   TPU kernel rewrites every row, which would move 537 MB here): one
//   16-byte store per column where both rows of a vector change, row by
//   row where one does;
// - the scalar head (one row, when the bases sit 8 bytes past a 16-byte
//   boundary) and tail (the last row of an odd body) in the same kernel.
//   When key and expire_at sit at different offsets from a 16-byte
//   boundary no vector lines up in both, and the same kernel walks the
//   rows one by one.
//
// Measured on an H100 (chip_ab.py, PERF.md): one vector per column a
// step took ~2% less than two or four on the sweep, and 2.3% less than
// the earlier kernel's 8-byte grid-stride loop on the same arguments
// and counters (in every turn; 2.5% with nothing expired); 8,
// 16 or 32 blocks per SM with longer grid-stride loops took 1-10% more,
// streaming cache hints (__ldcs / __stcs) 26%, and a TMA design
// (cp.async.bulk into a ring of 4 shared-memory stages per block, one
// thread keeping it full) 11-23%.  nvcc 12.9 -Xptxas -v: 33 registers,
// 32 B of shared memory, no spills.
//
// The count.  Blocks run in no order, so the count is reduced per thread,
// then per warp (__reduce_add_sync), then per block in shared memory, and
// added once per block with one 64-bit atomicAdd: exact in any block
// order.  There is no memset before the launch: the wrapper (ops/sweep.py)
// keeps a ring of counters per stream, zeroed once; each launch adds
// into its slot and zeroes the next slot, which the next launch on the
// stream takes, so a count stays readable until the ring comes round to
// it.  A block counts at most a few million rows, so its sum fits 32
// bits.
#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// most blocks of the grid on each SM
constexpr int BLOCKS_PER_SM = 64;

// Row i: zeroed if dead and not empty; returns 1 if live.
__device__ __forceinline__ unsigned sweep_row(long long* key,
                                              long long* exp, int64_t i,
                                              long long now) {
  const long long x = exp[i], k = key[i];
  if (x <= now) {
    if ((k | x) != 0) {
      key[i] = 0;
      exp[i] = 0;
    }
    return 0;
  }
  return k != 0;
}

// Vector i of the aligned body (rows 2i and 2i + 1), read as k and x:
// zeroes its dead rows that are not empty; returns its live rows.
__device__ __forceinline__ unsigned sweep_pair(longlong2 k, longlong2 x,
                                               longlong2* kv, longlong2* xv,
                                               int64_t i, long long now) {
  const bool d0 = x.x <= now, d1 = x.y <= now;
  const bool w0 = d0 && (k.x | x.x) != 0;
  const bool w1 = d1 && (k.y | x.y) != 0;
  if (w0 && w1) {
    kv[i] = make_longlong2(0, 0);
    xv[i] = make_longlong2(0, 0);
  } else if (w0 || w1) {
    const int64_t r = 2 * i + w1;
    reinterpret_cast<long long*>(kv)[r] = 0;
    reinterpret_cast<long long*>(xv)[r] = 0;
  }
  return (unsigned)(!d0 && k.x != 0) + (!d1 && k.y != 0);
}

// The block's counts summed (per warp, then across warps) and added to
// ``live`` with one atomic.
__device__ __forceinline__ void add_block_count(unsigned cnt,
                                                unsigned long long* live) {
  cnt = __reduce_add_sync(0xffffffffu, cnt);
  __shared__ unsigned warp_sum[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sum[warp] = cnt;
  __syncthreads();
  if (warp == 0) {
    cnt = __reduce_add_sync(0xffffffffu, lane < WARPS ? warp_sum[lane] : 0u);
    if (lane == 0 && cnt) atomicAdd(live, (unsigned long long)cnt);
  }
}

__global__ void __launch_bounds__(THREADS)
sweep_kernel(long long* __restrict__ key, long long* __restrict__ exp,
             int64_t n, long long now, int64_t head, bool vec,
             unsigned long long* __restrict__ live,
             unsigned long long* __restrict__ clear) {
  const int64_t tid = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t nthreads = (int64_t)gridDim.x * THREADS;
  if (tid == 0) *clear = 0;  // the next launch's slot
  unsigned cnt = 0;
  if (!vec) {
    for (int64_t i = tid; i < n; i += nthreads)
      cnt += sweep_row(key, exp, i, now);
  } else {
    const int64_t nvec = (n - head) / 2;
    const int64_t tail = head + nvec * 2;
    if (tid < head) cnt += sweep_row(key, exp, tid, now);
    if (tid < n - tail) cnt += sweep_row(key, exp, tail + tid, now);
    longlong2* kv = reinterpret_cast<longlong2*>(key + head);
    longlong2* xv = reinterpret_cast<longlong2*>(exp + head);
    for (int64_t i = tid; i < nvec; i += nthreads) {
      const longlong2 x = xv[i], k = kv[i];
      cnt += sweep_pair(k, x, kv, xv, i, now);
    }
  }
  add_block_count(cnt, live);
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

// Launch K2 on ``stream`` over n rows: the count of live rows is added to
// the 64-bit counter ``live``, and the counter ``clear`` is zeroed (the
// next launch's ``live``).  Returns cudaGetLastError() (0 = launched).
int guber_sweep(void* key, void* expire_at, int64_t n, int64_t now,
                void* live, void* clear, void* stream) {
  int sms = 0;
  const cudaError_t e = device_sms(&sms);
  if (e != cudaSuccess) return (int)e;
  // int64 columns sit 0 or 8 bytes past a 16-byte boundary
  const uintptr_t mis = (uintptr_t)key & 15;
  const bool vec = ((uintptr_t)expire_at & 15) == mis;
  const int64_t head = vec && mis && n > 0 ? 1 : 0;
  // one step per thread, at most BLOCKS_PER_SM blocks on each SM
  const int64_t per_block = vec ? 2 * THREADS : THREADS;
  int64_t blocks = (n + per_block - 1) / per_block;
  const int64_t most = (int64_t)sms * BLOCKS_PER_SM;
  if (blocks > most) blocks = most;
  if (blocks < 1) blocks = 1;
  sweep_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (long long*)key, (long long*)expire_at, n, (long long)now, head, vec,
      (unsigned long long*)live, (unsigned long long*)clear);
  return (int)cudaGetLastError();
}

}  // extern "C"
