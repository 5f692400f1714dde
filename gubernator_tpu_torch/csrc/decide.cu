// K1: the TOKEN / LEAKY decision step over the bucketized table, for Hopper.
//
// Replaces the TPU kernel gubernator_tpu/ops/pallas_step.py › _kernel
// (pallas_call in _call_kernel, wrapped by decide_batch_pallas_impl).
//
// Design.  The TPU kernel gets batch order for free from Pallas'
// sequential grid plus an in-tile serial loop over a host-built dedup
// map.  GPU blocks run in no order, but requests interact only within a
// bucket: the wrapper (ops/decide.py) sorts the live rows stably by
// bucket, and here ONE THREAD OWNS ONE DISTINCT BUCKET.  It loads the
// bucket's 8 slots (the 16 used words of each) once, walks its segment
// of requests in batch order applying the exact transition of the TPU
// kernel, writes each request's outputs, and stores the bucket back once.
// No two threads touch the same bucket, so nothing is atomic and the
// result does not depend on scheduling.  A hot (Zipf) bucket is one long
// serial chain in one thread: correct, and its time is recorded in
// PERF.md; spreading it is later work.
//
// Arithmetic is native int64 / uint64 where the TPU kernel used paired
// int32 words (_add64, _ge64, _umul32x32, _udiv64_32); inside the domain
// (counters < 2^30, leaky eff in [1, 2^31)) the results are bit-identical.
// Every divisor is guarded with max(d, 1): the TPU's restoring division is
// total and its garbage is selected away, whereas x / 0 traps here.
//
// Bound.  Bytes: each distinct bucket touched is read and written once,
// and only its 16 used words move (2 x 8 slots x 64 B), plus 76 B of
// packed request columns in and 29 B of outputs per request, at
// 3.35 TB/s.  The arithmetic is a few dozen integer operations per
// request, far below the memory bound.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SLOTS = 8;
constexpr int WORDS = 32;
constexpr int USED = 16;  // words 16..31 are reserved: never touched

// row word layout (core/table.py)
constexpr int W_KLO = 0, W_KHI = 1, W_REM = 2, W_STATUS = 3, W_LIMIT = 4;
constexpr int W_TLO = 5, W_THI = 6, W_XLO = 7, W_XHI = 8;
constexpr int W_ELO = 9, W_EHI = 10, W_DLO = 11, W_DHI = 12;
constexpr int W_ALG = 13, W_TDLO = 14, W_TDHI = 15;

// rows of the [N_REQ, B] request matrix (ops/decide.py R_*)
enum { R_KEY, R_HITS, R_LIMIT, R_DUR, R_EFF, R_GREG, R_NOW, R_BEH, R_ALG,
       R_HTD, R_CAP, R_RST, R_RATE, R_GD, N_REQ };
// rows of the [N_OUT, B] output matrix (ops/decide.py O_*)
enum { O_STATUS, O_REM, O_RESET, O_LIMIT, O_FLAGS, N_OUT };

constexpr int64_t B_GREG = 4, B_RESET = 8, B_DRAIN = 32;

__device__ __forceinline__ int64_t join64(int32_t hi, int32_t lo) {
  return (int64_t)(((uint64_t)(uint32_t)hi << 32) | (uint64_t)(uint32_t)lo);
}
__device__ __forceinline__ int32_t lo32(int64_t x) {
  return (int32_t)(uint32_t)(uint64_t)x;
}
__device__ __forceinline__ int32_t hi32(int64_t x) {
  return (int32_t)(uint32_t)((uint64_t)x >> 32);
}
// wrapping add / sub / mul: signed overflow is undefined in C++
__device__ __forceinline__ int64_t add64(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a + (uint64_t)b);
}
__device__ __forceinline__ int64_t sub64(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a - (uint64_t)b);
}
__device__ __forceinline__ int64_t mul64(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a * (uint64_t)b);
}
// floor division for the non-negative dividends of the domain; the
// divisor is guarded so a discarded lane never traps
__device__ __forceinline__ int64_t div64(int64_t n, int64_t d) {
  const int64_t g = d > 1 ? d : 1;
  const int64_t q = n / g;
  return (n % g != 0 && n < 0) ? q - 1 : q;
}
__device__ __forceinline__ int64_t mod64(int64_t n, int64_t d) {
  const int64_t g = d > 1 ? d : 1;
  return sub64(n, mul64(div64(n, g), g));
}
__device__ __forceinline__ void put64(int32_t* s, int whi, int wlo,
                                      int64_t v) {
  s[whi] = hi32(v);
  s[wlo] = lo32(v);
}

// One request against the thread's bucket image w[SLOTS * USED].
__device__ void apply(int32_t* w, const int64_t* req, int64_t B, int64_t r,
                      int64_t* out) {
  const int64_t key = req[R_KEY * B + r];
  const int64_t hits = req[R_HITS * B + r];
  const int64_t r_lim = req[R_LIMIT * B + r];
  const int64_t r_dur = req[R_DUR * B + r];
  const int64_t r_eff = req[R_EFF * B + r];
  const int64_t r_greg = req[R_GREG * B + r];
  const int64_t now0 = req[R_NOW * B + r];
  const int64_t beh = req[R_BEH * B + r];
  const int64_t r_alg = req[R_ALG * B + r];
  const int32_t klo = lo32(key), khi = hi32(key);

  // key match, else the first empty slot, else err (bucket full)
  int mslot = -1, eslot = -1;
#pragma unroll
  for (int s = SLOTS - 1; s >= 0; --s) {
    const int32_t a = w[s * USED + W_KLO], b = w[s * USED + W_KHI];
    if (a == klo && b == khi) mslot = s;
    if (a == 0 && b == 0) eslot = s;
  }
  const bool found = mslot >= 0;
  const bool err = !found && eslot < 0;
  const bool insert = !found && !err;
  const int slot = found ? mslot : (err ? 0 : eslot);
  int32_t* sw = w + slot * USED;

  int32_t it[USED];
#pragma unroll
  for (int k = 0; k < USED; ++k) it[k] = err ? 0 : sw[k];
  const int64_t it_rem = it[W_REM], it_status = it[W_STATUS];
  const int64_t it_limit = it[W_LIMIT], it_alg = it[W_ALG];
  const int64_t it_t = join64(it[W_THI], it[W_TLO]);
  const int64_t it_x = join64(it[W_XHI], it[W_XLO]);
  const int64_t it_eff = join64(it[W_EHI], it[W_ELO]);
  const int64_t it_dur = join64(it[W_DHI], it[W_DLO]);
  const int64_t it_td = join64(it[W_TDHI], it[W_TDLO]);

  const bool is_greg = (beh & B_GREG) != 0;
  const bool reset = (beh & B_RESET) != 0;
  const bool drain = (beh & B_DRAIN) != 0;
  const bool is_query = hits == 0;

  const int64_t now1 = now0 >= it_t ? now0 : it_t;  // per-key clock
  const bool fresh0 = !found || now1 >= it_x || it_alg != r_alg;

  int64_t st = 0, rem = 0, rst = 0;
  if (r_alg == 0) {
    // ---- TOKEN_BUCKET
    const bool dur_change = !fresh0 && r_dur != it_dur;
    const int64_t ne = is_greg ? r_greg : add64(it_t, r_eff);
    const int64_t x1 = dur_change ? ne : it_x;
    const bool fresh = fresh0 || (dur_change && now1 >= x1);
    const int64_t xf = is_greg ? r_greg : add64(now1, r_eff);
    const int64_t limit0 = fresh ? r_lim : it_limit;
    int64_t rem0 = fresh ? r_lim : it_rem;
    const int64_t t = fresh ? now1 : it_t;
    const int64_t x = fresh ? xf : x1;
    int64_t status0 = fresh ? 0 : it_status;
    const int64_t e = (fresh || dur_change) ? r_eff : it_eff;
    const bool reset_live = reset && !fresh;
    if (reset_live) {
      rem0 = r_lim;
      status0 = 0;
    }
    const int64_t limit_ar = reset_live ? r_lim : limit0;
    if (r_lim != limit_ar) {  // limit change in place
      int64_t adj = rem0 + r_lim - limit_ar;
      adj = adj < 0 ? 0 : adj;
      rem0 = adj < r_lim ? adj : r_lim;
    }
    const bool ok = hits <= rem0;
    int64_t rem2 = rem0;
    if (!is_query && ok) rem2 = rem0 - hits;
    if (!is_query && !ok && drain) rem2 = 0;
    const int64_t status1 = is_query ? status0 : (ok ? 0 : 1);
    if (!err) {
      sw[W_KLO] = klo;
      sw[W_KHI] = khi;
      sw[W_REM] = (int32_t)rem2;
      sw[W_STATUS] = (int32_t)status1;
      sw[W_LIMIT] = (int32_t)r_lim;
      put64(sw, W_THI, W_TLO, t);
      put64(sw, W_XHI, W_XLO, x);
      put64(sw, W_EHI, W_ELO, e);
      put64(sw, W_DHI, W_DLO, r_dur);
      sw[W_ALG] = 0;
      sw[W_TDLO] = 0;
      sw[W_TDHI] = 0;
    }
    st = status1;
    rem = rem2;
    rst = x;
  } else if (r_alg == 1) {
    // ---- LEAKY_BUCKET: remaining kept as td = remaining x eff
    const int64_t r_htd = req[R_HTD * B + r];
    const int64_t r_cap = req[R_CAP * B + r];
    const int64_t r_rst = req[R_RST * B + r];
    const int64_t r_rate = req[R_RATE * B + r];
    const int64_t r_gd = req[R_GD * B + r];
    // denominator change: rescale td to the new eff, keeping the fraction
    const bool eff_change = !fresh0 && r_eff != it_eff;
    int64_t td0 = it_td;
    if (eff_change) {
      const int64_t whole = div64(it_td, it_eff);
      const int64_t fracr = mod64(it_td, it_eff);
      td0 = add64(mul64(whole, r_eff), div64(mul64(fracr, r_eff), it_eff));
    }
    int64_t status0 = it_status;
    int64_t t0 = it_t;
    if (fresh0) {  // fresh adoption: the bucket starts full
      td0 = r_cap;
      status0 = 0;
      t0 = now1;
    }
    if (reset && !fresh0) {
      td0 = r_rst;
      status0 = 0;
    }
    // replenish elapsed x limit, clamped to the cap; past TD_BOUND//limit
    // the product already exceeds the cap
    const int64_t el = sub64(now1, t0);
    const bool over_g = el > r_gd;
    const int64_t s = add64(td0, mul64(over_g ? r_gd : el, r_lim));
    const int64_t rp = (over_g || s >= r_cap) ? r_cap : s;
    const bool ok = rp >= r_htd;
    int64_t td2 = rp;
    if (!is_query && ok) td2 = sub64(rp, r_htd);
    if (!is_query && !ok && drain) td2 = 0;
    const int64_t status1 = is_query ? status0 : (ok ? 0 : 1);
    if (!err) {
      sw[W_KLO] = klo;
      sw[W_KHI] = khi;
      sw[W_REM] = 0;
      sw[W_STATUS] = (int32_t)status1;
      sw[W_LIMIT] = (int32_t)r_lim;
      put64(sw, W_THI, W_TLO, now1);
      put64(sw, W_XHI, W_XLO, add64(now1, r_eff));
      put64(sw, W_EHI, W_ELO, r_eff);
      put64(sw, W_DHI, W_DLO, r_dur);
      sw[W_ALG] = 1;
      put64(sw, W_TDHI, W_TDLO, td2);
    }
    st = status1;
    rem = div64(td2, r_eff);  // whole tokens
    rst = add64(now1, r_rate);  // now + eff//limit, not the stored expiry
  }
  // err rows: outputs zero, only the err flag
  out[O_STATUS * B + r] = err ? 0 : st;
  out[O_REM * B + r] = err ? 0 : rem;
  out[O_RESET * B + r] = err ? 0 : rst;
  out[O_LIMIT * B + r] = err ? 0 : r_lim;
  out[O_FLAGS * B + r] = err ? 1 : (insert ? 2 : 0);
}

__global__ void __launch_bounds__(128)
decide_kernel(int32_t* __restrict__ table, const int64_t* __restrict__ req,
              const int64_t* __restrict__ order,
              const int64_t* __restrict__ seg_bucket,
              const int64_t* __restrict__ seg_start,
              const int64_t* __restrict__ seg_len, int64_t S, int64_t B,
              int64_t* __restrict__ out) {
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  // the bucket's 8 slots: words 0..15 of each 128 B row, as 4 x int4
  int4* rowp = reinterpret_cast<int4*>(table + seg_bucket[s] * SLOTS * WORDS);
  alignas(16) int32_t w[SLOTS * USED];
  int4* wv = reinterpret_cast<int4*>(w);
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {
#pragma unroll
    for (int v = 0; v < USED / 4; ++v) wv[k * USED / 4 + v] =
        rowp[k * WORDS / 4 + v];
  }
  const int64_t start = seg_start[s], len = seg_len[s];
  for (int64_t j = 0; j < len; ++j) apply(w, req, B, order[start + j], out);
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {
#pragma unroll
    for (int v = 0; v < USED / 4; ++v) rowp[k * WORDS / 4 + v] =
        wv[k * USED / 4 + v];
  }
}

}  // namespace

extern "C" {

// Launch K1 on ``stream``: S distinct buckets, B requests.  All pointers
// are device pointers from the wrapper; nothing is allocated here.
// Returns cudaGetLastError() (0 = launched).
int guber_decide(void* table, const void* req, const void* order,
                 const void* seg_bucket, const void* seg_start,
                 const void* seg_len, int64_t S, int64_t B, void* out,
                 void* stream) {
  constexpr int threads = 128;
  const int64_t blocks = (S + threads - 1) / threads;
  decide_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (int32_t*)table, (const int64_t*)req, (const int64_t*)order,
      (const int64_t*)seg_bucket, (const int64_t*)seg_start,
      (const int64_t*)seg_len, S, B, (int64_t*)out);
  return (int)cudaGetLastError();
}

const char* guber_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
