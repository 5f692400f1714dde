// K1: the TOKEN / LEAKY decision step over the bucketized table, for Hopper.
//
// Replaces the TPU kernel gubernator_tpu/ops/pallas_step.py › _kernel
// (pallas_call in _call_kernel, wrapped by decide_batch_pallas_impl).
//
// Order.  The TPU kernel gets batch order from Pallas' sequential grid
// plus an in-tile serial loop.  Here requests interact only within a
// bucket: the wrapper (ops/decide.py) sorts the live rows stably by
// bucket and hands over each distinct bucket's segment, in batch order,
// longest first.  Every segment has one owner, so nothing is atomic and
// the result does not depend on scheduling.
//
// What bounds it on this card.  The bytes are tiny: each touched bucket
// read and written once (16 used words of 8 slots) plus, per request, the
// step's 76 B of packed request columns in and 29 B of outputs
// (chip_smoke.py's bytes bound), ~1.4 us for an 8192-row wave at
// 3.35 TB/s.  The kernel itself moves more: the wrapper widens the
// request to 14 int64 columns (112 B) and the outputs to 5 (40 B), so
// its per-request traffic is 152 B against the 105 B that bound counts.
// Either way the bytes take microseconds.  What is left is (a) the
// serial chain of the longest segment: under Zipf(1.1) one bucket holds
// ~11% of a wave, and walking it one request after another, each behind
// a dependent global load, cost ~0.75 ms; and (b) the launch (a few us).
// The design:
//
// - One grid, two roles.  Blocks [0, n_hot) each own segment blockIdx.x
//   if it is longer than `hot` (ops/decide.py HOT_SEGMENT); the rest of
//   the grid gives one thread to each segment of at most `hot` requests.
//   The hot blocks come first, so the longest segment's block is the
//   first one scheduled.  (Two kernels, the cold one without shared
//   memory, and one grid with the cold blocks first, both measured
//   slower on an H100: chip_ab.py, PERF.md.)
// - Cold thread: the 8 slot keys live in registers, the request's slot
//   is resolved first, and only that slot's 16 words are carried in
//   registers (written back when the thread moves to another slot).
//   The next request's columns are loaded while this one is applied.
// - Hot block, 8 warps, one per slot.  Tiles of TILE requests are staged
//   into shared memory with cp.async, gathered through `order`, double
//   buffered so the next tile is in flight while this one is walked.
//   Slots are resolved in parallel: nothing frees a slot during a wave,
//   so the k-th new key (by first occurrence among requests that write)
//   takes the k-th empty slot, and the keys past the empty slots err.
//   Each warp then walks its slot's chain with the slot's words in
//   registers.  A request that differs from the previous one of its
//   chain in any request column (or carries RESET / DRAIN) is applied
//   with the full transition; the rest of a run takes a closed form,
//   32 requests at a time across the lanes (TOKEN while no request
//   reaches the window end x; LEAKY while every request's now is the
//   slot's clock).  Outputs go to shared memory, and the block writes a
//   tile's outputs (and LEAKY's 64-bit division) in parallel.  The slot
//   is written back once, at the end.
//
// Arithmetic is native int64 / uint64 where the TPU kernel used paired
// int32 words (_add64, _ge64, _umul32x32, _udiv64_32); inside the domain
// (counters < 2^30, leaky eff in [1, 2^31)) the results are bit-identical.
// Every divisor is guarded with max(d, 1): the TPU's restoring division is
// total and its garbage is selected away, whereas x / 0 traps here.  The
// closed forms are taken only where the state and the requests satisfy
// the conditions under which they equal the transition applied request
// by request; anywhere else the transition is applied.
#include <atomic>
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
// the stats counters (ops/decide.py K1_STATS)
enum { ST_HOT_SEGMENTS, ST_SERIAL, ST_CLOSED_FORM, ST_LONGEST_CHAIN, ST_COLD,
       N_STATS };

constexpr int64_t B_GREG = 4, B_RESET = 8, B_DRAIN = 32;

// hot path: requests per shared-memory tile = threads per block
constexpr int TILE = 256;
constexpr int THREADS = TILE;
constexpr int WARPS = THREADS / 32;
static_assert(WARPS == SLOTS, "one warp per slot");
// the staged request columns: [2 buffers][N_REQ][TILE] int64
constexpr int DYN_SMEM = 2 * N_REQ * TILE * (int)sizeof(int64_t);
constexpr unsigned FULL = 0xffffffffu;

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
__device__ __forceinline__ void put64(int32_t (&s)[USED], int whi, int wlo,
                                      int64_t v) {
  s[whi] = hi32(v);
  s[wlo] = lo32(v);
}

// A slot's 16 used words: 4 x int4 of its 128 B row.
__device__ __forceinline__ void load_words(const int32_t* p,
                                           int32_t (&w)[USED]) {
  const int4* v = reinterpret_cast<const int4*>(p);
#pragma unroll
  for (int k = 0; k < USED / 4; ++k) {
    const int4 x = v[k];
    w[4 * k] = x.x;
    w[4 * k + 1] = x.y;
    w[4 * k + 2] = x.z;
    w[4 * k + 3] = x.w;
  }
}
__device__ __forceinline__ void store_words(int32_t* p,
                                            const int32_t (&w)[USED]) {
  int4* v = reinterpret_cast<int4*>(p);
#pragma unroll
  for (int k = 0; k < USED / 4; ++k)
    v[k] = make_int4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
}

struct Req {
  int64_t c[N_REQ];
};

__device__ __forceinline__ Req load_req(const int64_t* req, int64_t B,
                                        int64_t r) {
  Req q;
#pragma unroll
  for (int k = 0; k < N_REQ; ++k) q.c[k] = req[k * B + r];
  return q;
}

__device__ __forceinline__ bool writes(int64_t alg) {
  return alg == 0 || alg == 1;
}

// What a request answers before the err mask: status, raw (TOKEN's
// remaining, LEAKY's td: the caller takes td // eff) and reset time.
struct Res {
  int64_t st, raw, rst;
};

// One request against its slot's words w (in registers).  found: the
// slot held the request's key before it; else the slot was empty and
// the request claims it.  Never called for a request that errs.
__device__ __forceinline__ Res transition(int32_t (&w)[USED], const Req& q,
                                          bool found) {
  const int64_t key = q.c[R_KEY];
  const int64_t hits = q.c[R_HITS];
  const int64_t r_lim = q.c[R_LIMIT];
  const int64_t r_dur = q.c[R_DUR];
  const int64_t r_eff = q.c[R_EFF];
  const int64_t r_greg = q.c[R_GREG];
  const int64_t now0 = q.c[R_NOW];
  const int64_t beh = q.c[R_BEH];
  const int64_t r_alg = q.c[R_ALG];
  const int32_t klo = lo32(key), khi = hi32(key);

  const int64_t it_rem = w[W_REM], it_status = w[W_STATUS];
  const int64_t it_limit = w[W_LIMIT], it_alg = w[W_ALG];
  const int64_t it_t = join64(w[W_THI], w[W_TLO]);
  const int64_t it_x = join64(w[W_XHI], w[W_XLO]);
  const int64_t it_eff = join64(w[W_EHI], w[W_ELO]);
  const int64_t it_dur = join64(w[W_DHI], w[W_DLO]);
  const int64_t it_td = join64(w[W_TDHI], w[W_TDLO]);

  const bool is_greg = (beh & B_GREG) != 0;
  const bool reset = (beh & B_RESET) != 0;
  const bool drain = (beh & B_DRAIN) != 0;
  const bool is_query = hits == 0;

  const int64_t now1 = now0 >= it_t ? now0 : it_t;  // per-key clock
  const bool fresh0 = !found || now1 >= it_x || it_alg != r_alg;

  Res o = {0, 0, 0};
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
    w[W_KLO] = klo;
    w[W_KHI] = khi;
    w[W_REM] = (int32_t)rem2;
    w[W_STATUS] = (int32_t)status1;
    w[W_LIMIT] = (int32_t)r_lim;
    put64(w, W_THI, W_TLO, t);
    put64(w, W_XHI, W_XLO, x);
    put64(w, W_EHI, W_ELO, e);
    put64(w, W_DHI, W_DLO, r_dur);
    w[W_ALG] = 0;
    w[W_TDLO] = 0;
    w[W_TDHI] = 0;
    o.st = status1;
    o.raw = rem2;
    o.rst = x;
  } else if (r_alg == 1) {
    // ---- LEAKY_BUCKET: remaining kept as td = remaining x eff
    const int64_t r_htd = q.c[R_HTD];
    const int64_t r_cap = q.c[R_CAP];
    const int64_t r_rst = q.c[R_RST];
    const int64_t r_rate = q.c[R_RATE];
    const int64_t r_gd = q.c[R_GD];
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
    w[W_KLO] = klo;
    w[W_KHI] = khi;
    w[W_REM] = 0;
    w[W_STATUS] = (int32_t)status1;
    w[W_LIMIT] = (int32_t)r_lim;
    put64(w, W_THI, W_TLO, now1);
    put64(w, W_XHI, W_XLO, add64(now1, r_eff));
    put64(w, W_EHI, W_ELO, r_eff);
    put64(w, W_DHI, W_DLO, r_dur);
    w[W_ALG] = 1;
    put64(w, W_TDHI, W_TDLO, td2);
    o.st = status1;
    o.raw = td2;
    o.rst = add64(now1, r_rate);  // now + eff//limit, not the stored expiry
  }
  return o;
}

// A request's five outputs; err rows get zeros and only the err flag.
__device__ __forceinline__ void write_out(int64_t* out, int64_t B, int64_t r,
                                          int64_t alg, int64_t eff,
                                          int64_t lim, Res o, int flag) {
  const bool err = (flag & 1) != 0;
  out[O_STATUS * B + r] = err ? 0 : o.st;
  out[O_REM * B + r] = err ? 0 : (alg == 1 ? div64(o.raw, eff) : o.raw);
  out[O_RESET * B + r] = err ? 0 : o.rst;
  out[O_LIMIT * B + r] = err ? 0 : lim;
  out[O_FLAGS * B + r] = flag;
}

// ---- cold: one thread walks a short segment ----------------------------

__device__ __forceinline__ void cold_segment(
    int32_t* __restrict__ table, const int64_t* __restrict__ req,
    const int64_t* __restrict__ order, int64_t bucket, int64_t start,
    int64_t len, int64_t B, int64_t* __restrict__ out) {
  int32_t* row = table + bucket * SLOTS * WORDS;
  int32_t klo[SLOTS], khi[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int2 k = *reinterpret_cast<const int2*>(row + s * WORDS);
    klo[s] = k.x;
    khi[s] = k.y;
  }
  int cur = -1;  // the slot whose words w holds
  int32_t w[USED];
  int64_t r = order[start];
  Req q = load_req(req, B, r);
  for (int64_t j = 0; j < len; ++j) {
    // the next request's columns load while this one is applied
    int64_t r_next = r;
    Req nq = q;
    if (j + 1 < len) {
      r_next = order[start + j + 1];
      nq = load_req(req, B, r_next);
    }
    // key match, else the first empty slot, else err (bucket full)
    const int32_t ql = lo32(q.c[R_KEY]), qh = hi32(q.c[R_KEY]);
    int mslot = -1, eslot = -1;
#pragma unroll
    for (int s = SLOTS - 1; s >= 0; --s) {
      if (klo[s] == ql && khi[s] == qh) mslot = s;
      if (klo[s] == 0 && khi[s] == 0) eslot = s;
    }
    const bool found = mslot >= 0;
    const bool err = !found && eslot < 0;
    Res o = {0, 0, 0};
    if (!err) {
      const int slot = found ? mslot : eslot;
      if (slot != cur) {
        if (cur >= 0) store_words(row + cur * WORDS, w);
        load_words(row + slot * WORDS, w);
        cur = slot;
      }
      o = transition(w, q, found);
      if (!found && writes(q.c[R_ALG])) {
#pragma unroll
        for (int s = 0; s < SLOTS; ++s) {
          if (s == slot) {
            klo[s] = ql;
            khi[s] = qh;
          }
        }
      }
    }
    write_out(out, B, r, q.c[R_ALG], q.c[R_EFF], q.c[R_LIMIT], o,
              err ? 1 : (found ? 0 : 2));
    r = r_next;
    q = nq;
  }
  if (cur >= 0) store_words(row + cur * WORDS, w);
}

// ---- hot: one block walks a long segment -------------------------------

struct HotShared {
  int64_t oraw[TILE], orst[TILE], ost[TILE];  // outputs before the err mask
  int64_t key[SLOTS];            // slot keys (new keys added tile by tile)
  int32_t r[2][TILE];            // batch row of each staged request
  int32_t wsum[WARPS];           // new keys per warp (block scan)
  int32_t empty[SLOTS];          // initially empty slots, ascending
  int32_t nempty;
  int8_t tslot[TILE];            // chain (slot) of a request, -1: none
  int8_t flag[TILE];             // O_FLAGS: 0, 1 err, 2 insert
  uint8_t list[SLOTS][TILE];     // each slot's chain in this tile
  uint8_t brk[SLOTS][TILE];      // the chain's request starts a run
};

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Thread tid stages request `idx` of the segment (batch row r) into
// buffer b.  Every thread commits a group, empty or not.
__device__ __forceinline__ void stage(int64_t* cols, HotShared& sm, int b,
                                      const int64_t* __restrict__ req,
                                      int64_t B, bool live, int64_t r) {
  if (live) {
    const int tid = threadIdx.x;
    sm.r[b][tid] = (int32_t)r;
    int64_t* dst = cols + (int64_t)b * N_REQ * TILE + tid;
#pragma unroll
    for (int k = 0; k < N_REQ; ++k) cp_async8(dst + k * TILE, req + k * B + r);
  }
  cp_async_commit();
}

// The closed form over the run that continues at chain position i: how
// many requests it took (0 when the conditions fail at position i).
// col: the tile's columns; list / brk: this warp's chain.
__device__ __forceinline__ int closed_run(int32_t (&w)[USED],
                                          const int64_t* col,
                                          HotShared& sm, int i, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pi = sm.list[warp][i];
  // the run's columns (equal for every request of the run)
  const int64_t alg = col[R_ALG * TILE + pi];
  const int64_t hits = col[R_HITS * TILE + pi];
  const int64_t lim = col[R_LIMIT * TILE + pi];
  const int64_t dur = col[R_DUR * TILE + pi];
  const int64_t eff = col[R_EFF * TILE + pi];
  const int64_t t = join64(w[W_THI], w[W_TLO]);
  const int64_t x = join64(w[W_XHI], w[W_XLO]);
  // the words the transition would rewrite already hold what it writes
  bool u = (int64_t)w[W_LIMIT] == lim
      && join64(w[W_DHI], w[W_DLO]) == dur;
  if (alg == 0) {
    u = u && w[W_ALG] == 0 && w[W_TDLO] == 0 && w[W_TDHI] == 0
        && hits >= 0;
  } else if (alg == 1) {
    const int64_t htd = col[R_HTD * TILE + pi];
    u = u && w[W_ALG] == 1 && w[W_REM] == 0
        && join64(w[W_EHI], w[W_ELO]) == eff && x == add64(t, eff) && t < x
        && col[R_GD * TILE + pi] >= 0 && (hits == 0 || htd > 0);
  } else {
    u = false;
  }
  if (!u) return 0;
  // lane l takes chain position i + l while the run lasts and its now
  // keeps the slot clean: TOKEN below x (no fresh window), LEAKY at the
  // slot's clock (nothing to replenish)
  const int k = i + lane;
  bool ok = k < n && (lane == 0 || !sm.brk[warp][k]);
  int p = pi;
  if (ok) {
    p = sm.list[warp][k];
    const int64_t now0 = col[R_NOW * TILE + p];
    ok = alg == 0 ? (now0 >= t ? now0 : t) < x : now0 <= t;
  }
  const unsigned bad = __ballot_sync(FULL, !ok);
  const int m = bad ? __ffs(bad) - 1 : 32;
  if (m == 0) return 0;
  const int64_t j = lane + 1;  // the lane's place in the run
  int64_t st, raw, rst, base, cost;
  const int64_t st0 = w[W_STATUS];
  if (alg == 0) {
    base = w[W_REM];
    cost = hits;
    rst = x;
  } else {
    const int64_t cap = col[R_CAP * TILE + pi];
    const int64_t td = join64(w[W_TDHI], w[W_TDLO]);
    base = td >= cap ? cap : td;  // the first request clamps to the cap
    cost = col[R_HTD * TILE + pi];
    rst = add64(t, col[R_RATE * TILE + pi]);
  }
  int64_t end_raw = base, end_st = st0;
  if (hits == 0) {  // queries: nothing consumed, the status carried
    st = st0;
    raw = base;
  } else {
    // request j is admitted while j x cost <= base: a prefix of the run,
    // whose length kk counts the admitted lanes (no division; the
    // product is taken in 128 bits)
    const bool adm = base >= 0 && __umul64hi((uint64_t)cost, (uint64_t)j) == 0
        && (uint64_t)cost * (uint64_t)j <= (uint64_t)base;
    const int64_t kk = __popc(__ballot_sync(FULL, adm && lane < m));
    st = adm ? 0 : 1;
    raw = base - cost * (adm ? j : kk);
    end_st = kk == m ? 0 : 1;
    end_raw = base - cost * kk;
  }
  if (lane < m) {
    sm.ost[p] = st;
    sm.oraw[p] = raw;
    sm.orst[p] = rst;
  }
  w[W_STATUS] = (int32_t)end_st;
  if (alg == 0) w[W_REM] = (int32_t)end_raw;
  else put64(w, W_TDHI, W_TDLO, end_raw);
  return m;
}

__device__ __forceinline__ void hot_segment(
    int32_t* __restrict__ table, const int64_t* __restrict__ req,
    const int64_t* __restrict__ order, int64_t bucket, int64_t start,
    int64_t len, int64_t B, unsigned long long* stats,
    int64_t* __restrict__ out) {
  __shared__ HotShared sm;
  extern __shared__ int64_t cols[];  // [2][N_REQ][TILE]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1;
  int32_t* row = table + bucket * SLOTS * WORDS;

  // this warp's slot, in registers (every lane holds the same copy)
  int32_t w[USED];
  load_words(row + warp * WORDS, w);
  if (lane == 0) sm.key[warp] = join64(w[W_KHI], w[W_KLO]);
  __syncthreads();
  if (tid == 0) {
    int e = 0;
    for (int s = 0; s < SLOTS; ++s)
      if (sm.key[s] == 0) sm.empty[e++] = s;
    sm.nempty = e;
  }

  const int64_t ntiles = (len + TILE - 1) / TILE;
  stage(cols, sm, 0, req, B, tid < len, tid < len ? order[start + tid] : 0);
  int64_t r_next = TILE + tid < len ? order[start + TILE + tid] : 0;
  int newbase = 0;  // new keys given slots (or refused) in earlier tiles
  int64_t chain = 0, n_serial = 0, n_closed = 0;

  for (int64_t t = 0; t < ntiles; ++t) {
    const int buf = (int)(t & 1);
    if (t + 1 < ntiles) {
      stage(cols, sm, buf ^ 1, req, B, (t + 1) * TILE + tid < len, r_next);
      const int64_t nx = (t + 2) * TILE + tid;
      r_next = nx < len ? order[start + nx] : 0;
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int cnt = (int)(len - t * TILE < TILE ? len - t * TILE : TILE);
    const int64_t* col = cols + (int64_t)buf * N_REQ * TILE;

    // (1) match against the slot keys; an unmatched key looks for its
    // first earlier writer in the tile (unless no empty slot is left)
    const bool live = tid < cnt;
    int slot_m = -1, first = -1;
    bool writer = false;
    int64_t key = 0;
    if (live) {
      key = col[R_KEY * TILE + tid];
      writer = writes(col[R_ALG * TILE + tid]);
#pragma unroll
      for (int s = SLOTS - 1; s >= 0; --s)
        if (sm.key[s] == key) slot_m = s;
      if (slot_m < 0 && newbase < sm.nempty) {
        for (int j = 0; j < tid; ++j) {
          if (col[R_KEY * TILE + j] == key
              && writes(col[R_ALG * TILE + j])) {
            first = j;
            break;
          }
        }
      }
      sm.tslot[tid] = (int8_t)(writer ? slot_m : -1);
    }
    const bool new_first = live && slot_m < 0 && first < 0 && writer;
    const unsigned nb = __ballot_sync(FULL, new_first);
    if (lane == 0) sm.wsum[warp] = __popc(nb);
    __syncthreads();

    // (2) the k-th new key of the segment takes the k-th empty slot
    int rank = newbase + __popc(nb & below), total = 0;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) {
      const int v = sm.wsum[k];
      rank += k < warp ? v : 0;
      total += v;
    }
    int flag = 0;
    if (live && slot_m < 0 && first < 0) {
      flag = rank < sm.nempty ? 2 : 1;
      if (new_first && flag == 2) {
        const int s = sm.empty[rank];
        sm.tslot[tid] = (int8_t)s;
        sm.key[s] = key;
      }
    }
    newbase += total;
    __syncthreads();

    // (3) later requests of a new key follow its first writer
    if (live) {
      if (slot_m < 0 && first >= 0) {
        const int s = sm.tslot[first];
        flag = s >= 0 ? 0 : 1;
        if (writer) sm.tslot[tid] = (int8_t)s;
      }
      if (sm.tslot[tid] < 0) {  // err, or an algorithm that writes nothing
        sm.ost[tid] = 0;
        sm.oraw[tid] = 0;
        sm.orst[tid] = 0;
      }
      sm.flag[tid] = (int8_t)flag;
    }
    __syncthreads();

    // (4) warp `warp` walks slot `warp`'s chain in batch order
    int n = 0;
    for (int b0 = 0; b0 < cnt; b0 += 32) {
      const int p = b0 + lane;
      const bool in = p < cnt && sm.tslot[p] == warp;
      const unsigned bal = __ballot_sync(FULL, in);
      if (in) sm.list[warp][n + __popc(bal & below)] = (uint8_t)p;
      n += __popc(bal);
    }
    __syncwarp();
    for (int k = lane; k < n; k += 32) {
      const int p = sm.list[warp][k];
      const int pp = sm.list[warp][k > 0 ? k - 1 : 0];
      bool brk = k == 0 || (col[R_BEH * TILE + p] & (B_RESET | B_DRAIN));
      // every column compared, without short-circuit: the loads are in
      // flight together
#pragma unroll
      for (int c = R_HITS; c < N_REQ; ++c)
        if (c != R_NOW) brk |= col[c * TILE + p] != col[c * TILE + pp];
      sm.brk[warp][k] = brk;
    }
    __syncwarp();
    for (int i = 0; i < n;) {
      int m = sm.brk[warp][i] ? 0 : closed_run(w, col, sm, i, n);
      if (m == 0) {
        const int p = sm.list[warp][i];
        Req q;
#pragma unroll
        for (int c = 0; c < N_REQ; ++c) q.c[c] = col[c * TILE + p];
        const Res o = transition(w, q, sm.flag[p] != 2);
        if (lane == 0) {
          sm.ost[p] = o.st;
          sm.oraw[p] = o.raw;
          sm.orst[p] = o.rst;
        }
        m = 1;
        ++n_serial;
      } else {
        n_closed += m;
      }
      i += m;
    }
    chain += n;
    __syncthreads();

    // (5) the tile's outputs, one request per thread
    if (live) {
      const Res o = {sm.ost[tid], sm.oraw[tid], sm.orst[tid]};
      write_out(out, B, sm.r[buf][tid], col[R_ALG * TILE + tid],
                col[R_EFF * TILE + tid], col[R_LIMIT * TILE + tid], o,
                sm.flag[tid]);
    }
    __syncthreads();
  }
  if (chain > 0 && lane == 0) store_words(row + warp * WORDS, w);
  if (stats && lane == 0) {
    atomicAdd(&stats[ST_SERIAL], (unsigned long long)n_serial);
    atomicAdd(&stats[ST_CLOSED_FORM], (unsigned long long)n_closed);
    atomicMax(&stats[ST_LONGEST_CHAIN], (unsigned long long)chain);
    if (warp == 0) atomicAdd(&stats[ST_HOT_SEGMENTS], 1ull);
  }
}

__global__ void __launch_bounds__(THREADS)
decide_kernel(int32_t* __restrict__ table, const int64_t* __restrict__ req,
              const int64_t* __restrict__ order,
              const int64_t* __restrict__ seg_bucket,
              const int64_t* __restrict__ seg_start,
              const int64_t* __restrict__ seg_len, int64_t S, int64_t B,
              int64_t hot, int64_t n_hot, unsigned long long* stats,
              int64_t* __restrict__ out) {
  if ((int64_t)blockIdx.x < n_hot) {  // block role: segment blockIdx.x
    const int64_t s = blockIdx.x;
    if (seg_len[s] > hot)
      hot_segment(table, req, order, seg_bucket[s], seg_start[s], seg_len[s],
                  B, stats, out);
    return;
  }
  const int64_t s = ((int64_t)blockIdx.x - n_hot) * THREADS + threadIdx.x;
  const int64_t len = s < S ? seg_len[s] : 0;
  const bool cold = len > 0 && len <= hot;
  if (cold)
    cold_segment(table, req, order, seg_bucket[s], seg_start[s], len, B, out);
  if (stats) {
    const unsigned long long sum =
        __reduce_add_sync(FULL, cold ? (unsigned)len : 0u);
    if ((threadIdx.x & 31) == 0 && sum)
      atomicAdd(&stats[ST_COLD], sum);
  }
}

// The kernel's dynamic shared memory limit, set once per device.
std::atomic<unsigned long long> smem_set{0};

cudaError_t allow_smem() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (bit && (smem_set.load(std::memory_order_relaxed) & bit)) return e;
  e = cudaFuncSetAttribute(decide_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           DYN_SMEM);
  if (e == cudaSuccess) smem_set.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a K1 block asks for (the hot path's two
// tiles of request columns).
int64_t guber_decide_smem(void) { return DYN_SMEM; }

// Launch K1 on ``stream``: S distinct buckets, B requests; segments longer
// than ``hot`` go to a block each.  ``stats`` is null or N_STATS uint64
// counters to add to.  All pointers are device pointers from the
// wrapper; nothing is allocated here.  Returns 0 when launched,
// -(CUDA error) when the device refused the dynamic shared memory, else
// cudaGetLastError().
int guber_decide(void* table, const void* req, const void* order,
                 const void* seg_bucket, const void* seg_start,
                 const void* seg_len, int64_t S, int64_t B, int64_t hot,
                 void* stats, void* out, void* stream) {
  const cudaError_t a = allow_smem();
  if (a != cudaSuccess) return -(int)a;
  // at most B // (hot + 1) segments are longer than hot: a prefix, since
  // the segments come longest first
  const int64_t most = B / (hot + 1);
  const int64_t n_hot = S < most ? S : most;
  const int64_t blocks = n_hot + (S + THREADS - 1) / THREADS;
  decide_kernel<<<(unsigned)blocks, THREADS, DYN_SMEM, (cudaStream_t)stream>>>(
      (int32_t*)table, (const int64_t*)req, (const int64_t*)order,
      (const int64_t*)seg_bucket, (const int64_t*)seg_start,
      (const int64_t*)seg_len, S, B, hot, n_hot, (unsigned long long*)stats,
      (int64_t*)out);
  return (int)cudaGetLastError();
}

const char* guber_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
