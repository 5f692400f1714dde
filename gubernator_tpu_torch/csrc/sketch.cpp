// The heavy-hitter sketch's fold (analytics.py › HeavyHitterSketch.update)
// in C++, on the sketch's own numpy columns, behind a plain C interface
// that ops/build.py binds with ctypes, which releases the GIL for each
// call: the analytics worker then folds a wave without holding up the
// threads that serve.  Linked into the host library with wire.cpp and
// cold.cpp; runs on the host only.
//
// The columns (width slots each): cnt, err, over, last (int64) and kh
// (uint64); slots [0, used) are tracked.  A fold is three calls, as the
// Python update is three steps:
//
//   gs_update       aggregates the wave per key (hits clamped to >= 1),
//                   adds tracked keys' sums to their slots, gives free
//                   slots to the first newcomers in key order, and
//                   returns the newcomers left over;
//   gs_admit_merge  admits the heavy ones (weight > 1) by the exact
//                   sequential Space-Saving merge;
//   gs_admit_level  admits the weight-1 ones by closed-form water-filling.
//
// Both admissions take the order of the slots by count from the caller
// (numpy's argsort of cnt[:used]): which of several equal counts is
// evicted follows numpy's sort, so the columns stay byte-equal to the
// Python fold's (and to the JAX package's) after every fold.  Not
// thread-safe: the analytics worker serializes its calls.

#include <algorithm>
#include <cstdint>
#include <numeric>
#include <utility>
#include <vector>

namespace {

// Stable LSD radix sort of row indices by their 64-bit key, 16 bits a
// pass (passes over a digit every key shares are skipped).
void radix_order(const uint64_t* key, int64_t n, std::vector<int64_t>& out) {
  std::vector<int64_t> tmp(n);
  out.resize(n);
  std::iota(out.begin(), out.end(), 0);
  std::vector<int64_t> count(1 << 16);
  for (int shift = 0; shift < 64; shift += 16) {
    std::fill(count.begin(), count.end(), 0);
    for (int64_t i = 0; i < n; i++) count[(key[i] >> shift) & 0xFFFF]++;
    if (count[(key[0] >> shift) & 0xFFFF] == n) continue;
    int64_t sum = 0;
    for (auto& c : count) {
      int64_t x = c;
      c = sum;
      sum += x;
    }
    for (int64_t i = 0; i < n; i++) {
      int64_t r = out[i];
      tmp[count[(key[r] >> shift) & 0xFFFF]++] = r;
    }
    out.swap(tmp);
  }
}

}  // namespace

extern "C" {

// One wave → per-key sums, folded into the tracked and free slots.
// Writes the wave's unique keys (ascending), each key's first row in
// the wave (uniq_rep) and its weight and over-limit sums (m of each,
// returned in *m_out), then the newcomers left after the free slots
// (ascending key order) into new_kh / new_w / new_o; returns their
// count.  *used and *wsum_total are updated (the wave's total weight is
// added to *wsum_total).  Scratch arrays hold at least n entries.
int64_t gs_update(int64_t width, int64_t* used, int64_t* wsum_total,
                  int64_t* cnt, int64_t* err, int64_t* over, int64_t* last,
                  uint64_t* khs, const uint64_t* kh_in, const int64_t* hits,
                  const uint8_t* over_in, int64_t n, int64_t t_ms,
                  uint64_t* uniq, int64_t* uniq_rep, int64_t* m_out,
                  uint64_t* new_kh, int64_t* new_w, int64_t* new_o) {
  *m_out = 0;
  if (n <= 0) return 0;
  // stable order of the rows by key: the first row of each key names it
  std::vector<int64_t> order;
  radix_order(kh_in, n, order);
  std::vector<int64_t> wsum, osum;
  wsum.reserve(n);
  osum.reserve(n);
  int64_t m = 0, total = 0;
  for (int64_t i = 0; i < n; i++) {
    int64_t r = order[i];
    int64_t w = hits[r] > 1 ? hits[r] : 1;
    total += w;
    if (m == 0 || uniq[m - 1] != kh_in[r]) {
      uniq[m] = kh_in[r];
      uniq_rep[m] = r;
      wsum.push_back(w);
      osum.push_back(over_in[r] ? 1 : 0);
      m++;
    } else {
      wsum[m - 1] += w;
      osum[m - 1] += over_in[r] ? 1 : 0;
    }
  }
  *m_out = m;
  *wsum_total += total;
  // tracked keys: their slots found through a sorted copy of kh[:used]
  int64_t u = *used;
  std::vector<std::pair<uint64_t, int64_t>> index(u);
  for (int64_t s = 0; s < u; s++) index[s] = {khs[s], s};
  std::sort(index.begin(), index.end());
  int64_t k = 0;
  for (int64_t j = 0; j < m; j++) {
    auto it = std::lower_bound(
        index.begin(), index.end(), std::make_pair(uniq[j], (int64_t)-1));
    if (it != index.end() && it->first == uniq[j]) {
      int64_t s = it->second;
      cnt[s] += wsum[j];
      over[s] += osum[j];
      last[s] = t_ms;
    } else {
      new_kh[k] = uniq[j];
      new_w[k] = wsum[j];
      new_o[k] = osum[j];
      k++;
    }
  }
  // free slots go to the first newcomers
  int64_t take = std::min(width - u, k);
  for (int64_t i = 0; i < take; i++) {
    khs[u + i] = new_kh[i];
    cnt[u + i] = new_w[i];
    err[u + i] = 0;
    over[u + i] = new_o[i];
    last[u + i] = t_ms;
  }
  *used = u + take;
  if (take > 0) {
    std::copy(new_kh + take, new_kh + k, new_kh);
    std::copy(new_w + take, new_w + k, new_w);
    std::copy(new_o + take, new_o + k, new_o);
  }
  return k - take;
}

// Sequential Space-Saving for newcomers of any weight, as a two-way
// merge: in ascending weight order (stable) the evicted minima and the
// re-inserted counts are both nondecreasing, so the heap is the slots
// sorted by count (sort_idx: argsort of cnt[:used]) plus a FIFO of the
// wave's re-insertions.  A slot taken twice keeps its last newcomer.
void gs_admit_merge(int64_t used, int64_t* cnt, int64_t* err, int64_t* over,
                    int64_t* last, uint64_t* khs, const int64_t* sort_idx,
                    const uint64_t* new_kh, const int64_t* new_w,
                    const int64_t* new_o, int64_t k, int64_t t_ms) {
  std::vector<int64_t> ord(k);
  std::iota(ord.begin(), ord.end(), 0);
  std::stable_sort(ord.begin(), ord.end(),
                   [new_w](int64_t a, int64_t b) { return new_w[a] < new_w[b]; });
  std::vector<int64_t> scnt(used);
  for (int64_t i = 0; i < used; i++) scnt[i] = cnt[sort_idx[i]];
  std::vector<int64_t> qv, qs;
  qv.reserve(k);
  qs.reserve(k);
  std::vector<int64_t> assign(used, -1), inherited(used, 0);
  std::vector<int64_t> touched;
  int64_t si = 0, qi = 0;
  for (int64_t j = 0; j < k; j++) {
    int64_t wj = new_w[ord[j]];
    int64_t v, slot;
    if (qi < (int64_t)qv.size() && (si >= used || qv[qi] <= scnt[si])) {
      v = qv[qi];
      slot = qs[qi];
      qi++;
    } else {
      v = scnt[si];
      slot = sort_idx[si];
      si++;
    }
    if (assign[slot] < 0) touched.push_back(slot);
    assign[slot] = j;
    inherited[slot] = v;
    qv.push_back(v + wj);
    qs.push_back(slot);
  }
  for (int64_t slot : touched) {
    int64_t r = ord[assign[slot]];
    khs[slot] = new_kh[r];
    cnt[slot] = inherited[slot] + new_w[r];
    err[slot] = inherited[slot];
    over[slot] = new_o[r];
    last[slot] = t_ms;
  }
}

// s weight-1 newcomers: s pops of "evict the minimum, reinsert min + 1"
// raise the lowest counts to a common level L (the first r of them to
// L + 1), in closed form over the slots sorted by count (order: argsort
// of cnt[:used]).  The raised slots take the first newcomers, err =
// count - 1; the newcomers evicted again inside the wave vanish.
void gs_admit_level(int64_t used, int64_t* cnt, int64_t* err, int64_t* over,
                    int64_t* last, uint64_t* khs, const int64_t* order,
                    const uint64_t* new_kh, const int64_t* new_o, int64_t s,
                    int64_t t_ms) {
  // t0 = the number of slots whose lift to their own count costs <= s
  int64_t csum = 0, t0 = 0, csum_t0 = 0;
  for (int64_t i = 0; i < used; i++) {
    int64_t c = cnt[order[i]];
    csum += c;
    if ((i + 1) * c - csum > s) break;
    t0 = i + 1;
    csum_t0 = csum;
  }
  int64_t pool = s + csum_t0;
  int64_t level = pool / t0;
  int64_t r = pool - level * t0;
  int64_t raised = 0;
  for (int64_t i = 0; i < t0; i++) {
    int64_t slot = order[i];
    int64_t nv = level + (i < r ? 1 : 0);
    if (nv > cnt[slot]) {
      cnt[slot] = nv;
      err[slot] = nv - 1;
      khs[slot] = new_kh[raised];
      over[slot] = new_o[raised];
      last[slot] = t_ms;
      raised++;
    }
  }
}

}  // extern "C"
