// The tenant ledger's attribution (analytics.py › KeyAnalytics, the tenant
// half) in C++, behind a plain C interface that ops/build.py binds with
// ctypes, which releases the GIL for each call: the analytics worker
// attributes a wave to its tenants without holding up the threads that
// serve.  Linked into the host library with wire.cpp, cold.cpp and
// sketch.cpp; runs on the host only.
//
// A table maps a key hash to its tenant bucket: the learned cache of the
// JAX package's `_kh_tenant` dict, bounded the same way.  A key hash not
// in the table is noted at the end of an insertion order; once the table
// holds `cap` keys, a new one first evicts the oldest cap / 2 (the dict's
// `list(cache)[:cap // 2]`).  Noting a known key changes its bucket if it
// differs and keeps its place, as a dict assignment does.  So the same
// notes in the same order leave the same table as the dict.
//
// The counts are the ledger's own [buckets, 6] int64 array (requests,
// hits, over_limit, errors, degraded, shed); the folds add to its first
// three columns.  The table's mutex guards it against a serving thread's
// lookup (a tenant hint) while the worker notes; the counts are guarded
// by the caller's lock.  A serving thread's hint never waits on the
// worker (gt_peek).

#include <Python.h>

#include <cstdint>
#include <deque>
#include <mutex>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

const uint64_t FNV_OFFSET = 0xCBF29CE484222325ULL;
const uint64_t FNV_PRIME = 0x100000001B3ULL;

inline uint64_t fnv1a64(const uint8_t* p, uint64_t n, uint64_t h) {
  for (uint64_t i = 0; i < n; i++) {
    h ^= (uint64_t)p[i];
    h *= FNV_PRIME;
  }
  return h;
}

inline uint64_t mix64(uint64_t x) {
  x ^= x >> 30;
  x *= 0xBF58476D1CE4E5B9ULL;
  x ^= x >> 27;
  x *= 0x94D049BB133111EBULL;
  x ^= x >> 31;
  return x;
}

// The table key hash of name + "_" + unique_key (hashing.hash_request_keys).
inline uint64_t pair_hash(const uint8_t* name, uint64_t nn, const uint8_t* key,
                          uint64_t nk) {
  const uint8_t us = '_';
  uint64_t h = fnv1a64(name, nn, FNV_OFFSET);
  h = fnv1a64(&us, 1, h);
  h = mix64(fnv1a64(key, nk, h));
  return h == 0 ? 1 : h;
}

inline bool read_varint(const uint8_t** p, const uint8_t* end, uint64_t* out) {
  uint64_t v = 0;
  int shift = 0;
  const uint8_t* q = *p;
  while (q < end) {
    uint8_t b = *q++;
    v |= (uint64_t)(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *p = q;
      *out = v;
      return true;
    }
    shift += 7;
    if (shift > 63) return false;
  }
  return false;
}

// Skip a field of wire type `wt` (the JAX walk's _skip_field: varint,
// fixed64 and fixed32; any other type is malformed).
inline bool skip_field(const uint8_t** p, const uint8_t* end, uint64_t wt) {
  uint64_t v;
  if (wt == 0) return read_varint(p, end, &v);
  uint64_t n = wt == 1 ? 8 : wt == 5 ? 4 : 0;
  if (n == 0) return false;
  *p += n;
  return true;
}

struct Table {
  std::mutex mu;
  std::unordered_map<uint64_t, int64_t> map;
  std::deque<uint64_t> order;  // insertion order of the keys in `map`
  std::unordered_map<std::string, int64_t> tenants;  // tenant id → bucket
  int64_t cap;
};

inline int64_t find(const Table* t, uint64_t kh) {
  auto it = t->map.find(kh);
  return it == t->map.end() ? -1 : it->second;
}

// One JAX `_kh_note`: the caller holds t->mu.
inline void note(Table* t, uint64_t kh, int64_t tidx) {
  auto it = t->map.find(kh);
  if (it != t->map.end()) {
    it->second = tidx;
    return;
  }
  if ((int64_t)t->map.size() >= t->cap) {
    for (int64_t i = 0, n = t->cap / 2; i < n && !t->order.empty(); i++) {
      t->map.erase(t->order.front());
      t->order.pop_front();
    }
  }
  t->map.emplace(kh, tidx);
  t->order.push_back(kh);
}

inline void add(int64_t* counts, int64_t nb, int64_t b, int64_t hits,
                uint8_t over) {
  if (b < 0 || b >= nb) b = 0;
  int64_t* c = counts + 6 * b;
  c[0] += 1;
  c[1] += hits;
  c[2] += over ? 1 : 0;
}

}  // namespace

extern "C" {

void* gt_new(int64_t cap) {
  Table* t = new Table();
  t->cap = cap < 2 ? 2 : cap;
  t->map.reserve((size_t)t->cap);
  return t;
}

void gt_free(void* h) { delete (Table*)h; }

int64_t gt_len(void* h) {
  Table* t = (Table*)h;
  std::lock_guard<std::mutex> g(t->mu);
  return (int64_t)t->map.size();
}

// out[i] = the bucket of kh[i], -1 where the table does not know it;
// returns the count of unknown rows.
int64_t gt_lookup(void* h, const uint64_t* kh, int64_t n, int64_t* out) {
  Table* t = (Table*)h;
  std::lock_guard<std::mutex> g(t->mu);
  int64_t unknown = 0;
  for (int64_t i = 0; i < n; i++) {
    out[i] = find(t, kh[i]);
    unknown += out[i] < 0;
  }
  return unknown;
}

// The bucket of one key hash for a serving thread's hint, without
// waiting: -2 while the worker holds the table, -1 where it does not know
// the key.
int64_t gt_peek(void* h, uint64_t kh) {
  Table* t = (Table*)h;
  std::unique_lock<std::mutex> g(t->mu, std::try_to_lock);
  if (!g.owns_lock()) return -2;
  return find(t, kh);
}

// Note (kh[i], tidx[i]) for every row, in row order.
void gt_note(void* h, const uint64_t* kh, const int64_t* tidx, int64_t n) {
  Table* t = (Table*)h;
  std::lock_guard<std::mutex> g(t->mu);
  for (int64_t i = 0; i < n; i++) note(t, kh[i], tidx[i]);
}

// The columnar fold (JAX `_fold_tenants`): each row to its learned bucket,
// a key the table does not know to bucket 0 (`__other__`).
void gt_fold(void* h, int64_t* counts, int64_t nb, const uint64_t* kh,
             const int64_t* hits, const uint8_t* over, int64_t n) {
  Table* t = (Table*)h;
  std::lock_guard<std::mutex> g(t->mu);
  for (int64_t i = 0; i < n; i++)
    add(counts, nb, find(t, kh[i]), hits[i], over[i]);
}

// The object lane's fold: each row to the bucket its name gave.
void gt_fold_idx(int64_t* counts, int64_t nb, const int64_t* tidx,
                 const int64_t* hits, const uint8_t* over, int64_t n) {
  for (int64_t i = 0; i < n; i++) add(counts, nb, tidx[i], hits[i], over[i]);
}

// Map a tenant id (the UTF-8 bytes of a name's prefix) to its bucket:
// what the ledger's index_of gave it.  Ids stay in the map for the
// table's life (a bucket, or __other__ once the ledger overflowed, never
// changes); at most `cap` ids are kept.
void gt_tenant_set(void* h, const uint8_t* id, int64_t n, int64_t tidx) {
  Table* t = (Table*)h;
  std::lock_guard<std::mutex> g(t->mu);
  if ((int64_t)t->tenants.size() < t->cap || t->tenants.count(
          std::string((const char*)id, (size_t)n)))
    t->tenants[std::string((const char*)id, (size_t)n)] = tidx;
}

// The object lane's learn: for each row i with tidx[i] < 0 (a key the
// table does not know), the bucket of its tenant, read from the `name`
// of reqs[i] (a list of request objects, GIL held: bound through
// ctypes.PyDLL).  A row whose tenant is not mapped yet keeps -1 and its
// index goes to `need` (at most `cap_out`); returns their count, or -1
// with a Python exception set.
int64_t gt_learn_objects(void* h, PyObject* reqs, int64_t* tidx, int64_t n,
                         const uint8_t* delim, int64_t dlen, int64_t* need,
                         int64_t cap_out) {
  Table* t = (Table*)h;
  if (!PyList_Check(reqs) || PyList_GET_SIZE(reqs) < n) {
    PyErr_SetString(PyExc_TypeError, "expected a list of n requests");
    return -1;
  }
  struct Name {
    int64_t row;
    const char* p;
    Py_ssize_t n;
    PyObject* obj;  // borrowed: the request keeps it alive
  };
  std::vector<Name> names;
  for (int64_t i = 0; i < n; i++) {
    if (tidx[i] >= 0) continue;
    PyObject* name = PyObject_GetAttrString(PyList_GET_ITEM(reqs, i), "name");
    if (name == nullptr) return -1;
    if (!names.empty() && names.back().obj == name) {
      // the same name object as the previous new row (a caller's batch
      // repeats it): the same tenant
      Py_DECREF(name);
      names.push_back({i, names.back().p, names.back().n, name});
      continue;
    }
    Py_ssize_t ln;
    const char* p = PyUnicode_AsUTF8AndSize(name, &ln);
    // the request keeps its name alive: the UTF-8 buffer outlives this ref
    Py_DECREF(name);
    if (p == nullptr) return -1;
    Py_ssize_t tn = ln;
    if (dlen > 0) {
      for (Py_ssize_t j = 0; j + dlen <= ln; j++) {
        if (std::memcmp(p + j, delim, (size_t)dlen) == 0) {
          tn = j;
          break;
        }
      }
    }
    names.push_back({i, p, tn, name});
  }
  std::lock_guard<std::mutex> g(t->mu);
  int64_t k = 0;
  const Name* last = nullptr;  // the previous mapped name
  int64_t last_v = -1;
  for (const Name& nm : names) {
    if (last != nullptr && last->n == nm.n &&
        (last->p == nm.p || std::memcmp(last->p, nm.p, (size_t)nm.n) == 0)) {
      tidx[nm.row] = last_v;
      continue;
    }
    auto it = t->tenants.find(std::string(nm.p, (size_t)nm.n));
    if (it != t->tenants.end()) {
      tidx[nm.row] = it->second;
      last = &nm;
      last_v = it->second;
    } else if (k < cap_out) {
      need[k++] = nm.row;
    }
  }
  return k;
}

// The wire lanes' learn (the JAX `_apply_learn`).  Walks a serialized
// GetRateLimitsReq as the JAX `iter_wire_names` does (field 1 =
// RateLimitReq; inside it field 1 = name, 2 = unique_key); each request
// with a name is a row, its key hash that of name + "_" + unique_key.
// When the table knows every row's key, nothing is noted (the JAX early
// exit).  Else each row's bucket is its tenant's (the name up to the
// first `delim`), and every row is noted in request order, as the JAX
// loop notes them.  A row whose tenant is not mapped yet stops the
// learn before anything is noted: its name's offset and length go to
// `need_off` / `need_len` (at most `cap_out`), and the caller maps the
// tenant (gt_tenant_set) and calls again.  Returns the count of such
// rows (0: learned, or nothing to learn), or -1 when the bytes are
// malformed (the JAX walk raises: nothing is learned).
int64_t gt_wire_learn(void* h, const uint8_t* data, int64_t len,
                      const uint8_t* delim, int64_t dlen, int64_t* need_off,
                      int64_t* need_len, int64_t cap_out) {
  Table* t = (Table*)h;
  struct Row {
    uint64_t kh;
    int64_t off, nn, tn;
  };
  std::vector<Row> rows;
  const uint8_t* p = data;
  const uint8_t* end = data + len;
  while (p < end) {
    uint64_t tag;
    if (!read_varint(&p, end, &tag)) return -1;
    if ((tag & 7) != 2) {
      if (!skip_field(&p, end, tag & 7)) return -1;
      continue;
    }
    uint64_t ln;
    if (!read_varint(&p, end, &ln)) return -1;
    const uint8_t* body_end = p + ln;
    if (body_end > end) return -1;
    if ((tag >> 3) == 1) {
      const uint8_t *name = nullptr, *key = nullptr;
      uint64_t nn = 0, nk = 0;
      const uint8_t* q = p;
      while (q < body_end) {
        uint64_t tt;
        if (!read_varint(&q, body_end, &tt)) return -1;
        if ((tt & 7) != 2) {
          if (!skip_field(&q, body_end, tt & 7)) return -1;
          continue;
        }
        uint64_t sl;
        if (!read_varint(&q, body_end, &sl)) return -1;
        if (q + sl > body_end) return -1;
        if ((tt >> 3) == 1) {
          name = q;
          nn = sl;
        } else if ((tt >> 3) == 2) {
          key = q;
          nk = sl;
        }
        q += sl;
      }
      if (nn > 0) {
        int64_t tn = (int64_t)nn;
        if (dlen > 0 && (int64_t)nn >= dlen) {
          for (int64_t i = 0; i + dlen <= (int64_t)nn; i++) {
            if (std::memcmp(name + i, delim, (size_t)dlen) == 0) {
              tn = i;
              break;
            }
          }
        }
        rows.push_back({pair_hash(name, nn, key, nk),
                        (int64_t)(name - data), (int64_t)nn, tn});
      }
    }
    p = body_end;
  }
  std::lock_guard<std::mutex> g(t->mu);
  bool all_known = true;
  for (const Row& r : rows) {
    if (t->map.find(r.kh) == t->map.end()) {
      all_known = false;
      break;
    }
  }
  if (all_known) return 0;
  std::vector<int64_t> tidx(rows.size());
  int64_t need = 0;
  const Row* last = nullptr;  // the previous mapped row: runs share tenants
  for (size_t i = 0; i < rows.size(); i++) {
    const Row& r = rows[i];
    if (last != nullptr && last->tn == r.tn &&
        std::memcmp(data + last->off, data + r.off, (size_t)r.tn) == 0) {
      tidx[i] = tidx[last - rows.data()];
      continue;
    }
    auto it = t->tenants.find(
        std::string((const char*)data + r.off, (size_t)r.tn));
    if (it == t->tenants.end()) {
      if (need < cap_out) {
        need_off[need] = r.off;
        need_len[need] = r.nn;
      }
      need++;
    } else {
      tidx[i] = it->second;
      last = &r;
    }
  }
  if (need) return cap_out == 0 ? need : (need < cap_out ? need : cap_out);
  for (size_t i = 0; i < rows.size(); i++) note(t, rows[i].kh, tidx[i]);
  return 0;
}

// gt_wire_learn over `nbuf` messages in order (the learn taps a worker
// drained together), in one call.  Returns 0 when every message was
// learned (a malformed one learns nothing, as alone); else stops at the
// first message with a tenant not mapped yet, sets `*done` to its index
// and returns what gt_wire_learn returns for it.
int64_t gt_wire_learn_many(void* h, const uint8_t* const* datas,
                           const int64_t* lens, int64_t nbuf,
                           const uint8_t* delim, int64_t dlen,
                           int64_t* need_off, int64_t* need_len,
                           int64_t cap_out, int64_t* done) {
  for (int64_t i = 0; i < nbuf; i++) {
    int64_t r = gt_wire_learn(h, datas[i], lens[i], delim, dlen, need_off,
                              need_len, cap_out);
    if (r > 0) {
      *done = i;
      return r;
    }
  }
  *done = nbuf;
  return 0;
}

}  // extern "C"
