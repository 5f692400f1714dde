// Host cold store of the tiered key store: an open-addressed table from
// a u64 key hash to one row of 8 int64 values (tiering.py › ROW_COLS).
//
// The port's copy of the cold_* primitives of
// gubernator_tpu/ops/_native.cpp (linear probing over a power-of-two
// table, tombstone deletes, a rehash once full + tombstone slots pass
// 70%: doubled when live rows pass half the table, in place otherwise),
// behind a plain C interface that ops/build.py binds with ctypes.  It
// is linked into the host wire library and runs on the host only.  The
// batch calls (gc_get_many, gc_put_many) serve a whole wave or restore
// in one call; they read and write row arrays of the caller.  Not
// thread-safe: the tier controller serializes every call.

#include <cstdint>
#include <cstring>
#include <new>
#include <utility>
#include <vector>

namespace {

const int64_t COLD_ROW = 8;  // int64 values per row

struct ColdStore {
  std::vector<uint64_t> keys;
  std::vector<int64_t> rows;   // cap * COLD_ROW
  std::vector<uint8_t> state;  // 0 empty, 1 full, 2 tombstone
  size_t cap = 0;              // power of two
  size_t used = 0;             // full slots
  size_t filled = 0;           // full + tombstone (the load basis)
};

void cold_init(ColdStore* cs, size_t cap) {
  cs->cap = cap;
  cs->used = cs->filled = 0;
  cs->keys.assign(cap, 0);
  cs->rows.assign(cap * COLD_ROW, 0);
  cs->state.assign(cap, 0);
}

// Slot of `key`, or the first insertable slot (tombstone or empty) when
// it is absent.  The probe visits every slot of a power-of-two table.
size_t cold_find(const ColdStore* cs, uint64_t key, bool* present) {
  size_t mask = cs->cap - 1;
  size_t i = (size_t)key & mask;
  size_t first_free = (size_t)-1;
  for (size_t n = 0; n < cs->cap; n++, i = (i + 1) & mask) {
    uint8_t st = cs->state[i];
    if (st == 1 && cs->keys[i] == key) {
      *present = true;
      return i;
    }
    if (st == 2) {
      if (first_free == (size_t)-1) first_free = i;
      continue;
    }
    if (st == 0) {
      *present = false;
      return first_free != (size_t)-1 ? first_free : i;
    }
  }
  *present = false;
  return first_free;  // all full or tombstones: a rehash precedes this
}

void cold_grow(ColdStore* cs, size_t new_cap) {
  ColdStore next;
  cold_init(&next, new_cap);
  for (size_t i = 0; i < cs->cap; i++) {
    if (cs->state[i] != 1) continue;
    bool present;
    size_t j = cold_find(&next, cs->keys[i], &present);
    next.keys[j] = cs->keys[i];
    std::memcpy(&next.rows[j * COLD_ROW], &cs->rows[i * COLD_ROW],
                COLD_ROW * sizeof(int64_t));
    next.state[j] = 1;
  }
  next.used = next.filled = cs->used;
  *cs = std::move(next);
}

// 1 inserted, 0 overwrote
int cold_put(ColdStore* cs, uint64_t key, const int64_t* row) {
  if ((cs->filled + 1) * 10 >= cs->cap * 7)
    // a mostly live table doubles; a mostly tombstoned one rehashes
    cold_grow(cs, (cs->used + 1) * 10 >= cs->cap * 5 ? cs->cap * 2
                                                     : cs->cap);
  bool present;
  size_t i = cold_find(cs, key, &present);
  if (!present) {
    if (cs->state[i] == 0) cs->filled++;
    cs->keys[i] = key;
    cs->state[i] = 1;
    cs->used++;
  }
  std::memcpy(&cs->rows[i * COLD_ROW], row, COLD_ROW * sizeof(int64_t));
  return present ? 0 : 1;
}

}  // namespace

extern "C" {

// A new store with room for at least `hint` slots (64 at least); null
// when the allocation fails.
void* gc_new(int64_t hint) {
  size_t cap = 64;
  while ((int64_t)cap < hint) cap <<= 1;
  ColdStore* cs = new (std::nothrow) ColdStore();
  if (cs == nullptr) return nullptr;
  try {
    cold_init(cs, cap);
  } catch (...) {
    delete cs;
    return nullptr;
  }
  return cs;
}

void gc_free(void* h) { delete (ColdStore*)h; }

// 1 inserted, 0 overwrote, -1 out of memory
int gc_put(void* h, uint64_t key, const int64_t* row) {
  try {
    return cold_put((ColdStore*)h, key, row);
  } catch (...) {
    return -1;
  }
}

// Rows of `n` keys in order (a later duplicate overwrites an earlier
// one); returns the rows newly inserted, or -1 out of memory.
int64_t gc_put_many(void* h, const uint64_t* keys, const int64_t* rows,
                    int64_t n) {
  ColdStore* cs = (ColdStore*)h;
  int64_t inserted = 0;
  try {
    for (int64_t i = 0; i < n; i++)
      inserted += cold_put(cs, keys[i], rows + i * COLD_ROW);
  } catch (...) {
    return -1;
  }
  return inserted;
}

// 1 and the row in `out` when present, else 0
int gc_get(void* h, uint64_t key, int64_t* out) {
  ColdStore* cs = (ColdStore*)h;
  bool present;
  size_t i = cold_find(cs, key, &present);
  if (!present) return 0;
  std::memcpy(out, &cs->rows[i * COLD_ROW], COLD_ROW * sizeof(int64_t));
  return 1;
}

// For each of `n` keys: found[i] = 1 and its row at out[i * 8] when
// present, else found[i] = 0 (the row untouched).
void gc_get_many(void* h, const uint64_t* keys, int64_t n, uint8_t* found,
                 int64_t* out) {
  ColdStore* cs = (ColdStore*)h;
  for (int64_t k = 0; k < n; k++) {
    bool present;
    size_t i = cold_find(cs, keys[k], &present);
    found[k] = present ? 1 : 0;
    if (present)
      std::memcpy(out + k * COLD_ROW, &cs->rows[i * COLD_ROW],
                  COLD_ROW * sizeof(int64_t));
  }
}

// Remove `key`: 1 and its row in `out` when it was present, else 0.
int gc_pop(void* h, uint64_t key, int64_t* out) {
  ColdStore* cs = (ColdStore*)h;
  bool present;
  size_t i = cold_find(cs, key, &present);
  if (!present) return 0;
  std::memcpy(out, &cs->rows[i * COLD_ROW], COLD_ROW * sizeof(int64_t));
  cs->state[i] = 2;  // a tombstone keeps later probe chains intact
  cs->used--;
  return 1;
}

int64_t gc_len(void* h) { return (int64_t)((ColdStore*)h)->used; }

// out[i] = 1 where keys[i] is resident: the engines' pre-mask read, one
// call a wave.
void gc_contains(void* h, const uint64_t* keys, int64_t n, uint8_t* out) {
  ColdStore* cs = (ColdStore*)h;
  for (int64_t i = 0; i < n; i++) {
    bool present;
    cold_find(cs, keys[i], &present);
    out[i] = present ? 1 : 0;
  }
}

// Every resident row (at most `cap_rows`) into keys / rows in slot
// order; returns the rows written.
int64_t gc_snapshot(void* h, uint64_t* keys, int64_t* rows,
                    int64_t cap_rows) {
  ColdStore* cs = (ColdStore*)h;
  int64_t w = 0;
  for (size_t i = 0; i < cs->cap && w < cap_rows; i++) {
    if (cs->state[i] != 1) continue;
    keys[w] = cs->keys[i];
    std::memcpy(rows + w * COLD_ROW, &cs->rows[i * COLD_ROW],
                COLD_ROW * sizeof(int64_t));
    w++;
  }
  return w;
}

// 0, or -1 out of memory
int gc_clear(void* h) {
  try {
    cold_init((ColdStore*)h, 64);
  } catch (...) {
    return -1;
  }
  return 0;
}

}  // extern "C"
