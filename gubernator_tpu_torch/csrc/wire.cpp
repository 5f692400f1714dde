// Host wire library of the port: GetRateLimitsReq bytes in, packed
// request columns out; result columns in, GetRateLimitsResp bytes out.
//
// The port's copy of the solo wire lane of gubernator_tpu/ops/_native.cpp
// (parse_get_rate_limits, count_req_items, mix64 / pack_wire_wave,
// build_resp_rows / build_responses_from_columns and the varint, UTF-8
// and FNV-1a helpers they share) and of its forward-hop codec
// (stamp_req_tlvs, split_resp_items), behind a plain C interface: the Python
// side (ops/native.py) binds it with ctypes, which releases the GIL for
// the call, so concurrent callers ingest and serialize in parallel.  It
// runs on the host CPU only and is built with the host C++ compiler
// (ops/build.py › load_wire_library), apart from the CUDA kernels.
//
// Buffer contract: the caller owns every buffer.  Input is (data, len).
// Output arrays are sized by the caller (from gw_count_req_items, or the
// wave width m); a function returns the row count n, or -1 when the
// message needs the protobuf path (metadata, empty name or key, unknown
// fields, bad framing or UTF-8) or, for gw_pack_wire_wave, host-side
// Python (a DURATION_IS_GREGORIAN row, more rows than the wave holds).
// gw_build_responses writes into a caller buffer of at least
// gw_resp_bound(rows, error bytes) bytes and returns the bytes written.
// The clamp bounds are arguments, so types.py stays their one home.
//
// Two entry points read Python objects (the key hashing of the object
// lane, the port's copy of fnv1a64_batch / fnv1a64_pair_batch): they
// take lists of str and read each string's UTF-8 bytes in place, so the
// Python side builds no joined or encoded strings.  They run with the
// GIL held (ops/native.py binds them through ctypes.PyDLL) and report a
// failure as a Python exception.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>

namespace {

const uint64_t FNV_OFFSET = 0xCBF29CE484222325ULL;
const uint64_t FNV_PRIME = 0x100000001B3ULL;
const uint64_t GREG = 4;  // Behavior.DURATION_IS_GREGORIAN

inline uint64_t fnv1a64(const uint8_t* p, uint64_t n, uint64_t h) {
  for (uint64_t i = 0; i < n; i++) {
    h ^= (uint64_t)p[i];
    h *= FNV_PRIME;
  }
  return h;
}

// splitmix64 finalizer: bit-identical to hashing.mix64_np
inline uint64_t mix64(uint64_t x) {
  x ^= x >> 30;
  x *= 0xBF58476D1CE4E5B9ULL;
  x ^= x >> 27;
  x *= 0x94D049BB133111EBULL;
  x ^= x >> 31;
  return x;
}

// Strict UTF-8 (RFC 3629: no surrogates, no overlongs, max U+10FFFF),
// what protobuf checks on string fields: the fast lane accepts exactly
// what the protobuf path accepts.
inline bool valid_utf8(const uint8_t* p, uint64_t n) {
  const uint8_t* end = p + n;
  while (p < end) {
    uint8_t c = *p;
    if (c < 0x80) {
      p++;
    } else if ((c & 0xE0) == 0xC0) {
      if (end - p < 2 || (p[1] & 0xC0) != 0x80 || c < 0xC2) return false;
      p += 2;
    } else if ((c & 0xF0) == 0xE0) {
      if (end - p < 3 || (p[1] & 0xC0) != 0x80 || (p[2] & 0xC0) != 0x80)
        return false;
      if (c == 0xE0 && p[1] < 0xA0) return false;   // overlong
      if (c == 0xED && p[1] >= 0xA0) return false;  // surrogate
      p += 3;
    } else if ((c & 0xF8) == 0xF0) {
      if (end - p < 4 || (p[1] & 0xC0) != 0x80 || (p[2] & 0xC0) != 0x80 ||
          (p[3] & 0xC0) != 0x80)
        return false;
      if (c == 0xF0 && p[1] < 0x90) return false;                  // overlong
      if (c > 0xF4 || (c == 0xF4 && p[1] >= 0x90)) return false;  // >10FFFF
      p += 4;
    } else {
      return false;
    }
  }
  return true;
}

inline bool read_varint(const uint8_t** p, const uint8_t* end,
                        uint64_t* out) {
  uint64_t v = 0;
  int shift = 0;
  const uint8_t* q = *p;
  while (q < end && shift < 64) {
    uint8_t b = *q++;
    v |= (uint64_t)(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *p = q;
      *out = v;
      return true;
    }
    shift += 7;
  }
  return false;
}

// One RateLimitReq, as the wire gives it.
struct Req {
  const uint8_t* name;
  const uint8_t* key;
  uint64_t name_len, key_len;
  int64_t hits, limit, duration, burst, created;
  int32_t algorithm, behavior;
  uint64_t tlv_off, tlv_len;  // the whole `requests` TLV in the input
};

// Reads the next `requests` TLV at *p.  False when the message needs the
// protobuf path: a top-level field other than 1, bad framing, a field
// the lane does not model (metadata, unknown), an empty name or key, or
// invalid UTF-8.
bool next_req(const uint8_t* base, const uint8_t** p, const uint8_t* end,
              Req* r) {
  const uint8_t* tlv_start = *p;
  uint64_t tag, len;
  if (!read_varint(p, end, &tag) || tag != 0x0A ||  // field 1, LEN
      !read_varint(p, end, &len) || (uint64_t)(end - *p) < len)
    return false;
  const uint8_t* q = *p;
  const uint8_t* qend = *p + len;
  *p = qend;
  *r = Req{};
  while (q < qend) {
    uint64_t t;
    if (!read_varint(&q, qend, &t)) return false;
    uint64_t field = t >> 3, wt = t & 7;
    if (wt == 2) {
      uint64_t l;
      if (!read_varint(&q, qend, &l) || (uint64_t)(qend - q) < l)
        return false;
      if (field == 1) {
        r->name = q;
        r->name_len = l;
      } else if (field == 2) {
        r->key = q;
        r->key_len = l;
      } else {  // metadata (9) or unknown
        return false;
      }
      q += l;
    } else if (wt == 0) {
      uint64_t v;
      if (!read_varint(&q, qend, &v)) return false;
      switch (field) {
        case 3: r->hits = (int64_t)v; break;
        case 4: r->limit = (int64_t)v; break;
        case 5: r->duration = (int64_t)v; break;
        case 6: r->algorithm = (int32_t)v; break;
        case 7: r->behavior = (int32_t)v; break;
        case 8: r->burst = (int64_t)v; break;
        case 10: r->created = (int64_t)v; break;
        default: return false;
      }
    } else {
      return false;
    }
  }
  // an empty name or key is a per-request error on the protobuf path
  if (r->name == nullptr || r->name_len == 0 || r->key == nullptr ||
      r->key_len == 0 || !valid_utf8(r->name, r->name_len) ||
      !valid_utf8(r->key, r->key_len))
    return false;
  r->tlv_off = (uint64_t)(tlv_start - base);
  r->tlv_len = (uint64_t)(qend - tlv_start);
  return true;
}

// FNV-1a 64 of name + "_" + unique_key, without the joined string.
inline uint64_t key_hash(const Req& r) {
  const uint8_t us = '_';
  uint64_t h = fnv1a64(r.name, r.name_len, FNV_OFFSET);
  h = fnv1a64(&us, 1, h);
  return fnv1a64(r.key, r.key_len, h);
}

inline uint8_t* put_varint(uint8_t* o, uint64_t v) {
  while (v >= 0x80) {
    *o++ = (uint8_t)(v | 0x80);
    v >>= 7;
  }
  *o++ = (uint8_t)v;
  return o;
}

inline int varint_len(uint64_t v) {
  int n = 1;
  while (v >= 0x80) {
    v >>= 7;
    n++;
  }
  return n;
}

// proto3: a field at its default is omitted
inline uint8_t* put_field_varint(uint8_t* o, int field, uint64_t v) {
  if (v == 0) return o;
  *o++ = (uint8_t)(field << 3);
  return put_varint(o, v);
}

}  // namespace

extern "C" {

// Top-level scan: the number of `requests` TLVs, without reading their
// payloads, so a caller can size its buffers before the one full pass.
// -1 on framing the lane does not model.
int64_t gw_count_req_items(const uint8_t* data, int64_t len) {
  const uint8_t* p = data;
  const uint8_t* end = data + len;
  int64_t n = 0;
  while (p < end) {
    uint64_t tag, l;
    if (!read_varint(&p, end, &tag) || tag != 0x0A ||
        !read_varint(&p, end, &l) || (uint64_t)(end - p) < l)
      return -1;
    p += l;
    n++;
  }
  return n;
}

// The request columns of a GetRateLimitsReq, as given (no clamps), with
// the RAW FNV-1a key hash (no finalizer), each request's TLV range and
// the OR of every behavior.  At most `cap` rows; returns n or -1.
int64_t gw_parse_get_rate_limits(const uint8_t* data, int64_t len,
                                 int64_t cap, uint64_t* khash_raw,
                                 int64_t* hits, int64_t* limit,
                                 int64_t* duration, int32_t* algorithm,
                                 int32_t* behavior, int64_t* burst,
                                 uint64_t* tlv_off, uint64_t* tlv_len,
                                 int64_t* created, uint64_t* behavior_or) {
  const uint8_t* p = data;
  const uint8_t* end = data + len;
  uint64_t beh_or = 0;
  int64_t n = 0;
  Req r;
  while (p < end) {
    if (n >= cap || !next_req(data, &p, end, &r)) return -1;
    khash_raw[n] = key_hash(r);
    hits[n] = r.hits;
    limit[n] = r.limit;
    duration[n] = r.duration;
    algorithm[n] = r.algorithm;
    behavior[n] = r.behavior;
    burst[n] = r.burst;
    created[n] = r.created;
    tlv_off[n] = r.tlv_off;
    tlv_len[n] = r.tlv_len;
    beh_or |= (uint64_t)(uint32_t)r.behavior;
    n++;
  }
  *behavior_or = beh_or;
  return n;
}

// The fused ingest: one pass that parses, validates, clamps (the exact
// arithmetic of core/batch.py › pack_columns), hashes (FNV-1a 64, then
// mix64, 0 remapped to 1) and writes the rows straight into a packed
// wave pair: a64 [8, m] int64 row-major (key, hits, limit, duration,
// eff_ms, greg_end, burst, now) and a32 [3, m] int32 (behavior,
// algorithm, valid), core/batch.py › PACK64 / PACK32.  The pair arrives
// zeroed; the padding rows [n, m) get eff_ms = 1 here (empty_batch).
// khash, khash_raw, tlv_off and tlv_len hold m entries.  Returns n, or
// -1 for anything that needs the protobuf path, a Gregorian row (its
// period end is computed in Python) or more than m rows.
int64_t gw_pack_wire_wave(const uint8_t* data, int64_t len, int64_t now_ms,
                          int64_t* a64, int32_t* a32, int64_t m,
                          uint64_t duration_max, uint64_t value_max,
                          uint64_t eff_max, uint64_t td_bound,
                          uint64_t* khash, uint64_t* khash_raw,
                          uint64_t* tlv_off, uint64_t* tlv_len,
                          uint64_t* behavior_or) {
  int64_t* r_key = a64;
  int64_t* r_hits = a64 + m;
  int64_t* r_limit = a64 + 2 * m;
  int64_t* r_dur = a64 + 3 * m;
  int64_t* r_eff = a64 + 4 * m;
  int64_t* r_burst = a64 + 6 * m;
  int64_t* r_now = a64 + 7 * m;
  int32_t* r_beh = a32;
  int32_t* r_alg = a32 + m;
  int32_t* r_valid = a32 + 2 * m;
  for (int64_t i = 0; i < m; i++) r_eff[i] = 1;
  const uint8_t* p = data;
  const uint8_t* end = data + len;
  uint64_t beh_or = 0;
  int64_t n = 0;
  Req r;
  while (p < end) {
    if (!next_req(data, &p, end, &r) ||
        ((uint64_t)(uint32_t)r.behavior & GREG) || n >= m)
      return -1;
    uint64_t h = key_hash(r);
    khash_raw[n] = h;
    uint64_t hm = mix64(h);
    if (hm == 0) hm = 1;
    khash[n] = hm;
    tlv_off[n] = r.tlv_off;
    tlv_len[n] = r.tlv_len;
    int64_t dur = r.duration < (int64_t)duration_max ? r.duration
                                                      : (int64_t)duration_max;
    int64_t eff = dur > 1 ? dur : 1;
    bool leaky = r.algorithm == 1;
    uint64_t cap_v = value_max;
    if (leaky) {
      if (eff > (int64_t)eff_max) eff = (int64_t)eff_max;
      uint64_t c = td_bound / (uint64_t)eff;
      cap_v = c < value_max ? c : value_max;
    }
    int64_t lim = r.limit < 0 ? 0 : r.limit;
    if (lim > (int64_t)cap_v) lim = (int64_t)cap_v;
    int64_t hits = r.hits < 0 ? 0 : r.hits;
    if (hits > (int64_t)cap_v) hits = (int64_t)cap_v;
    int64_t burst = r.burst > 0 ? (r.burst < (int64_t)cap_v
                                       ? r.burst : (int64_t)cap_v)
                                : lim;
    r_key[n] = (int64_t)hm;
    r_hits[n] = hits;
    r_limit[n] = lim;
    r_dur[n] = dur;
    r_eff[n] = eff;
    r_burst[n] = burst;
    // a caller-stamped created_at (field 10) is the request's own clock
    r_now[n] = r.created > 0 ? r.created : now_ms;
    r_beh[n] = r.behavior;
    r_alg[n] = leaky ? 1 : 0;
    r_valid[n] = 1;
    beh_or |= (uint64_t)(uint32_t)r.behavior;
    n++;
  }
  *behavior_or = beh_or;
  return n;
}

// Bytes one response row may take besides its error string: the
// `responses` tag and length (1 + 10), status (1 + 5), limit, remaining
// and reset_time (3 × (1 + 10)); an error adds its tag and length
// (1 + 10) and its bytes.
int64_t gw_resp_bound(int64_t rows, int64_t n_err, int64_t err_bytes) {
  return rows * 50 + n_err * 11 + err_bytes;
}

// Rows [lo, hi) of a wave's result columns → GetRateLimitsResp bytes in
// `out` (at least gw_resp_bound bytes).  Errors come as n_err entries
// (err_row relative to lo, ascending; err_off / err_len into the joined
// UTF-8 buffer err_buf); an empty one is no error.  Returns the bytes
// written, or -1 if `out_cap` is below the bound.
int64_t gw_build_responses(const int32_t* status, const int64_t* limit,
                           const int64_t* remaining,
                           const int64_t* reset_time, int64_t lo,
                           int64_t hi, const int64_t* err_row,
                           const int64_t* err_off, const int64_t* err_len,
                           int64_t n_err, const uint8_t* err_buf,
                           uint8_t* out, int64_t out_cap) {
  int64_t err_bytes = 0;
  for (int64_t e = 0; e < n_err; e++) err_bytes += err_len[e];
  if (out_cap < gw_resp_bound(hi - lo, n_err, err_bytes)) return -1;
  uint8_t* o = out;
  uint8_t sub[40];
  int64_t e = 0;
  for (int64_t i = lo; i < hi; i++) {
    uint8_t* s = sub;
    s = put_field_varint(s, 1, (uint64_t)(uint32_t)status[i]);
    s = put_field_varint(s, 2, (uint64_t)limit[i]);
    s = put_field_varint(s, 3, (uint64_t)remaining[i]);
    s = put_field_varint(s, 4, (uint64_t)reset_time[i]);
    uint64_t elen = 0;
    const uint8_t* ep = nullptr;
    while (e < n_err && err_row[e] < i - lo) e++;
    if (e < n_err && err_row[e] == i - lo) {
      ep = err_buf + err_off[e];
      elen = (uint64_t)err_len[e];
    }
    uint64_t sub_len = (uint64_t)(s - sub);
    if (elen > 0) sub_len += 1 + varint_len(elen) + elen;
    *o++ = 0x0A;  // GetRateLimitsResp.responses
    o = put_varint(o, sub_len);
    std::memcpy(o, sub, (size_t)(s - sub));
    o += s - sub;
    if (elen > 0) {
      *o++ = (5 << 3) | 2;
      o = put_varint(o, elen);
      std::memcpy(o, ep, (size_t)elen);
      o += elen;
    }
  }
  return (int64_t)(o - out);
}

// Upper bound of gw_stamp_req_tlvs's output: every slice may grow by a
// field-10 varint (tag + up to 10 bytes) and one more length byte.
int64_t gw_stamp_bound(int64_t n, int64_t slice_bytes) {
  return slice_bytes + n * 12;
}

// The forward hop's bulk TLV join (gubernator_tpu/ops/_native.cpp ›
// stamp_req_tlvs): concatenates the n request TLV slices
// data[toff[i], toff[i] + tlen[i]) into `out`, appending
// `created_at = stamp_ms` (field 10) to every slice whose created[i] is
// 0, so a forwarded request applies at the caller's clock on the owner;
// a slice that already carries a stamp goes verbatim (first hop wins).
// Returns the bytes written, -1 on a malformed slice, -2 if `out_cap` is
// below gw_stamp_bound.
int64_t gw_stamp_req_tlvs(const uint8_t* data, int64_t len,
                          const int64_t* toff, const int64_t* tlen,
                          const int64_t* created, int64_t n,
                          int64_t stamp_ms, uint8_t* out, int64_t out_cap) {
  int64_t slice_bytes = 0;
  for (int64_t i = 0; i < n; i++) slice_bytes += tlen[i];
  if (out_cap < gw_stamp_bound(n, slice_bytes)) return -2;
  uint8_t suffix[11];
  uint8_t* sfx_end = put_varint(suffix + 1, (uint64_t)stamp_ms);
  suffix[0] = 0x50;  // field 10, varint
  const uint64_t suffix_len = (uint64_t)(sfx_end - suffix);
  uint8_t* o = out;
  for (int64_t i = 0; i < n; i++) {
    if (toff[i] < 0 || tlen[i] < 2 || toff[i] + tlen[i] > len ||
        data[toff[i]] != 0x0A)
      return -1;
    const uint8_t* tlv = data + toff[i];
    const uint8_t* tend = tlv + tlen[i];
    if (created[i] != 0) {  // the caller already stamped: verbatim
      std::memcpy(o, tlv, (size_t)tlen[i]);
      o += tlen[i];
      continue;
    }
    const uint8_t* p = tlv + 1;
    uint64_t plen;
    if (!read_varint(&p, tend, &plen) || (uint64_t)(tend - p) != plen)
      return -1;
    *o++ = 0x0A;
    o = put_varint(o, plen + suffix_len);
    std::memcpy(o, p, (size_t)plen);
    o += plen;
    std::memcpy(o, suffix, (size_t)suffix_len);
    o += suffix_len;
  }
  return (int64_t)(o - out);
}

// Delimits each top-level field-1 submessage (RateLimitResp) of a
// GetRateLimitsResp / GetPeerRateLimitsResp (gubernator_tpu/ops/
// _native.cpp › split_resp_items): its TLV range and its status (field
// 1 varint, 0 when omitted).  At most `cap` items (size it with
// gw_count_req_items: the framing is the same); returns n, or -1 on
// malformed input, an unknown top-level field or a wire type the scan
// does not model.
int64_t gw_split_resp_items(const uint8_t* data, int64_t len, int64_t cap,
                            uint64_t* tlv_off, uint64_t* tlv_len,
                            int32_t* status) {
  const uint8_t* p = data;
  const uint8_t* end = data + len;
  int64_t n = 0;
  while (p < end) {
    const uint8_t* tlv_start = p;
    uint64_t tag, l;
    if (n >= cap || !read_varint(&p, end, &tag) || tag != 0x0A ||
        !read_varint(&p, end, &l) || (uint64_t)(end - p) < l)
      return -1;
    const uint8_t* q = p;
    const uint8_t* qend = p + l;
    p = qend;
    int32_t st = 0;
    while (q < qend) {
      uint64_t t, v;
      if (!read_varint(&q, qend, &t)) return -1;
      switch (t & 7) {
        case 0:
          if (!read_varint(&q, qend, &v)) return -1;
          if ((t >> 3) == 1) st = (int32_t)v;
          break;
        case 2:
          if (!read_varint(&q, qend, &v) || (uint64_t)(qend - q) < v)
            return -1;
          q += v;
          break;
        case 1:
          if (qend - q < 8) return -1;
          q += 8;
          break;
        case 5:
          if (qend - q < 4) return -1;
          q += 4;
          break;
        default:
          return -1;
      }
    }
    tlv_off[n] = (uint64_t)(tlv_start - data);
    tlv_len[n] = (uint64_t)(qend - tlv_start);
    status[n] = st;
    n++;
  }
  return n;
}


// ---------------------------------------------------------------------------
// Key hashing over Python strings (held GIL; a failure sets a Python
// exception and returns -1).  Each item is a str (hashed as its UTF-8
// bytes) or bytes.  `mixed` = 0 writes RAW FNV-1a 64 (the JAX extension's
// fnv1a64_batch / fnv1a64_pair_batch), 1 the table key hash: mix64, then
// 0 remapped to 1 (hashing.hash_keys / hash_request_keys).

static bool utf8_view(PyObject* obj, const uint8_t** p, Py_ssize_t* n) {
  if (PyUnicode_Check(obj)) {
    const char* s = PyUnicode_AsUTF8AndSize(obj, n);
    if (s == nullptr) return false;
    *p = (const uint8_t*)s;
    return true;
  }
  if (PyBytes_Check(obj)) {
    *p = (const uint8_t*)PyBytes_AS_STRING(obj);
    *n = PyBytes_GET_SIZE(obj);
    return true;
  }
  PyErr_SetString(PyExc_TypeError, "expected str or bytes");
  return false;
}

static inline uint64_t finish(uint64_t h, int mixed) {
  if (!mixed) return h;
  h = mix64(h);
  return h == 0 ? 1 : h;
}

// hash(key) for each item of `keys`; `out` holds at least `cap` words.
int64_t gw_hash_keys(PyObject* keys, uint64_t* out, int64_t cap,
                     int mixed) {
  PyObject* seq = PySequence_Fast(keys, "expected a sequence");
  if (seq == nullptr) return -1;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  if (n > cap) {
    Py_DECREF(seq);
    PyErr_SetString(PyExc_ValueError, "output buffer too small");
    return -1;
  }
  PyObject** items = PySequence_Fast_ITEMS(seq);
  for (Py_ssize_t i = 0; i < n; i++) {
    const uint8_t* p;
    Py_ssize_t len;
    if (!utf8_view(items[i], &p, &len)) {
      Py_DECREF(seq);
      return -1;
    }
    out[i] = finish(fnv1a64(p, (uint64_t)len, FNV_OFFSET), mixed);
  }
  Py_DECREF(seq);
  return (int64_t)n;
}

// hash(name + "_" + unique_key) for each pair, without the joined string.
int64_t gw_hash_pairs(PyObject* names, PyObject* keys, uint64_t* out,
                      int64_t cap, int mixed) {
  PyObject* ns = PySequence_Fast(names, "expected a sequence");
  if (ns == nullptr) return -1;
  PyObject* ks = PySequence_Fast(keys, "expected a sequence");
  if (ks == nullptr) {
    Py_DECREF(ns);
    return -1;
  }
  Py_ssize_t n = PySequence_Fast_GET_SIZE(ns);
  int64_t ret = -1;
  if (PySequence_Fast_GET_SIZE(ks) != n) {
    PyErr_SetString(PyExc_ValueError, "length mismatch");
  } else if (n > cap) {
    PyErr_SetString(PyExc_ValueError, "output buffer too small");
  } else {
    PyObject** ni = PySequence_Fast_ITEMS(ns);
    PyObject** ki = PySequence_Fast_ITEMS(ks);
    const uint8_t us = '_';
    ret = (int64_t)n;
    for (Py_ssize_t i = 0; i < n; i++) {
      const uint8_t *pn, *pk;
      Py_ssize_t ln, lk;
      if (!utf8_view(ni[i], &pn, &ln) || !utf8_view(ki[i], &pk, &lk)) {
        ret = -1;
        break;
      }
      uint64_t h = fnv1a64(pn, (uint64_t)ln, FNV_OFFSET);
      h = fnv1a64(&us, 1, h);
      out[i] = finish(fnv1a64(pk, (uint64_t)lk, h), mixed);
    }
  }
  Py_DECREF(ns);
  Py_DECREF(ks);
  return ret;
}

}  // extern "C"
