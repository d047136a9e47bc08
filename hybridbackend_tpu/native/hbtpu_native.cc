// Native host-side hot loops for the input pipeline.
//
// The JAX equivalent of the reference's C++ data plane
// (/root/reference/hybridbackend/tensorflow/data/rebatch/rebatch_buffer.cc,
// tensorflow/common/arrow.cc, common/murmur3.cu.h): the Arrow decode
// itself is already C++ (pyarrow), so what remains hot on the host are
// the ragged-batch transforms between Arrow buffers and device-ready
// padded layouts. These run once per batch on the input thread and must
// not steal cycles from the Python driver.
//
// Exposed via a plain C ABI and loaded with ctypes (no pybind11 in this
// image). All functions are single-pass, branch-light, and operate on
// caller-allocated buffers.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Open-addressing int64 -> int32 hash map with linear probing and
// tombstone deletion. This is the host-side counterpart of the
// reference's device slab hash probed by warp-cooperative kernels
// (/root/reference/hybridbackend/tensorflow/embedding/lookup_functors.cu.cc:40-170,
// lookup_ops.cc:38-151): here the id->row/slot resolution happens on
// the host input path, so it must run at memory speed, not at Python
// dict speed.
struct IdMap {
  static constexpr int64_t kEmpty = INT64_MIN;
  static constexpr int64_t kTomb = INT64_MIN + 1;
  std::vector<int64_t> keys;
  std::vector<int32_t> vals;
  uint64_t mask = 0;
  int64_t live = 0;    // live entries
  int64_t filled = 0;  // live + tombstones
  // Raw ids equal to the slot sentinels live in a 2-entry side table
  // (unbounded int64 id spaces may legitimately contain them).
  int32_t special_vals[2] = {0, 0};
  bool special_live[2] = {false, false};

  static inline int special_index(int64_t id) {
    if (id == kEmpty) return 0;
    if (id == kTomb) return 1;
    return -1;
  }

  explicit IdMap(int64_t hint) {
    uint64_t cap = 64;
    while (cap < static_cast<uint64_t>(hint) * 2) cap <<= 1;
    keys.assign(cap, kEmpty);
    vals.assign(cap, 0);
    mask = cap - 1;
  }

  static inline uint64_t hash(int64_t id) {
    uint64_t k = static_cast<uint64_t>(id);
    k ^= k >> 33;
    k *= 0xff51afd7ed558ccdULL;
    k ^= k >> 33;
    k *= 0xc4ceb9fe1a85ec53ULL;
    k ^= k >> 33;
    return k;
  }

  // Returns slot of key, or ~insert_slot if absent.
  inline int64_t find(int64_t id) const {
    uint64_t i = hash(id) & mask;
    int64_t first_tomb = -1;
    for (;;) {
      int64_t k = keys[i];
      if (k == id) return static_cast<int64_t>(i);
      if (k == kEmpty)
        return ~(first_tomb >= 0 ? first_tomb : static_cast<int64_t>(i));
      if (k == kTomb && first_tomb < 0) first_tomb = static_cast<int64_t>(i);
      i = (i + 1) & mask;
    }
  }

  void grow() {
    std::vector<int64_t> old_keys;
    std::vector<int32_t> old_vals;
    old_keys.swap(keys);
    old_vals.swap(vals);
    uint64_t cap = (mask + 1) * 2;
    keys.assign(cap, kEmpty);
    vals.assign(cap, 0);
    mask = cap - 1;
    filled = live;
    for (size_t j = 0; j < old_keys.size(); ++j) {
      int64_t k = old_keys[j];
      if (k == kEmpty || k == kTomb) continue;
      uint64_t i = hash(k) & mask;
      while (keys[i] != kEmpty) i = (i + 1) & mask;
      keys[i] = k;
      vals[i] = old_vals[j];
    }
  }

  inline void put_at(int64_t slot, int64_t id, int32_t v) {
    if (keys[slot] == kEmpty) ++filled;
    keys[slot] = id;
    vals[slot] = v;
    ++live;
    if (filled * 10 >= static_cast<int64_t>(mask + 1) * 7) grow();
  }
};

}  // namespace

extern "C" {

void* hb_idmap_new(int64_t capacity_hint) {
  return new IdMap(capacity_hint > 0 ? capacity_hint : 64);
}

void hb_idmap_free(void* h) { delete static_cast<IdMap*>(h); }

int64_t hb_idmap_size(void* h) { return static_cast<IdMap*>(h)->live; }

// Read-only batch probe (thread-parallel): out[i] = value of ids[i], or
// `missing` when absent or unadmitted (pending min_count).
void hb_idmap_lookup(void* h, const int64_t* ids, int64_t n, int32_t* out,
                     int32_t missing, int32_t nthreads) {
  const IdMap* m = static_cast<IdMap*>(h);
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      int si = IdMap::special_index(ids[i]);
      if (si >= 0) {
        out[i] = (m->special_live[si] && m->special_vals[si] >= 0)
                     ? m->special_vals[si] : missing;
        continue;
      }
      int64_t s = m->find(ids[i]);
      if (s >= 0 && m->vals[s] >= 0) out[i] = m->vals[s];
      else out[i] = missing;
    }
  };
  if (nthreads <= 1 || n < (1 << 15)) {
    work(0, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (n + nthreads - 1) / nthreads;
  for (int32_t t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    ts.emplace_back(work, lo, hi);
  }
  for (auto& t : ts) t.join();
}

// Ordered lookup-or-assign for training (DeepRec EV first-touch row
// assignment + counter-based admission filter): known admitted ids
// return their row; new ids get next_row++ while next_row < max_rows
// (table full -> -1, cold); with min_count > 1 an id must be seen
// min_count times before admission (pending encoded as val = -1-count).
// Returns the updated next_row.
int64_t hb_idmap_train_lookup(void* h, const int64_t* ids, int64_t n,
                              int32_t* out, int64_t max_rows,
                              int64_t next_row, int32_t min_count) {
  IdMap* m = static_cast<IdMap*>(h);
  for (int64_t i = 0; i < n; ++i) {
    int64_t id = ids[i];
    int si = IdMap::special_index(id);
    if (si >= 0) {
      // Sentinel-valued ids: same admission state machine over the
      // side table.
      if (!m->special_live[si]) {
        if (min_count <= 1) {
          if (next_row < max_rows) {
            m->special_vals[si] = static_cast<int32_t>(next_row);
            m->special_live[si] = true;
            ++m->live;
            out[i] = static_cast<int32_t>(next_row);
            ++next_row;
          } else {
            out[i] = -1;
          }
        } else {
          m->special_vals[si] = -2;
          m->special_live[si] = true;
          ++m->live;
          out[i] = -1;
        }
        continue;
      }
      int32_t v = m->special_vals[si];
      if (v >= 0) {
        out[i] = v;
        continue;
      }
      int32_t count = -1 - v;
      if (count + 1 >= min_count) {
        if (next_row < max_rows) {
          m->special_vals[si] = static_cast<int32_t>(next_row);
          out[i] = static_cast<int32_t>(next_row);
          ++next_row;
        } else {
          out[i] = -1;
        }
      } else {
        m->special_vals[si] = -1 - (count + 1);
        out[i] = -1;
      }
      continue;
    }
    int64_t s = m->find(id);
    if (s >= 0) {
      int32_t v = m->vals[s];
      if (v >= 0) {
        out[i] = v;
        continue;
      }
      int32_t count = -1 - v;  // pending occurrences so far
      if (count + 1 >= min_count) {
        if (next_row < max_rows) {
          m->vals[s] = static_cast<int32_t>(next_row);
          out[i] = static_cast<int32_t>(next_row);
          ++next_row;
        } else {
          out[i] = -1;  // full: stays cold (static-capacity tradeoff)
        }
      } else {
        m->vals[s] = -1 - (count + 1);
        out[i] = -1;
      }
      continue;
    }
    if (min_count <= 1) {
      if (next_row < max_rows) {
        m->put_at(~s, id, static_cast<int32_t>(next_row));
        out[i] = static_cast<int32_t>(next_row);
        ++next_row;
      } else {
        out[i] = -1;
      }
    } else {
      m->put_at(~s, id, -2);  // pending, count 1
      out[i] = -1;
    }
  }
  return next_row;
}

// Bulk insert/overwrite (checkpoint restore, cache slot assignment).
void hb_idmap_set(void* h, const int64_t* ids, const int32_t* rows,
                  int64_t n) {
  IdMap* m = static_cast<IdMap*>(h);
  for (int64_t i = 0; i < n; ++i) {
    int si = IdMap::special_index(ids[i]);
    if (si >= 0) {
      if (!m->special_live[si]) {
        m->special_live[si] = true;
        ++m->live;
      }
      m->special_vals[si] = rows[i];
      continue;
    }
    int64_t s = m->find(ids[i]);
    if (s >= 0) m->vals[s] = rows[i];
    else m->put_at(~s, ids[i], rows[i]);
  }
}

// Bulk erase (cache eviction).
void hb_idmap_erase(void* h, const int64_t* ids, int64_t n) {
  IdMap* m = static_cast<IdMap*>(h);
  for (int64_t i = 0; i < n; ++i) {
    int si = IdMap::special_index(ids[i]);
    if (si >= 0) {
      if (m->special_live[si]) {
        m->special_live[si] = false;
        --m->live;
      }
      continue;
    }
    int64_t s = m->find(ids[i]);
    if (s >= 0) {
      m->keys[s] = IdMap::kTomb;
      --m->live;
    }
  }
}

// Dump admitted (value >= 0) pairs; returns the count written. Buffers
// must hold hb_idmap_size entries.
int64_t hb_idmap_items(void* h, int64_t* ids_out, int32_t* rows_out) {
  const IdMap* m = static_cast<IdMap*>(h);
  int64_t j = 0;
  const int64_t specials[2] = {IdMap::kEmpty, IdMap::kTomb};
  for (int si = 0; si < 2; ++si) {
    if (m->special_live[si] && m->special_vals[si] >= 0) {
      ids_out[j] = specials[si];
      rows_out[j] = m->special_vals[si];
      ++j;
    }
  }
  for (size_t i = 0; i < m->keys.size(); ++i) {
    int64_t k = m->keys[i];
    if (k == IdMap::kEmpty || k == IdMap::kTomb) continue;
    if (m->vals[i] < 0) continue;
    ids_out[j] = k;
    rows_out[j] = m->vals[i];
    ++j;
  }
  return j;
}

// Dump EVERY live entry with its RAW value: admitted rows >= 0, pending
// min_count admission progress encoded as val = -1 - count (see
// hb_idmap_train_lookup). Checkpoints serialize this so partially
// admitted ids resume their counters instead of restarting from zero.
// Buffers must hold hb_idmap_size entries; returns the count written.
int64_t hb_idmap_items_all(void* h, int64_t* ids_out, int32_t* vals_out) {
  const IdMap* m = static_cast<IdMap*>(h);
  int64_t j = 0;
  const int64_t specials[2] = {IdMap::kEmpty, IdMap::kTomb};
  for (int si = 0; si < 2; ++si) {
    if (m->special_live[si]) {
      ids_out[j] = specials[si];
      vals_out[j] = m->special_vals[si];
      ++j;
    }
  }
  for (size_t i = 0; i < m->keys.size(); ++i) {
    int64_t k = m->keys[i];
    if (k == IdMap::kEmpty || k == IdMap::kTomb) continue;
    ids_out[j] = k;
    vals_out[j] = m->vals[i];
    ++j;
  }
  return j;
}

// Ragged -> padded-dense + mask. values has `inner` contiguous elements
// per logical item (inner = product of trailing dense dims).
// out: [n, max_len, inner] pre-filled with pad; mask: [n, max_len] u8.
void ragged_to_padded_f32(const float* values, const int64_t* splits,
                          int64_t n, int64_t max_len, int64_t inner,
                          float* out, uint8_t* mask) {
  for (int64_t i = 0; i < n; ++i) {
    int64_t start = splits[i];
    int64_t len = splits[i + 1] - start;
    if (len > max_len) len = max_len;
    std::memcpy(out + (i * max_len) * inner, values + start * inner,
                static_cast<size_t>(len * inner) * sizeof(float));
    std::memset(mask + i * max_len, 1, static_cast<size_t>(len));
  }
}

void ragged_to_padded_i64(const int64_t* values, const int64_t* splits,
                          int64_t n, int64_t max_len, int64_t inner,
                          int64_t* out, uint8_t* mask) {
  for (int64_t i = 0; i < n; ++i) {
    int64_t start = splits[i];
    int64_t len = splits[i + 1] - start;
    if (len > max_len) len = max_len;
    std::memcpy(out + (i * max_len) * inner, values + start * inner,
                static_cast<size_t>(len * inner) * sizeof(int64_t));
    std::memset(mask + i * max_len, 1, static_cast<size_t>(len));
  }
}

void ragged_to_padded_i32(const int32_t* values, const int64_t* splits,
                          int64_t n, int64_t max_len, int64_t inner,
                          int32_t* out, uint8_t* mask) {
  for (int64_t i = 0; i < n; ++i) {
    int64_t start = splits[i];
    int64_t len = splits[i + 1] - start;
    if (len > max_len) len = max_len;
    std::memcpy(out + (i * max_len) * inner, values + start * inner,
                static_cast<size_t>(len * inner) * sizeof(int32_t));
    std::memset(mask + i * max_len, 1, static_cast<size_t>(len));
  }
}

// Ragged row gather (shuffle/dedup-restore): out splits are prefix sums
// of the selected rows' lengths; out values are the selected rows'
// payloads, element size `esize` bytes (dtype-agnostic memcpy).
// Returns total output elements.
int64_t ragged_take_rows(const uint8_t* values, const int64_t* splits,
                         const int64_t* indices, int64_t n_idx,
                         int64_t esize, uint8_t* out_values,
                         int64_t* out_splits) {
  int64_t pos = 0;
  out_splits[0] = 0;
  for (int64_t j = 0; j < n_idx; ++j) {
    int64_t i = indices[j];
    int64_t start = splits[i];
    int64_t len = splits[i + 1] - start;
    std::memcpy(out_values + pos * esize, values + start * esize,
                static_cast<size_t>(len * esize));
    pos += len;
    out_splits[j + 1] = pos;
  }
  return pos;
}

// Dense row gather for arbitrary element size (rebatch/shuffle fast path).
void take_rows_dense(const uint8_t* values, const int64_t* indices,
                     int64_t n_idx, int64_t row_bytes, uint8_t* out) {
  for (int64_t j = 0; j < n_idx; ++j) {
    std::memcpy(out + j * row_bytes, values + indices[j] * row_bytes,
                static_cast<size_t>(row_bytes));
  }
}

// MurmurHash3 64-bit finalizer (reference common/murmur3.cu.h): id
// mixing for shard-balancing hot ids.
void murmur3_mix64(const int64_t* ids, int64_t n, uint64_t modulo,
                   int64_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    uint64_t k = static_cast<uint64_t>(ids[i]);
    k ^= k >> 33;
    k *= 0xff51afd7ed558ccdULL;
    k ^= k >> 33;
    k *= 0xc4ceb9fe1a85ec53ULL;
    k ^= k >> 33;
    out[i] = static_cast<int64_t>(modulo ? (k % modulo) : k);
  }
}

}  // extern "C"
