// Native tabular data plane for accelerator hosts.
//
// A JAX re-design of the reference's C++ data stack
// (/root/reference/hybridbackend/tensorflow/data/tabular/{dataset,parquet,
// orc,table}.cc, data/rebatch/rebatch_buffer.cc, data/prefetch/prefetch.cc):
// one pipeline that decodes Parquet row groups / ORC stripes with a thread
// pool (ordered emission), rebatches row slices into exact-size training
// batches, and prefetches decoded chunks ahead of the consumer. Batches are
// emitted zero-copy whenever a column is a single contiguous Arrow slice
// (the token keeps the Arrow tables alive); otherwise slices are
// concatenated with one memcpy per span.
//
// Exposed via a plain C ABI (no pybind11 in this image); loaded with
// ctypes. Links against the Arrow/Parquet C++ shipped inside pyarrow.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <arrow/api.h>
#include <arrow/adapters/orc/adapter.h>
#include <arrow/io/api.h>
#include <parquet/arrow/reader.h>
#include <parquet/column_reader.h>
#include <parquet/file_reader.h>
#include <parquet/metadata.h>
#include <parquet/schema.h>
#include <parquet/statistics.h>

namespace {

// Numpy-compatible dtype codes for the C ABI.
enum DTypeCode : int32_t {
  DT_INVALID = 0,
  DT_I8 = 1, DT_I16 = 2, DT_I32 = 3, DT_I64 = 4,
  DT_U8 = 5, DT_U16 = 6, DT_U32 = 7, DT_U64 = 8,
  DT_F32 = 10, DT_F64 = 11,
  DT_STRING = 20,  // values = utf-8 bytes, splits = char offsets
};

int32_t ArrowTypeToCode(const arrow::DataType& t) {
  switch (t.id()) {
    case arrow::Type::INT8: return DT_I8;
    case arrow::Type::INT16: return DT_I16;
    case arrow::Type::INT32: return DT_I32;
    case arrow::Type::INT64: return DT_I64;
    case arrow::Type::UINT8: return DT_U8;
    case arrow::Type::UINT16: return DT_U16;
    case arrow::Type::UINT32: return DT_U32;
    case arrow::Type::UINT64: return DT_U64;
    case arrow::Type::FLOAT: return DT_F32;
    case arrow::Type::DOUBLE: return DT_F64;
    default: return DT_INVALID;
  }
}

int64_t DTypeSize(int32_t code) {
  switch (code) {
    case DT_I8: case DT_U8: return 1;
    case DT_I16: case DT_U16: return 2;
    case DT_I32: case DT_U32: case DT_F32: return 4;
    default: return 8;
  }
}

struct ColDesc {  // must match the ctypes Structure on the Python side
  const void* values;
  int64_t num_values;
  const int64_t* splits;  // int64[nrows+1] when ragged, else nullptr
  int32_t dtype;
  int32_t ragged;         // 0 dense, 1 list, 2 string, 3 list<list>
  const int64_t* splits2; // rank-2: inner splits int64[num_inner+1]
  int64_t num_inner;      // rank-2: count of inner lists
};

// Keeps every buffer referenced by an emitted batch alive.
struct BatchToken {
  std::vector<std::shared_ptr<arrow::Table>> tables;
  std::vector<std::shared_ptr<arrow::Buffer>> owned;
};

struct Span {  // contiguous row range inside one decoded table
  std::shared_ptr<arrow::Table> table;
  int64_t start;
  int64_t length;
};

arrow::Status FillDefault(void* dst, int64_t i, int32_t code, double dflt) {
  switch (code) {
    case DT_I8: static_cast<int8_t*>(dst)[i] = (int8_t)dflt; break;
    case DT_I16: static_cast<int16_t*>(dst)[i] = (int16_t)dflt; break;
    case DT_I32: static_cast<int32_t*>(dst)[i] = (int32_t)dflt; break;
    case DT_I64: static_cast<int64_t*>(dst)[i] = (int64_t)dflt; break;
    case DT_U8: static_cast<uint8_t*>(dst)[i] = (uint8_t)dflt; break;
    case DT_U16: static_cast<uint16_t*>(dst)[i] = (uint16_t)dflt; break;
    case DT_U32: static_cast<uint32_t*>(dst)[i] = (uint32_t)dflt; break;
    case DT_U64: static_cast<uint64_t*>(dst)[i] = (uint64_t)dflt; break;
    case DT_F32: static_cast<float*>(dst)[i] = (float)dflt; break;
    case DT_F64: static_cast<double*>(dst)[i] = dflt; break;
    default: return arrow::Status::Invalid("bad dtype code");
  }
  return arrow::Status::OK();
}

// One column of one table as raw primitive storage.
struct PrimView {
  const uint8_t* data;     // element 0 of the array (offset applied)
  const uint8_t* validity; // may be null
  int64_t validity_offset;
  int64_t null_count;
};

arrow::Status GetPrimView(const arrow::Array& arr, int64_t esize,
                          PrimView* out) {
  const auto& d = *arr.data();
  if (d.buffers.size() < 2 || d.buffers[1] == nullptr) {
    return arrow::Status::Invalid("array has no data buffer");
  }
  out->data = d.buffers[1]->data() + d.offset * esize;
  out->null_count = arr.null_count();
  out->validity = (out->null_count > 0 && d.buffers[0] != nullptr)
      ? d.buffers[0]->data() : nullptr;
  out->validity_offset = d.offset;
  return arrow::Status::OK();
}

inline bool BitIsSet(const uint8_t* bits, int64_t i) {
  return (bits[i >> 3] >> (i & 7)) & 1;
}

// --------------------------------------------------------------------------
// RebatchBuffer: spans of decoded tables -> exact-size batches.
// Reference: rebatch_buffer.cc Put/Take dense & sparse paths.
// --------------------------------------------------------------------------

class RebatchBuffer {
 public:
  RebatchBuffer(std::vector<std::string> cols, std::vector<double> defaults,
                bool shuffle, int64_t seed)
      : cols_(std::move(cols)), defaults_(std::move(defaults)),
        shuffle_(shuffle), rng_(static_cast<uint64_t>(seed)) {}

  int64_t rows() const { return rows_; }

  void Put(std::shared_ptr<arrow::Table> table) {
    int64_t n = table->num_rows();
    if (n == 0) return;
    rows_ += n;
    chunks_.push_back({std::move(table), 0});
  }

  // Emits n rows into out[ncols]; allocations/tables recorded in token.
  //
  // Shuffle semantics: rows are drawn as random sub-runs (<= n/8 rows)
  // from RANDOM buffered chunks across the whole window (weighted by
  // availability), then permuted within the batch — rows genuinely mix
  // across row groups like the reference's shuffle buffer, while the
  // emit paths keep their contiguous-span memcpy fast path. (The
  // Python rebatcher additionally offers row-exact uniform window
  // sampling.)
  arrow::Status Take(int64_t n, ColDesc* out, BatchToken* token) {
    std::vector<Span> spans;
    int64_t got = 0;
    if (!shuffle_) {
      while (got < n) {
        auto& front = chunks_.front();
        int64_t avail = front.table->num_rows() - front.consumed;
        int64_t take = std::min(avail, n - got);
        spans.push_back({front.table, front.consumed, take});
        front.consumed += take;
        got += take;
        if (front.consumed == front.table->num_rows()) chunks_.pop_front();
      }
    } else {
      const int64_t max_run = std::max<int64_t>(1, n / 8);
      while (got < n) {
        int64_t remaining = rows_ - got;
        int64_t target = std::uniform_int_distribution<int64_t>(
            0, remaining - 1)(rng_);
        size_t ci = 0;
        for (; ci + 1 < chunks_.size(); ++ci) {
          int64_t avail =
              chunks_[ci].table->num_rows() - chunks_[ci].consumed;
          if (target < avail) break;
          target -= avail;
        }
        auto& ch = chunks_[ci];
        int64_t avail = ch.table->num_rows() - ch.consumed;
        int64_t take = std::min({avail, n - got, max_run});
        spans.push_back({ch.table, ch.consumed, take});
        ch.consumed += take;
        got += take;
        if (ch.consumed == ch.table->num_rows()) {
          chunks_.erase(chunks_.begin() + ci);
        }
      }
    }
    rows_ -= n;
    std::vector<int64_t> perm;
    if (shuffle_) {
      perm.resize(n);
      for (int64_t i = 0; i < n; ++i) perm[i] = i;
      std::shuffle(perm.begin(), perm.end(), rng_);
    }
    for (auto& s : spans) token->tables.push_back(s.table);
    for (size_t c = 0; c < cols_.size(); ++c) {
      ARROW_RETURN_NOT_OK(
          EmitColumn(static_cast<int>(c), spans, n, perm, &out[c], token));
    }
    return arrow::Status::OK();
  }

 private:
  // Resolve the (single) chunk of column c inside a span's table.
  static arrow::Status SpanArray(const Span& s, int c,
                                 std::shared_ptr<arrow::Array>* out) {
    auto col = s.table->column(c);
    if (col->num_chunks() != 1) {
      return arrow::Status::Invalid("expected single-chunk column");
    }
    *out = col->chunk(0);
    return arrow::Status::OK();
  }

  arrow::Status EmitColumn(int c, const std::vector<Span>& spans, int64_t n,
                           const std::vector<int64_t>& perm, ColDesc* out,
                           BatchToken* token) {
    std::shared_ptr<arrow::Array> first;
    ARROW_RETURN_NOT_OK(SpanArray(spans[0], c, &first));
    // All spans of a batch must agree on the physical type: the emit
    // paths memcpy with the first span's element size, so schema drift
    // across files must error here, never corrupt.
    for (size_t s = 1; s < spans.size(); ++s) {
      std::shared_ptr<arrow::Array> a;
      ARROW_RETURN_NOT_OK(SpanArray(spans[s], c, &a));
      if (!a->type()->Equals(*first->type())) {
        return arrow::Status::Invalid(
            "column ", cols_[c], ": schema drift across files (",
            first->type()->ToString(), " vs ", a->type()->ToString(),
            "); read heterogeneous files via the Python path");
      }
    }
    bool ragged = first->type_id() == arrow::Type::LIST ||
                  first->type_id() == arrow::Type::LARGE_LIST;
    if (ragged) {
      std::shared_ptr<arrow::Array> hold;
      const arrow::Array& child = ListValues(*first, &hold);
      if (child.type_id() == arrow::Type::LIST ||
          child.type_id() == arrow::Type::LARGE_LIST) {
        return EmitNestedRagged(c, spans, n, perm, out, token);
      }
      return EmitRagged(c, spans, n, perm, out, token);
    }
    if (first->type_id() == arrow::Type::STRING ||
        first->type_id() == arrow::Type::LARGE_STRING) {
      return EmitString(c, spans, n, perm, out, token);
    }
    return EmitDense(c, spans, n, perm, out, token);
  }

  static int64_t StrOffset(const arrow::Array& a, int64_t i) {
    if (a.type_id() == arrow::Type::STRING) {
      return static_cast<const arrow::StringArray&>(a).value_offset(i);
    }
    return static_cast<const arrow::LargeStringArray&>(a).value_offset(i);
  }

  static const uint8_t* StrData(const arrow::Array& a) {
    if (a.type_id() == arrow::Type::STRING) {
      return static_cast<const arrow::StringArray&>(a).value_data()->data();
    }
    return static_cast<const arrow::LargeStringArray&>(a)
        .value_data()->data();
  }

  arrow::Status EmitString(int c, const std::vector<Span>& spans,
                           int64_t n, const std::vector<int64_t>& perm,
                           ColDesc* out, BatchToken* token) {
    // Emitted as utf-8 bytes + int64 char offsets (nulls -> empty).
    out->dtype = DT_STRING;
    out->ragged = 2;
    ARROW_ASSIGN_OR_RAISE(auto obuf,
                          arrow::AllocateBuffer((n + 1) * sizeof(int64_t)));
    int64_t* offs = reinterpret_cast<int64_t*>(obuf->mutable_data());

    struct RowRef { const arrow::Array* a; int64_t i; };
    std::vector<std::shared_ptr<arrow::Array>> arrays;
    std::vector<RowRef> rows;
    rows.reserve(n);
    for (const auto& s : spans) {
      std::shared_ptr<arrow::Array> a;
      ARROW_RETURN_NOT_OK(SpanArray(s, c, &a));
      arrays.push_back(a);
      for (int64_t i = 0; i < s.length; ++i) {
        rows.push_back({arrays.back().get(), s.start + i});
      }
    }
    auto row_at = [&](int64_t r) -> const RowRef& {
      return rows[perm.empty() ? r : perm[r]];
    };
    offs[0] = 0;
    for (int64_t r = 0; r < n; ++r) {
      const RowRef& rr = row_at(r);
      bool valid = rr.a->null_count() == 0 || rr.a->IsValid(rr.i);
      int64_t len = valid
          ? StrOffset(*rr.a, rr.i + 1) - StrOffset(*rr.a, rr.i) : 0;
      offs[r + 1] = offs[r] + len;
    }
    int64_t total = offs[n];
    out->num_values = total;
    // Zero-copy bytes: one span, no nulls, no shuffle.
    if (spans.size() == 1 && perm.empty() &&
        arrays[0]->null_count() == 0) {
      out->values = StrData(*arrays[0]) +
                    StrOffset(*arrays[0], spans[0].start);
      out->splits = offs;
      token->owned.push_back(std::shared_ptr<arrow::Buffer>(std::move(obuf)));
      return arrow::Status::OK();
    }
    ARROW_ASSIGN_OR_RAISE(auto vbuf,
                          arrow::AllocateBuffer(std::max<int64_t>(total, 1)));
    uint8_t* dst = vbuf->mutable_data();
    for (int64_t r = 0; r < n; ++r) {
      const RowRef& rr = row_at(r);
      bool valid = rr.a->null_count() == 0 || rr.a->IsValid(rr.i);
      if (!valid) continue;
      int64_t b = StrOffset(*rr.a, rr.i);
      int64_t e = StrOffset(*rr.a, rr.i + 1);
      std::memcpy(dst + offs[r], StrData(*rr.a) + b,
                  static_cast<size_t>(e - b));
    }
    out->values = dst;
    out->splits = offs;
    token->owned.push_back(std::shared_ptr<arrow::Buffer>(std::move(obuf)));
    token->owned.push_back(std::shared_ptr<arrow::Buffer>(std::move(vbuf)));
    return arrow::Status::OK();
  }

  arrow::Status EmitDense(int c, const std::vector<Span>& spans, int64_t n,
                          const std::vector<int64_t>& perm, ColDesc* out,
                          BatchToken* token) {
    std::shared_ptr<arrow::Array> a0;
    ARROW_RETURN_NOT_OK(SpanArray(spans[0], c, &a0));
    int32_t code = ArrowTypeToCode(*a0->type());
    if (code == DT_INVALID) {
      return arrow::Status::Invalid("unsupported dtype for column ",
                                    cols_[c]);
    }
    int64_t esize = DTypeSize(code);
    out->dtype = code;
    out->ragged = 0;
    out->splits = nullptr;
    out->num_values = n;
    // Zero-copy fast path: one span, no nulls, no shuffle.
    if (spans.size() == 1 && perm.empty() && a0->null_count() == 0) {
      PrimView v;
      ARROW_RETURN_NOT_OK(GetPrimView(*a0, esize, &v));
      out->values = v.data + spans[0].start * esize;
      return arrow::Status::OK();
    }
    ARROW_ASSIGN_OR_RAISE(auto buf, arrow::AllocateBuffer(n * esize));
    uint8_t* dst = buf->mutable_data();
    int64_t pos = 0;
    for (const auto& s : spans) {
      std::shared_ptr<arrow::Array> a;
      ARROW_RETURN_NOT_OK(SpanArray(s, c, &a));
      PrimView v;
      ARROW_RETURN_NOT_OK(GetPrimView(*a, esize, &v));
      std::memcpy(dst + pos * esize, v.data + s.start * esize,
                  static_cast<size_t>(s.length * esize));
      if (v.validity != nullptr) {
        for (int64_t i = 0; i < s.length; ++i) {
          if (!BitIsSet(v.validity, v.validity_offset + s.start + i)) {
            ARROW_RETURN_NOT_OK(
                FillDefault(dst, pos + i, code, defaults_[c]));
          }
        }
      }
      pos += s.length;
    }
    if (!perm.empty()) {
      ARROW_ASSIGN_OR_RAISE(auto sbuf, arrow::AllocateBuffer(n * esize));
      uint8_t* sdst = sbuf->mutable_data();
      for (int64_t i = 0; i < n; ++i) {
        std::memcpy(sdst + i * esize, dst + perm[i] * esize,
                    static_cast<size_t>(esize));
      }
      out->values = sdst;
      token->owned.push_back(std::shared_ptr<arrow::Buffer>(std::move(sbuf)));
      return arrow::Status::OK();
    }
    out->values = dst;
    token->owned.push_back(std::shared_ptr<arrow::Buffer>(std::move(buf)));
    return arrow::Status::OK();
  }

  // value_offset(i) of list arrays, generic over LIST/LARGE_LIST.
  static int64_t ListOffset(const arrow::Array& a, int64_t i) {
    if (a.type_id() == arrow::Type::LIST) {
      return static_cast<const arrow::ListArray&>(a).value_offset(i);
    }
    return static_cast<const arrow::LargeListArray&>(a).value_offset(i);
  }

  static const arrow::Array& ListValues(
      const arrow::Array& a, std::shared_ptr<arrow::Array>* hold) {
    if (a.type_id() == arrow::Type::LIST) {
      *hold = static_cast<const arrow::ListArray&>(a).values();
    } else {
      *hold = static_cast<const arrow::LargeListArray&>(a).values();
    }
    return **hold;
  }

  arrow::Status EmitRagged(int c, const std::vector<Span>& spans, int64_t n,
                           const std::vector<int64_t>& perm, ColDesc* out,
                           BatchToken* token) {
    std::shared_ptr<arrow::Array> a0;
    ARROW_RETURN_NOT_OK(SpanArray(spans[0], c, &a0));
    std::shared_ptr<arrow::Array> hold0;
    const arrow::Array& v0 = ListValues(*a0, &hold0);
    int32_t code = ArrowTypeToCode(*v0.type());
    if (code == DT_INVALID) {
      return arrow::Status::Invalid("unsupported ragged value dtype for ",
                                    cols_[c]);
    }
    int64_t esize = DTypeSize(code);
    out->dtype = code;
    out->ragged = 1;

    // Splits always materialize (rebased to zero); int64 for the ABI.
    ARROW_ASSIGN_OR_RAISE(auto sbuf,
                          arrow::AllocateBuffer((n + 1) * sizeof(int64_t)));
    int64_t* splits = reinterpret_cast<int64_t*>(sbuf->mutable_data());

    if (perm.empty()) {
      // Pass 1: lengths -> splits.
      splits[0] = 0;
      int64_t row = 0;
      for (const auto& s : spans) {
        std::shared_ptr<arrow::Array> a;
        ARROW_RETURN_NOT_OK(SpanArray(s, c, &a));
        for (int64_t i = 0; i < s.length; ++i) {
          bool valid = a->null_count() == 0 || a->IsValid(s.start + i);
          int64_t len = valid ? ListOffset(*a, s.start + i + 1) -
                                    ListOffset(*a, s.start + i)
                              : 0;  // null list -> empty row
          splits[row + 1] = splits[row] + len;
          ++row;
        }
      }
      int64_t total = splits[n];
      out->num_values = total;
      // Zero-copy values: single span, child not sliced, no null lists.
      if (spans.size() == 1 && a0->null_count() == 0 &&
          v0.null_count() == 0 && v0.offset() == 0) {
        PrimView v;
        ARROW_RETURN_NOT_OK(GetPrimView(v0, esize, &v));
        out->values = v.data + ListOffset(*a0, spans[0].start) * esize;
        out->splits = splits;
        token->owned.push_back(
            std::shared_ptr<arrow::Buffer>(std::move(sbuf)));
        return arrow::Status::OK();
      }
      ARROW_ASSIGN_OR_RAISE(auto vbuf, arrow::AllocateBuffer(total * esize));
      uint8_t* dst = vbuf->mutable_data();
      int64_t pos = 0;
      for (const auto& s : spans) {
        std::shared_ptr<arrow::Array> a;
        ARROW_RETURN_NOT_OK(SpanArray(s, c, &a));
        std::shared_ptr<arrow::Array> hold;
        const arrow::Array& vals = ListValues(*a, &hold);
        PrimView v;
        ARROW_RETURN_NOT_OK(GetPrimView(vals, esize, &v));
        for (int64_t i = 0; i < s.length; ++i) {
          bool valid = a->null_count() == 0 || a->IsValid(s.start + i);
          if (!valid) continue;
          int64_t b = ListOffset(*a, s.start + i);
          int64_t e = ListOffset(*a, s.start + i + 1);
          std::memcpy(dst + pos * esize, v.data + b * esize,
                      static_cast<size_t>((e - b) * esize));
          if (v.validity != nullptr) {
            for (int64_t k = b; k < e; ++k) {
              if (!BitIsSet(v.validity, v.validity_offset + k)) {
                ARROW_RETURN_NOT_OK(
                    FillDefault(dst, pos + (k - b), code, defaults_[c]));
              }
            }
          }
          pos += e - b;
        }
      }
      out->values = dst;
      out->splits = splits;
      token->owned.push_back(std::shared_ptr<arrow::Buffer>(std::move(sbuf)));
      token->owned.push_back(std::shared_ptr<arrow::Buffer>(std::move(vbuf)));
      return arrow::Status::OK();
    }

    // Shuffled ragged take: per output row, locate its span/row and copy.
    struct RowRef { const arrow::Array* a; int64_t i; const PrimView* v; };
    std::vector<std::shared_ptr<arrow::Array>> arrays;
    std::vector<std::shared_ptr<arrow::Array>> holds;
    std::vector<PrimView> views;
    arrays.reserve(spans.size());
    views.reserve(spans.size());
    std::vector<RowRef> rows(n);
    {
      int64_t row = 0;
      for (const auto& s : spans) {
        std::shared_ptr<arrow::Array> a;
        ARROW_RETURN_NOT_OK(SpanArray(s, c, &a));
        std::shared_ptr<arrow::Array> hold;
        const arrow::Array& vals = ListValues(*a, &hold);
        PrimView v;
        ARROW_RETURN_NOT_OK(GetPrimView(vals, esize, &v));
        arrays.push_back(a);
        holds.push_back(hold);
        views.push_back(v);
        for (int64_t i = 0; i < s.length; ++i) {
          rows[row++] = {arrays.back().get(), s.start + i, nullptr};
        }
        // (PrimView pointer fixed up below once vectors stop growing.)
      }
      size_t si = 0;
      int64_t acc = 0;
      for (int64_t r = 0; r < n; ++r) {
        if (r - acc >= spans[si].length) { acc += spans[si].length; ++si; }
        rows[r].v = &views[si];
      }
    }
    splits[0] = 0;
    for (int64_t r = 0; r < n; ++r) {
      const RowRef& rr = rows[perm[r]];
      bool valid = rr.a->null_count() == 0 || rr.a->IsValid(rr.i);
      int64_t len = valid
          ? ListOffset(*rr.a, rr.i + 1) - ListOffset(*rr.a, rr.i) : 0;
      splits[r + 1] = splits[r] + len;
    }
    int64_t total = splits[n];
    out->num_values = total;
    ARROW_ASSIGN_OR_RAISE(auto vbuf, arrow::AllocateBuffer(total * esize));
    uint8_t* dst = vbuf->mutable_data();
    for (int64_t r = 0; r < n; ++r) {
      const RowRef& rr = rows[perm[r]];
      bool valid = rr.a->null_count() == 0 || rr.a->IsValid(rr.i);
      if (!valid) continue;
      int64_t b = ListOffset(*rr.a, rr.i);
      int64_t e = ListOffset(*rr.a, rr.i + 1);
      std::memcpy(dst + splits[r] * esize, rr.v->data + b * esize,
                  static_cast<size_t>((e - b) * esize));
      if (rr.v->validity != nullptr) {
        for (int64_t k = b; k < e; ++k) {
          if (!BitIsSet(rr.v->validity, rr.v->validity_offset + k)) {
            ARROW_RETURN_NOT_OK(FillDefault(
                dst, splits[r] + (k - b), code, defaults_[c]));
          }
        }
      }
    }
    out->values = dst;
    out->splits = splits;
    token->owned.push_back(std::shared_ptr<arrow::Buffer>(std::move(sbuf)));
    token->owned.push_back(std::shared_ptr<arrow::Buffer>(std::move(vbuf)));
    return arrow::Status::OK();
  }

  arrow::Status EmitNestedRagged(int c, const std::vector<Span>& spans,
                                 int64_t n,
                                 const std::vector<int64_t>& perm,
                                 ColDesc* out, BatchToken* token) {
    // rank-2 list<list<prim>> column (reference nested row_splits,
    // dataframe.py:282-396): emitted as values + TWO rebased split
    // levels — outer int64[n+1] indexing inner lists, inner
    // int64[num_inner+1] indexing values. Deeper nesting stays on the
    // Python path (the dataset-level type gate routes it there).
    struct SpanCtx {
      std::shared_ptr<arrow::Array> outer;
      std::shared_ptr<arrow::Array> hold_in;
      const arrow::Array* inner;
      std::shared_ptr<arrow::Array> hold_leaf;
      PrimView leaf;
    };
    std::vector<SpanCtx> ctxs(spans.size());
    int32_t code = DT_INVALID;
    int64_t esize = 0;
    for (size_t s = 0; s < spans.size(); ++s) {
      SpanCtx& ctx = ctxs[s];
      ARROW_RETURN_NOT_OK(SpanArray(spans[s], c, &ctx.outer));
      ctx.inner = &ListValues(*ctx.outer, &ctx.hold_in);
      if (ctx.inner->type_id() != arrow::Type::LIST &&
          ctx.inner->type_id() != arrow::Type::LARGE_LIST) {
        return arrow::Status::Invalid("column ", cols_[c],
                                      ": expected list<list<T>>");
      }
      const arrow::Array& leaf = ListValues(*ctx.inner, &ctx.hold_leaf);
      if (leaf.type_id() == arrow::Type::LIST ||
          leaf.type_id() == arrow::Type::LARGE_LIST) {
        return arrow::Status::Invalid(
            "column ", cols_[c],
            ": ragged_rank > 2 is not native; read via the Python path");
      }
      if (s == 0) {
        code = ArrowTypeToCode(*leaf.type());
        if (code == DT_INVALID) {
          return arrow::Status::Invalid(
              "unsupported nested ragged value dtype for ", cols_[c]);
        }
        esize = DTypeSize(code);
      }
      ARROW_RETURN_NOT_OK(GetPrimView(leaf, esize, &ctx.leaf));
      if (ctx.inner->offset() != 0) {
        // Outer offsets index the UNSLICED child; a sliced inner list
        // array would shift its offsets buffer under us.
        return arrow::Status::Invalid(
            "column ", cols_[c],
            ": sliced nested child unsupported; read via Python path");
      }
    }
    out->dtype = code;
    out->ragged = 3;

    std::vector<std::pair<int32_t, int64_t>> rows;
    rows.reserve(n);
    for (size_t s = 0; s < spans.size(); ++s) {
      for (int64_t i = 0; i < spans[s].length; ++i) {
        rows.emplace_back(static_cast<int32_t>(s), spans[s].start + i);
      }
    }
    auto row_at = [&](int64_t r) -> const std::pair<int32_t, int64_t>& {
      return rows[perm.empty() ? r : perm[r]];
    };

    // Pass 1: outer splits (inner-list count per row; null row -> 0).
    ARROW_ASSIGN_OR_RAISE(auto obuf,
                          arrow::AllocateBuffer((n + 1) * sizeof(int64_t)));
    int64_t* osp = reinterpret_cast<int64_t*>(obuf->mutable_data());
    osp[0] = 0;
    for (int64_t r = 0; r < n; ++r) {
      const auto& rr = row_at(r);
      const SpanCtx& ctx = ctxs[rr.first];
      bool valid = ctx.outer->null_count() == 0 ||
                   ctx.outer->IsValid(rr.second);
      int64_t len = valid ? ListOffset(*ctx.outer, rr.second + 1) -
                                ListOffset(*ctx.outer, rr.second)
                          : 0;
      osp[r + 1] = osp[r] + len;
    }
    int64_t n_inner = osp[n];
    out->num_inner = n_inner;

    // Pass 2: inner splits (value count per inner list; null -> 0).
    ARROW_ASSIGN_OR_RAISE(
        auto ibuf, arrow::AllocateBuffer((n_inner + 1) * sizeof(int64_t)));
    int64_t* isp = reinterpret_cast<int64_t*>(ibuf->mutable_data());
    isp[0] = 0;
    int64_t pos = 0;
    for (int64_t r = 0; r < n; ++r) {
      const auto& rr = row_at(r);
      const SpanCtx& ctx = ctxs[rr.first];
      bool valid = ctx.outer->null_count() == 0 ||
                   ctx.outer->IsValid(rr.second);
      if (!valid) continue;
      int64_t b = ListOffset(*ctx.outer, rr.second);
      int64_t e = ListOffset(*ctx.outer, rr.second + 1);
      for (int64_t j = b; j < e; ++j) {
        bool ivalid = ctx.inner->null_count() == 0 ||
                      ctx.inner->IsValid(j);
        int64_t ilen = ivalid ? ListOffset(*ctx.inner, j + 1) -
                                    ListOffset(*ctx.inner, j)
                              : 0;
        isp[pos + 1] = isp[pos] + ilen;
        ++pos;
      }
    }
    int64_t total = isp[n_inner];
    out->num_values = total;

    // Values. Zero-copy: one span, no shuffle, nothing null anywhere —
    // the span's whole value range is contiguous in the leaf buffer.
    const SpanCtx& c0 = ctxs[0];
    if (spans.size() == 1 && perm.empty() &&
        c0.outer->null_count() == 0 && c0.inner->null_count() == 0 &&
        c0.leaf.null_count == 0) {
      int64_t first_inner = ListOffset(*c0.outer, spans[0].start);
      int64_t first_val = ListOffset(*c0.inner, first_inner);
      out->values = c0.leaf.data + first_val * esize;
      out->splits = osp;
      out->splits2 = isp;
      token->owned.push_back(std::shared_ptr<arrow::Buffer>(std::move(obuf)));
      token->owned.push_back(std::shared_ptr<arrow::Buffer>(std::move(ibuf)));
      return arrow::Status::OK();
    }
    ARROW_ASSIGN_OR_RAISE(
        auto vbuf, arrow::AllocateBuffer(std::max<int64_t>(total, 1) * esize));
    uint8_t* dst = vbuf->mutable_data();
    pos = 0;        // inner-list cursor (isp index)
    for (int64_t r = 0; r < n; ++r) {
      const auto& rr = row_at(r);
      const SpanCtx& ctx = ctxs[rr.first];
      bool valid = ctx.outer->null_count() == 0 ||
                   ctx.outer->IsValid(rr.second);
      if (!valid) continue;
      int64_t b = ListOffset(*ctx.outer, rr.second);
      int64_t e = ListOffset(*ctx.outer, rr.second + 1);
      for (int64_t j = b; j < e; ++j, ++pos) {
        bool ivalid = ctx.inner->null_count() == 0 ||
                      ctx.inner->IsValid(j);
        if (!ivalid) continue;
        int64_t vb = ListOffset(*ctx.inner, j);
        int64_t ve = ListOffset(*ctx.inner, j + 1);
        std::memcpy(dst + isp[pos] * esize, ctx.leaf.data + vb * esize,
                    static_cast<size_t>((ve - vb) * esize));
        if (ctx.leaf.validity != nullptr) {
          for (int64_t k = vb; k < ve; ++k) {
            if (!BitIsSet(ctx.leaf.validity,
                          ctx.leaf.validity_offset + k)) {
              ARROW_RETURN_NOT_OK(FillDefault(
                  dst, isp[pos] + (k - vb), code, defaults_[c]));
            }
          }
        }
      }
    }
    out->values = dst;
    out->splits = osp;
    out->splits2 = isp;
    token->owned.push_back(std::shared_ptr<arrow::Buffer>(std::move(obuf)));
    token->owned.push_back(std::shared_ptr<arrow::Buffer>(std::move(ibuf)));
    token->owned.push_back(std::shared_ptr<arrow::Buffer>(std::move(vbuf)));
    return arrow::Status::OK();
  }

  struct Chunk {
    std::shared_ptr<arrow::Table> table;
    int64_t consumed;
  };

  std::vector<std::string> cols_;
  std::vector<double> defaults_;
  bool shuffle_;
  std::mt19937_64 rng_;
  std::deque<Chunk> chunks_;
  int64_t rows_ = 0;
};

// --------------------------------------------------------------------------
// TableAccess: format-specific chunk readers (reference table.h:34-100).
// --------------------------------------------------------------------------

class TableAccess {
 public:
  virtual ~TableAccess() = default;
  virtual arrow::Status ReadChunk(int chunk,
                                  std::shared_ptr<arrow::Table>* out) = 0;
};

class ParquetAccess : public TableAccess {
 public:
  static arrow::Status Open(const std::string& path,
                            const std::vector<std::string>& cols, bool mmap,
                            std::unique_ptr<TableAccess>* out) {
    std::shared_ptr<arrow::io::RandomAccessFile> file;
    if (mmap) {
      ARROW_ASSIGN_OR_RAISE(file, arrow::io::MemoryMappedFile::Open(
                                      path, arrow::io::FileMode::READ));
    } else {
      ARROW_ASSIGN_OR_RAISE(file, arrow::io::ReadableFile::Open(path));
    }
    auto access = std::make_unique<ParquetAccess>();
    ARROW_ASSIGN_OR_RAISE(
        access->reader_,
        parquet::arrow::OpenFile(file, arrow::default_memory_pool()));
    access->reader_->set_use_threads(false);
    std::shared_ptr<arrow::Schema> schema;
    ARROW_RETURN_NOT_OK(access->reader_->GetSchema(&schema));
    const auto* pq_schema = access->reader_->parquet_reader()
                                ->metadata()->schema();
    for (const auto& name : cols) {
      int idx = schema->GetFieldIndex(name);
      if (idx < 0) {
        return arrow::Status::Invalid("column not in file: ", name);
      }
      access->col_indices_.push_back(idx);
      access->names_.push_back(name);
      // Flat-primitive fast-path eligibility (see ReadChunk): the
      // arrow type must be exactly int32/int64/float/double AND the
      // parquet leaf must be flat (no repetition) — then the low-level
      // TypedColumnReader decodes pages straight into the output
      // buffer, skipping arrow's RecordReader/chunked-builder
      // assembly (measured 5-10x on the headline 200-int64-column
      // benchmark file: 62-107 -> 9-11 ms/row-group single-threaded).
      FastCol fc;
      fc.arrow_type = schema->field(idx)->type();
      fc.pq_index = pq_schema->ColumnIndex(name);
      if (fc.pq_index >= 0) {
        const auto* descr = pq_schema->Column(fc.pq_index);
        fc.max_def = descr->max_definition_level();
        if (descr->max_repetition_level() == 0) {
          // Arrow logical type must equal the parquet physical type
          // 1:1 (excludes timestamps/decimals riding INT64, etc.).
          auto phys = descr->physical_type();
          auto aid = fc.arrow_type->id();
          if ((aid == arrow::Type::INT64 &&
               phys == parquet::Type::INT64) ||
              (aid == arrow::Type::INT32 &&
               phys == parquet::Type::INT32) ||
              (aid == arrow::Type::FLOAT &&
               phys == parquet::Type::FLOAT) ||
              (aid == arrow::Type::DOUBLE &&
               phys == parquet::Type::DOUBLE)) {
            fc.kind = static_cast<int>(phys);
          }
        }
      }
      access->fast_.push_back(fc);
    }
    *out = std::move(access);
    return arrow::Status::OK();
  }

  arrow::Status ReadChunk(int chunk,
                          std::shared_ptr<arrow::Table>* out) override {
    auto* pq = reader_->parquet_reader();
    int64_t nrows = pq->metadata()->RowGroup(chunk)->num_rows();
    auto rg = pq->RowGroup(chunk);
    size_t n = col_indices_.size();
    std::vector<std::shared_ptr<arrow::Array>> arrays(n);
    std::vector<int> slow_pos;        // positions needing the arrow path
    if (defs_.size() < static_cast<size_t>(nrows)) defs_.resize(nrows);
    const auto rg_meta = pq->metadata()->RowGroup(chunk);
    for (size_t i = 0; i < n; ++i) {
      const FastCol& fc = fast_[i];
      if (!fc.eligible()) {
        slow_pos.push_back(static_cast<int>(i));
        continue;
      }
      // When the chunk's statistics prove there are no nulls, skip the
      // def-level decode entirely (~17% of decode time on the headline
      // all-valid file). A lying null_count is still safe: ReadBatch
      // then returns fewer values than rows, the short-read check
      // fails, and the column re-reads through the arrow path.
      bool no_nulls = fc.max_def == 0;
      if (!no_nulls) {
        auto stats = rg_meta->ColumnChunk(fc.pq_index)->statistics();
        no_nulls = stats != nullptr && stats->HasNullCount() &&
                   stats->null_count() == 0;
      }
      auto st = ReadFast(rg.get(), fc, nrows, no_nulls, &arrays[i]);
      if (!st.ok()) {
        // Nulls present (or any decode surprise): re-read this column
        // through the arrow path, which carries validity bitmaps.
        slow_pos.push_back(static_cast<int>(i));
        arrays[i].reset();
      }
    }
    if (!slow_pos.empty()) {
      std::vector<int> slow_indices;
      for (int p : slow_pos) slow_indices.push_back(col_indices_[p]);
      std::shared_ptr<arrow::Table> slow_tbl;
      ARROW_ASSIGN_OR_RAISE(slow_tbl,
                            reader_->ReadRowGroup(chunk, slow_indices));
      for (int c = 0; c < slow_tbl->num_columns(); ++c) {
        if (slow_tbl->column(c)->num_chunks() > 1) {
          ARROW_ASSIGN_OR_RAISE(
              slow_tbl,
              slow_tbl->CombineChunks(arrow::default_memory_pool()));
          break;
        }
      }
      for (size_t k = 0; k < slow_pos.size(); ++k) {
        arrays[slow_pos[k]] = slow_tbl->column(static_cast<int>(k))
                                  ->chunk(0);
      }
    }
    std::vector<std::shared_ptr<arrow::Field>> fields;
    fields.reserve(n);
    for (size_t i = 0; i < n; ++i) {
      fields.push_back(arrow::field(names_[i], arrays[i]->type()));
    }
    *out = arrow::Table::Make(arrow::schema(fields), arrays, nrows);
    return arrow::Status::OK();
  }

 private:
  struct FastCol {
    std::shared_ptr<arrow::DataType> arrow_type;
    int pq_index = -1;
    int max_def = 0;
    // parquet physical type when fast-path eligible; -1 otherwise.
    int kind = -1;
    bool eligible() const { return kind >= 0; }
  };

  template <typename Reader, typename T>
  arrow::Status ReadFastTyped(parquet::ColumnReader* col, int max_def,
                              int64_t nrows, uint8_t* dst) {
    auto* typed = static_cast<Reader*>(col);
    T* vals = reinterpret_cast<T*>(dst);
    int64_t got = 0;
    while (got < nrows && typed->HasNext()) {
      int64_t vread = 0;
      int64_t lread = typed->ReadBatch(
          nrows - got, max_def > 0 ? defs_.data() : nullptr, nullptr,
          vals + got, &vread);
      if (max_def > 0 && vread != lread) {
        return arrow::Status::Invalid("nulls present");  // -> arrow path
      }
      if (lread == 0) break;
      got += max_def > 0 ? lread : vread;
    }
    if (got != nrows) {
      return arrow::Status::Invalid("short column read");
    }
    return arrow::Status::OK();
  }

  arrow::Status ReadFast(parquet::RowGroupReader* rg, const FastCol& fc,
                         int64_t nrows, bool no_nulls,
                         std::shared_ptr<arrow::Array>* out) {
    int64_t esize = fc.arrow_type->byte_width();
    ARROW_ASSIGN_OR_RAISE(std::shared_ptr<arrow::Buffer> buf,
                          arrow::AllocateBuffer(nrows * esize));
    auto col = rg->Column(fc.pq_index);
    int max_def = no_nulls ? 0 : fc.max_def;
    arrow::Status st;
    try {
    switch (fc.arrow_type->id()) {
      case arrow::Type::INT64:
        st = ReadFastTyped<parquet::Int64Reader, int64_t>(
            col.get(), max_def, nrows, buf->mutable_data());
        break;
      case arrow::Type::INT32:
        st = ReadFastTyped<parquet::Int32Reader, int32_t>(
            col.get(), max_def, nrows, buf->mutable_data());
        break;
      case arrow::Type::FLOAT:
        st = ReadFastTyped<parquet::FloatReader, float>(
            col.get(), max_def, nrows, buf->mutable_data());
        break;
      case arrow::Type::DOUBLE:
        st = ReadFastTyped<parquet::DoubleReader, double>(
            col.get(), max_def, nrows, buf->mutable_data());
        break;
      default:
        return arrow::Status::Invalid("not fast-path eligible");
    }
    } catch (const std::exception& e) {
      // E.g. a page whose value count disagrees with the stats-implied
      // no-null layout; the caller re-reads via the arrow path.
      return arrow::Status::Invalid("low-level decode failed: ", e.what());
    }
    ARROW_RETURN_NOT_OK(st);
    *out = arrow::MakeArray(arrow::ArrayData::Make(
        fc.arrow_type, nrows, {nullptr, std::move(buf)}, 0));
    return arrow::Status::OK();
  }

  std::unique_ptr<parquet::arrow::FileReader> reader_;
  std::vector<int> col_indices_;
  std::vector<std::string> names_;
  std::vector<FastCol> fast_;
  std::vector<int16_t> defs_;
};

class OrcAccess : public TableAccess {
 public:
  static arrow::Status Open(const std::string& path,
                            const std::vector<std::string>& cols, bool mmap,
                            std::unique_ptr<TableAccess>* out) {
    std::shared_ptr<arrow::io::RandomAccessFile> file;
    if (mmap) {
      ARROW_ASSIGN_OR_RAISE(file, arrow::io::MemoryMappedFile::Open(
                                      path, arrow::io::FileMode::READ));
    } else {
      ARROW_ASSIGN_OR_RAISE(file, arrow::io::ReadableFile::Open(path));
    }
    auto access = std::make_unique<OrcAccess>();
    ARROW_ASSIGN_OR_RAISE(access->reader_,
                          arrow::adapters::orc::ORCFileReader::Open(
                              file, arrow::default_memory_pool()));
    access->cols_ = cols;
    *out = std::move(access);
    return arrow::Status::OK();
  }

  arrow::Status ReadChunk(int chunk,
                          std::shared_ptr<arrow::Table>* out) override {
    ARROW_ASSIGN_OR_RAISE(auto batch, reader_->ReadStripe(chunk, cols_));
    ARROW_ASSIGN_OR_RAISE(*out, arrow::Table::FromRecordBatches({batch}));
    return arrow::Status::OK();
  }

 private:
  std::unique_ptr<arrow::adapters::orc::ORCFileReader> reader_;
  std::vector<std::string> cols_;
};

// --------------------------------------------------------------------------
// Reader: task list -> thread-pool decode -> ordered prefetch queue ->
// rebatch. Reference: the prefetch buffer (prefetch.cc:41-120) + AUTOTUNE
// thread budgeting (table.py:94-117) collapsed into one native stage.
// --------------------------------------------------------------------------

struct Task {
  int32_t file;
  int32_t chunk;
};

// Stage timing, enabled with HB_DATA_TIMING=1: accumulated wall time per
// pipeline stage, dumped to stderr when the reader closes. The decode
// stage runs on worker threads (sums across workers); wait/emit run on
// the consumer thread. On a single-core host decode+emit+overhead ~= the
// end-to-end step time; on multi-core hosts decode overlaps the consumer
// and `wait` shows how often the consumer actually stalls.
struct StageStats {
  std::atomic<int64_t> decode_ns{0};   // TableAccess::ReadChunk (+ Open)
  std::atomic<int64_t> wait_ns{0};     // consumer blocked on the queue
  std::atomic<int64_t> emit_ns{0};     // RebatchBuffer::Take
  std::atomic<int64_t> batches{0};
  std::atomic<int64_t> chunks{0};
  static bool enabled() {
    static const bool on = [] {
      const char* v = std::getenv("HB_DATA_TIMING");
      return v != nullptr && v[0] != '\0' && v[0] != '0';
    }();
    return on;
  }
  void Dump() const {
    if (!enabled()) return;
    double b = std::max<int64_t>(batches.load(), 1);
    std::fprintf(
        stderr,
        "[hbtpu_data] chunks=%lld batches=%lld decode=%.1fms (%.3fms/b) "
        "wait=%.1fms (%.3fms/b) emit=%.1fms (%.3fms/b)\n",
        static_cast<long long>(chunks.load()),
        static_cast<long long>(batches.load()),
        decode_ns.load() / 1e6, decode_ns.load() / 1e6 / b,
        wait_ns.load() / 1e6, wait_ns.load() / 1e6 / b,
        emit_ns.load() / 1e6, emit_ns.load() / 1e6 / b);
  }
};

class StageTimer {  // adds elapsed ns to a counter when enabled
 public:
  explicit StageTimer(std::atomic<int64_t>* sink)
      : sink_(StageStats::enabled() ? sink : nullptr) {
    if (sink_ != nullptr) start_ = std::chrono::steady_clock::now();
  }
  ~StageTimer() {
    if (sink_ != nullptr) {
      *sink_ += std::chrono::duration_cast<std::chrono::nanoseconds>(
                    std::chrono::steady_clock::now() - start_)
                    .count();
    }
  }

 private:
  std::atomic<int64_t>* sink_;
  std::chrono::steady_clock::time_point start_;
};

class Reader {
 public:
  Reader(std::vector<std::string> files, std::vector<Task> tasks,
         std::vector<std::string> cols, std::vector<double> defaults,
         int64_t batch_size, bool drop_remainder, bool shuffle,
         int64_t shuffle_buffer, int64_t seed, int threads, int prefetch,
         int format, bool mmap)
      : files_(std::move(files)), tasks_(std::move(tasks)),
        cols_(std::move(cols)),
        buffer_(cols_, std::move(defaults), shuffle, seed),
        batch_size_(batch_size), drop_remainder_(drop_remainder),
        watermark_(shuffle ? std::max(batch_size, shuffle_buffer)
                           : batch_size),
        format_(format), mmap_(mmap) {
    threads = std::max(1, threads);
    // Decode-ahead window: the consumer takes chunks in STRICT order
    // (deterministic batches), so one transiently-descheduled worker
    // stalls emission head-of-line. 3x threads of ready+in-flight
    // chunks absorbs scheduler outliers (measured 43% inter-pass
    // spread on a shared host with 2x); prefetch raises the floor.
    window_ = std::max(prefetch, 3 * threads);
    int n = static_cast<int>(std::min<size_t>(threads, tasks_.size()));
    for (int i = 0; i < std::max(n, 1); ++i) {
      workers_.emplace_back([this] { WorkerLoop(); });
    }
  }

  ~Reader() {
    {
      std::unique_lock<std::mutex> lock(mu_);
      cancelled_ = true;
    }
    cv_producer_.notify_all();
    cv_consumer_.notify_all();
    for (auto& t : workers_) t.join();
    stats_.Dump();
  }

  // nrows>0: batch emitted; 0: end of data; <0: error (see last_error()).
  int64_t Next(ColDesc* out, BatchToken** token) {
    if (buffer_.rows() >= watermark_) return Emit(batch_size_, out, token);
    while (true) {
      std::shared_ptr<arrow::Table> table;
      {
        StageTimer wait_timer(&stats_.wait_ns);
        std::unique_lock<std::mutex> lock(mu_);
        cv_consumer_.wait(lock, [this] {
          return !error_.empty() || ready_.count(next_emit_) ||
                 AllDecoded();
        });
        if (!error_.empty()) return -1;
        auto it = ready_.find(next_emit_);
        if (it != ready_.end()) {
          table = std::move(it->second);
          ready_.erase(it);
          ++next_emit_;
          cv_producer_.notify_all();
        } else if (AllDecoded()) {
          break;  // fully drained; fall through to tail emission
        }
      }
      if (table) {
        buffer_.Put(std::move(table));
        if (buffer_.rows() >= watermark_) return Emit(batch_size_, out,
                                                      token);
      }
    }
    if (buffer_.rows() >= batch_size_) return Emit(batch_size_, out, token);
    if (buffer_.rows() > 0 && !drop_remainder_) {
      return Emit(buffer_.rows(), out, token);
    }
    return 0;
  }

  const std::string& last_error() const { return error_; }

 private:
  bool AllDecoded() const {  // caller holds mu_
    return next_emit_ >= static_cast<int64_t>(tasks_.size());
  }

  int64_t Emit(int64_t n, ColDesc* out, BatchToken** token) {
    StageTimer emit_timer(&stats_.emit_ns);
    stats_.batches += 1;
    auto t = std::make_unique<BatchToken>();
    auto st = buffer_.Take(n, out, t.get());
    if (!st.ok()) {
      std::unique_lock<std::mutex> lock(mu_);
      if (error_.empty()) error_ = st.ToString();
      return -1;
    }
    *token = t.release();
    return n;
  }

  void WorkerLoop() {
    std::unordered_map<int32_t, std::unique_ptr<TableAccess>> cache;
    while (true) {
      int64_t idx;
      {
        std::unique_lock<std::mutex> lock(mu_);
        cv_producer_.wait(lock, [this] {
          return cancelled_ || !error_.empty() ||
                 (next_task_ < static_cast<int64_t>(tasks_.size()) &&
                  next_task_ - next_emit_ <
                      static_cast<int64_t>(window_));
        });
        if (cancelled_ || !error_.empty() ||
            next_task_ >= static_cast<int64_t>(tasks_.size())) {
          return;
        }
        idx = next_task_++;
      }
      const Task& task = tasks_[idx];
      std::shared_ptr<arrow::Table> table;
      arrow::Status st;
      try {
        StageTimer decode_timer(&stats_.decode_ns);
        stats_.chunks += 1;
        auto it = cache.find(task.file);
        if (it == cache.end()) {
          std::unique_ptr<TableAccess> access;
          st = (format_ == 1)
              ? OrcAccess::Open(files_[task.file], cols_, mmap_, &access)
              : ParquetAccess::Open(files_[task.file], cols_, mmap_,
                                    &access);
          if (st.ok()) {
            it = cache.emplace(task.file, std::move(access)).first;
          }
        }
        if (st.ok()) st = it->second->ReadChunk(task.chunk, &table);
      } catch (const std::exception& e) {
        // Arrow/Parquet C++ throws on corrupt inputs; surface it as the
        // reader error instead of std::terminate-ing the process.
        st = arrow::Status::IOError("decode worker: ", e.what());
      }
      {
        std::unique_lock<std::mutex> lock(mu_);
        if (!st.ok()) {
          if (error_.empty()) error_ = st.ToString();
        } else {
          ready_[idx] = std::move(table);
        }
      }
      cv_consumer_.notify_all();
    }
  }

  std::vector<std::string> files_;
  std::vector<Task> tasks_;
  std::vector<std::string> cols_;
  RebatchBuffer buffer_;
  int64_t batch_size_;
  bool drop_remainder_;
  int64_t watermark_;
  int format_;
  bool mmap_;
  size_t window_;

  std::mutex mu_;
  std::condition_variable cv_producer_;
  std::condition_variable cv_consumer_;
  std::map<int64_t, std::shared_ptr<arrow::Table>> ready_;
  int64_t next_task_ = 0;
  int64_t next_emit_ = 0;
  bool cancelled_ = false;
  std::string error_;
  StageStats stats_;
  std::vector<std::thread> workers_;
};

void CopyError(const std::string& msg, char* err, int64_t cap) {
  if (err != nullptr && cap > 0) {
    std::snprintf(err, static_cast<size_t>(cap), "%s", msg.c_str());
  }
}

}  // namespace

extern "C" {

void* hb_data_reader_open(
    const char* const* files, int64_t nfiles,
    const int32_t* task_file, const int32_t* task_chunk, int64_t ntasks,
    const char* const* cols, const double* defaults, int64_t ncols,
    int64_t batch_size, int32_t drop_remainder,
    int32_t shuffle, int64_t shuffle_buffer, int64_t seed,
    int32_t threads, int32_t prefetch, int32_t format, int32_t mmap,
    char* err, int64_t err_cap) {
  try {
    std::vector<std::string> fs(files, files + nfiles);
    std::vector<std::string> cs(cols, cols + ncols);
    std::vector<double> ds(defaults, defaults + ncols);
    std::vector<Task> tasks(ntasks);
    for (int64_t i = 0; i < ntasks; ++i) {
      tasks[i] = {task_file[i], task_chunk[i]};
    }
    return new Reader(std::move(fs), std::move(tasks), std::move(cs),
                      std::move(ds), batch_size, drop_remainder != 0,
                      shuffle != 0, shuffle_buffer, seed, threads, prefetch,
                      format, mmap != 0);
  } catch (const std::exception& e) {
    CopyError(e.what(), err, err_cap);
    return nullptr;
  }
}

int64_t hb_data_reader_next(void* h, ColDesc* out, void** token,
                            char* err, int64_t err_cap) {
  auto* reader = static_cast<Reader*>(h);
  BatchToken* t = nullptr;
  int64_t n = reader->Next(out, &t);
  if (n < 0) CopyError(reader->last_error(), err, err_cap);
  *token = t;
  return n;
}

void hb_data_batch_free(void* token) {
  delete static_cast<BatchToken*>(token);
}

void hb_data_reader_close(void* h) {
  delete static_cast<Reader*>(h);
}

int32_t hb_data_abi_version() { return 1; }

}  // extern "C"
