// Binary wire format for Request/Response lists.
//
// Reference: horovod/common/wire/message.fbs +
// message.cc:541 — the reference serializes with flatbuffers; this is a
// dependency-free length-prefixed binary encoding with the same payload
// (SURVEY.md §2.1 "Message / wire format").
#pragma once

#include <cstdint>
#include <string>
#include <vector>

#include "common.h"

namespace hvd {

class Writer {
 public:
  void U8(uint8_t v) { buf_.push_back(v); }
  void I32(int32_t v) { Raw(&v, 4); }
  void I64(int64_t v) { Raw(&v, 8); }
  void U64(uint64_t v) { Raw(&v, 8); }
  void F64(double v) { Raw(&v, 8); }
  void Str(const std::string& s) {
    I32(static_cast<int32_t>(s.size()));
    Raw(s.data(), s.size());
  }
  template <typename T>
  void Vec(const std::vector<T>& v) {
    I32(static_cast<int32_t>(v.size()));
    for (const auto& x : v) Raw(&x, sizeof(T));
  }
  const std::vector<uint8_t>& data() const { return buf_; }

 private:
  void Raw(const void* p, size_t n) {
    const uint8_t* b = static_cast<const uint8_t*>(p);
    buf_.insert(buf_.end(), b, b + n);
  }
  std::vector<uint8_t> buf_;
};

class Reader {
 public:
  Reader(const uint8_t* data, size_t len) : p_(data), end_(data + len) {}
  bool ok() const { return ok_; }
  uint8_t U8() { uint8_t v = 0; Raw(&v, 1); return v; }
  int32_t I32() { int32_t v = 0; Raw(&v, 4); return v; }
  int64_t I64() { int64_t v = 0; Raw(&v, 8); return v; }
  uint64_t U64() { uint64_t v = 0; Raw(&v, 8); return v; }
  double F64() { double v = 0; Raw(&v, 8); return v; }
  std::string Str() {
    int32_t n = I32();
    if (!Bounded(n)) return {};
    std::string s(reinterpret_cast<const char*>(p_), n);
    p_ += n;
    return s;
  }
  template <typename T>
  std::vector<T> Vec() {
    int32_t n = I32();
    std::vector<T> v;
    if (!Bounded(static_cast<int64_t>(n) * sizeof(T))) return v;
    v.resize(n);
    for (auto& x : v) Raw(&x, sizeof(T));
    return v;
  }

 private:
  bool Bounded(int64_t n) {
    if (n < 0 || p_ + n > end_) { ok_ = false; return false; }
    return true;
  }
  void Raw(void* out, size_t n) {
    if (!Bounded(static_cast<int64_t>(n))) return;
    std::copy(p_, p_ + n, static_cast<uint8_t*>(out));
    p_ += n;
  }
  const uint8_t* p_;
  const uint8_t* end_;
  bool ok_ = true;
};

std::vector<uint8_t> SerializeRequestList(const RequestList& rl);
bool DeserializeRequestList(const uint8_t* data, size_t len, RequestList* rl);
std::vector<uint8_t> SerializeResponseList(const ResponseList& rl);
bool DeserializeResponseList(const uint8_t* data, size_t len,
                             ResponseList* rl);

}  // namespace hvd
