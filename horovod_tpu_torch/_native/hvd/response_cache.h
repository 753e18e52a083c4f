// LRU cache of negotiated responses + cross-rank bitvector coordination.
//
// Reference: horovod/common/response_cache.h:45
// (`ResponseCache`), :107 (`CacheCoordinator`): steady-state steps skip
// full negotiation — each rank marks cache-hit positions in a bitvector,
// the coordinator ANDs all bitvectors, and the agreed positions execute
// straight from cache in deterministic (position-sorted) order.
#pragma once

#include <cstdint>
#include <list>
#include <string>
#include <unordered_map>
#include <vector>

#include "common.h"

namespace hvd {

class ResponseCache {
 public:
  enum class State { kMiss, kHit, kInvalid };

  explicit ResponseCache(size_t capacity) : capacity_(capacity) {}

  // Classify a request against the cache (reference CacheState,
  // response_cache.h:50): kInvalid = name cached but shape/dtype changed.
  State Lookup(const Request& req) const;

  bool Contains(const std::string& name) const {
    return entries_.count(name) != 0;
  }
  uint32_t Position(const std::string& name) const;
  const Response& Get(uint32_t position) const;

  // Name occupying a position ("" if free) — used to apply coordinated
  // invalidation bitvectors, which address entries by position.
  const std::string& NameAt(uint32_t position) const;

  // Insert/refresh after a negotiated response; evicts LRU at capacity.
  void Put(const Response& resp, const Request& req);

  void Erase(const std::string& name);
  void Clear();
  size_t size() const { return entries_.size(); }
  size_t capacity() const { return capacity_; }

  // Bitvector over positions [0, capacity): one uint64 word per 64 slots.
  std::vector<uint64_t> HitBits(const std::vector<uint32_t>& positions) const;

  // Positions set in `bits` (ascending — the deterministic execution
  // order every rank agrees on).
  static std::vector<uint32_t> BitsToPositions(
      const std::vector<uint64_t>& bits);

  // AND-combine per-rank bitvectors (coordinator side).
  static std::vector<uint64_t> Intersect(
      const std::vector<std::vector<uint64_t>>& all);

 private:
  struct Entry {
    Response response;
    DataType dtype;
    std::vector<int64_t> shape;
    std::vector<int64_t> splits;  // alltoall request splits
    uint32_t position;
    std::list<std::string>::iterator lru_it;
  };
  size_t capacity_;
  std::unordered_map<std::string, Entry> entries_;
  std::vector<std::string> by_position_;  // position -> name ("" if free)
  std::list<std::string> lru_;            // front = most recent
};

}  // namespace hvd
