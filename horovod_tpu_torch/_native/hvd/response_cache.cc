#include "response_cache.h"

#include <algorithm>

namespace hvd {

ResponseCache::State ResponseCache::Lookup(const Request& req) const {
  auto it = entries_.find(req.name);
  if (it == entries_.end()) return State::kMiss;
  const Entry& e = it->second;
  if (e.dtype != req.dtype || e.shape != req.shape ||
      e.splits != req.splits ||
      e.response.op != req.op || e.response.reduce_op != req.reduce_op ||
      e.response.root_rank != req.root_rank ||
      e.response.prescale != req.prescale ||
      e.response.postscale != req.postscale) {
    return State::kInvalid;
  }
  return State::kHit;
}

uint32_t ResponseCache::Position(const std::string& name) const {
  return entries_.at(name).position;
}

const Response& ResponseCache::Get(uint32_t position) const {
  return entries_.at(by_position_.at(position)).response;
}

const std::string& ResponseCache::NameAt(uint32_t position) const {
  static const std::string kEmpty;
  return position < by_position_.size() ? by_position_[position] : kEmpty;
}

void ResponseCache::Put(const Response& resp, const Request& req) {
  auto it = entries_.find(req.name);
  if (it != entries_.end()) {
    lru_.erase(it->second.lru_it);
    lru_.push_front(req.name);
    it->second.response = resp;
    it->second.dtype = req.dtype;
    it->second.shape = req.shape;
    it->second.splits = req.splits;
    it->second.lru_it = lru_.begin();
    return;
  }
  if (capacity_ == 0) return;
  uint32_t pos;
  if (entries_.size() >= capacity_) {
    // evict least-recently-used, reuse its position slot
    const std::string victim = lru_.back();
    lru_.pop_back();
    pos = entries_[victim].position;
    entries_.erase(victim);
  } else {
    if (by_position_.size() < capacity_) {
      by_position_.resize(capacity_);
    }
    pos = 0;
    while (pos < capacity_ && !by_position_[pos].empty()) ++pos;
  }
  by_position_[pos] = req.name;
  lru_.push_front(req.name);
  Entry e;
  e.response = resp;
  e.dtype = req.dtype;
  e.shape = req.shape;
  e.splits = req.splits;
  e.position = pos;
  e.lru_it = lru_.begin();
  entries_[req.name] = std::move(e);
}

void ResponseCache::Erase(const std::string& name) {
  auto it = entries_.find(name);
  if (it == entries_.end()) return;
  by_position_[it->second.position].clear();
  lru_.erase(it->second.lru_it);
  entries_.erase(it);
}

void ResponseCache::Clear() {
  entries_.clear();
  by_position_.clear();
  lru_.clear();
}

std::vector<uint64_t> ResponseCache::HitBits(
    const std::vector<uint32_t>& positions) const {
  std::vector<uint64_t> bits((capacity_ + 63) / 64, 0);
  for (uint32_t p : positions) {
    if (p / 64 < bits.size()) bits[p / 64] |= (1ull << (p % 64));
  }
  return bits;
}

std::vector<uint32_t> ResponseCache::BitsToPositions(
    const std::vector<uint64_t>& bits) {
  std::vector<uint32_t> out;
  for (size_t w = 0; w < bits.size(); ++w) {
    uint64_t word = bits[w];
    while (word) {
      int b = __builtin_ctzll(word);
      out.push_back(static_cast<uint32_t>(w * 64 + b));
      word &= word - 1;
    }
  }
  return out;
}

std::vector<uint64_t> ResponseCache::Intersect(
    const std::vector<std::vector<uint64_t>>& all) {
  if (all.empty()) return {};
  size_t words = 0;
  for (const auto& v : all) words = std::max(words, v.size());
  std::vector<uint64_t> out(words, ~0ull);
  for (const auto& v : all) {
    for (size_t i = 0; i < words; ++i) {
      out[i] &= (i < v.size() ? v[i] : 0ull);
    }
  }
  return out;
}

}  // namespace hvd
