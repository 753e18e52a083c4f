#include "stall_inspector.h"

#include <sstream>

namespace hvd {

void StallInspector::RecordRank(const std::string& tensor, int32_t rank) {
  auto it = entries_.find(tensor);
  if (it == entries_.end()) {
    Entry e;
    e.first_seen = std::chrono::steady_clock::now();
    e.ranks.insert(rank);
    entries_[tensor] = std::move(e);
  } else {
    it->second.ranks.insert(rank);
  }
}

void StallInspector::RemoveTensor(const std::string& tensor) {
  entries_.erase(tensor);
}

bool StallInspector::Check(
    int32_t world_size,
    const std::function<void(const std::string&)>& log) {
  auto now = std::chrono::steady_clock::now();
  bool shutdown = false;
  for (auto& kv : entries_) {
    auto& e = kv.second;
    double age =
        std::chrono::duration<double>(now - e.first_seen).count();
    if (age > warning_s_ && !e.warned) {
      std::ostringstream os;
      os << "Tensor '" << kv.first << "' stalled for " << static_cast<int>(age)
         << "s: ready on ranks [";
      bool first = true;
      for (int32_t r : e.ranks) {
        if (!first) os << ", ";
        os << r;
        first = false;
      }
      os << "], missing [";
      first = true;
      for (int32_t r = 0; r < world_size; ++r) {
        if (!e.ranks.count(r)) {
          if (!first) os << ", ";
          os << r;
          first = false;
        }
      }
      os << "]";
      log(os.str());
      e.warned = true;
    }
    if (shutdown_s_ > 0 && age > shutdown_s_) shutdown = true;
  }
  return shutdown;
}

}  // namespace hvd
