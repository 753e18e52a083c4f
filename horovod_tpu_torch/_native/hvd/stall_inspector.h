// Detect ranks that fail to submit tensors other ranks submitted.
//
// Reference: horovod/common/stall_inspector.h:30 —
// coordinator-side: per uncompleted tensor, record first-seen time and
// which ranks reported; warn after `warning_time` (default 60 s,
// stall_inspector.h:75-83), optionally signal shutdown after
// `shutdown_time`.
#pragma once

#include <chrono>
#include <functional>
#include <set>
#include <string>
#include <unordered_map>
#include <vector>

namespace hvd {

class StallInspector {
 public:
  StallInspector(double warning_s, double shutdown_s)
      : warning_s_(warning_s), shutdown_s_(shutdown_s) {}

  void RecordRank(const std::string& tensor, int32_t rank);
  void RemoveTensor(const std::string& tensor);

  // Check all uncompleted entries; logs via `log` and returns true if the
  // shutdown threshold was exceeded (reference CheckForStalledTensors).
  bool Check(int32_t world_size,
             const std::function<void(const std::string&)>& log);

  bool enabled() const { return warning_s_ > 0; }

 private:
  struct Entry {
    std::chrono::steady_clock::time_point first_seen;
    std::set<int32_t> ranks;
    bool warned = false;
  };
  double warning_s_;
  double shutdown_s_;
  std::unordered_map<std::string, Entry> entries_;
};

}  // namespace hvd
