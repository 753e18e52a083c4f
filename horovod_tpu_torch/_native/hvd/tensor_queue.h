// Thread-safe queue of pending collective requests.
//
// Reference: horovod/common/tensor_queue.h:28
// (`TensorQueue`: AddToTensorQueueMulti / PopMessagesFromQueue /
// GetTensorEntriesFromResponse). The execution side holds no tensor data
// here (the Python runtime holds the tensors); entries carry metadata + a handle the Python
// layer resolves.
#pragma once

#include <deque>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

#include "common.h"

namespace hvd {

struct PendingEntry {
  int64_t handle = 0;
  Request request;
};

class TensorQueue {
 public:
  // Returns false (duplicate) if a tensor of this name is already pending.
  bool Add(const Request& req, int64_t handle);

  // Drain up to `max` queued requests for a negotiation cycle
  // (reference PopMessagesFromQueue).
  std::vector<Request> PopMessages(size_t max);

  // Resolve the entries for a negotiated response's tensors, removing
  // them from the pending table (reference GetTensorEntriesFromResponse).
  // Each entry keeps its original Request — the response cache needs true
  // per-tensor metadata, not the fused response's representative shape.
  std::vector<PendingEntry> PopEntriesWithRequests(
      const std::vector<std::string>& names);

  // Handles of everything pending (used to fail all on shutdown/error).
  std::vector<int64_t> DrainAll();

  size_t pending() const;

 private:
  mutable std::mutex mu_;
  std::deque<Request> queue_;
  std::unordered_map<std::string, PendingEntry> table_;
};

}  // namespace hvd
