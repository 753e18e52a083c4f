#include "tensor_queue.h"

namespace hvd {

bool TensorQueue::Add(const Request& req, int64_t handle) {
  std::lock_guard<std::mutex> l(mu_);
  if (table_.count(req.name)) return false;
  table_[req.name] = PendingEntry{handle, req};
  queue_.push_back(req);
  return true;
}

std::vector<Request> TensorQueue::PopMessages(size_t max) {
  std::lock_guard<std::mutex> l(mu_);
  std::vector<Request> out;
  while (!queue_.empty() && out.size() < max) {
    out.push_back(std::move(queue_.front()));
    queue_.pop_front();
  }
  return out;
}

std::vector<PendingEntry> TensorQueue::PopEntriesWithRequests(
    const std::vector<std::string>& names) {
  std::lock_guard<std::mutex> l(mu_);
  std::vector<PendingEntry> entries;
  for (const auto& n : names) {
    auto it = table_.find(n);
    if (it != table_.end()) {
      entries.push_back(std::move(it->second));
      table_.erase(it);
    }
  }
  return entries;
}

std::vector<int64_t> TensorQueue::DrainAll() {
  std::lock_guard<std::mutex> l(mu_);
  std::vector<int64_t> handles;
  for (auto& kv : table_) handles.push_back(kv.second.handle);
  table_.clear();
  queue_.clear();
  return handles;
}

size_t TensorQueue::pending() const {
  std::lock_guard<std::mutex> l(mu_);
  return table_.size();
}

}  // namespace hvd
