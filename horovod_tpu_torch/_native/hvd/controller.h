// Coordinator negotiation protocol + response fusion.
//
// Reference: horovod/common/controller.{h,cc} —
// `ComputeResponseList` (controller.cc:75), `IncrementTensorCount`
// (:1006), `ConstructResponse` shape/dtype validation (:497),
// `FuseResponses` (:830), cache coordination (:802); protocol spec
// controller.h:74-111. Transport here is a TCP star (rank 0 coordinates)
// rather than MPI/Gloo collectives; the protocol is the same:
//
//   worker  -> coordinator : RequestList (new requests + cache-hit bits)
//   coordinator            : count submissions; tensor ready when every
//                            rank has submitted (or joined); validate
//                            metadata; agreed cache hits short-circuit
//   coordinator -> workers : ResponseList (fused, deterministic order)
//
// Every rank executes the ResponseList verbatim — that is what makes
// asynchronously-submitted ops run as identical fused collectives in
// identical order on all ranks (SURVEY.md §5.8).
#pragma once

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <map>
#include <memory>
#include <set>
#include <string>
#include <unordered_map>
#include <vector>

#include "common.h"
#include "bayes.h"
#include "response_cache.h"
#include "stall_inspector.h"
#include "tcp.h"

namespace hvd {

struct ControllerOptions {
  int32_t rank = 0;
  int32_t size = 1;
  std::string coordinator_addr = "127.0.0.1";
  int32_t coordinator_port = 0;  // worker: port to connect to;
                                 // coordinator: 0 = ephemeral
  double connect_timeout_s = 60.0;
  int64_t fusion_threshold_bytes = 128ll * 1024 * 1024;
  double stall_warning_s = 60.0;
  double stall_shutdown_s = 0.0;
  // control-plane autotune (reference parameter_manager.h:42)
  bool autotune = false;
  double cycle_ms = 1.0;  // initial cycle time (autotune phase-2 base)
  int32_t autotune_warmup_samples = 3;
  int32_t autotune_cycles_per_sample = 32;
  // Bayesian strategy (reference optim/bayesian_optimization.cc): GP+EI
  // over {log2 threshold, log cycle} instead of coordinate descent
  bool autotune_bayes = false;
  int32_t autotune_bayes_samples = 12;
};

class TcpController {
 public:
  explicit TcpController(const ControllerOptions& opts);

  // Coordinator: bind + accept size-1 workers (handshake = rank frame).
  // Worker: connect + send rank. Returns false on transport failure.
  bool Initialize();

  // After Initialize on rank 0: the actual port (for ephemeral binds).
  int bound_port() const { return bound_port_; }

  // One synchronized negotiation cycle. `own` is this rank's drained
  // requests + cache bits; returns the globally-agreed response list.
  // On transport failure returns a list with a single kError response.
  ResponseList RunCycle(const RequestList& own);

  int64_t stall_warnings() const { return stall_warnings_; }

  // Coordinator cycle accounting (reference operations.cc:722's
  // cycle-time bookkeeping): separates the coordinator's own CPU work
  // (deserialize + coverage + cache coordination + fuse + serialize)
  // from wall-clock blocked on worker frames, so control-plane scaling
  // growth is attributable to O(world) coordinator work vs box
  // contention. All-zero on worker ranks.
  struct CycleStats {
    int64_t cycles = 0;
    int64_t busy_cycles = 0;       // cycles that emitted responses
    int64_t wait_us = 0;           // blocked receiving worker frames
    int64_t work_us = 0;           // coordinator-side CPU in the cycle
    int64_t bytes_rx = 0;          // request frames received
    int64_t bytes_tx = 0;          // response frames broadcast
    int64_t cache_hit_positions = 0;
    int64_t responses = 0;
  };
  CycleStats cycle_stats() const {
    CycleStats s;
    s.cycles = cs_cycles_.load();
    s.busy_cycles = cs_busy_.load();
    s.wait_us = cs_wait_us_.load();
    s.work_us = cs_work_us_.load();
    s.bytes_rx = cs_bytes_rx_.load();
    s.bytes_tx = cs_bytes_tx_.load();
    s.cache_hit_positions = cs_cache_hits_.load();
    s.responses = cs_responses_.load();
    return s;
  }

 private:
  ResponseList CoordinatorCycle(const RequestList& own);
  ResponseList WorkerCycle(const RequestList& own);

  // --- coordinator-side negotiation state (reference controller.cc) ---
  // A request for an unknown set or from a non-member cannot wait for
  // coverage (membership is unknowable / will never arrive): it fails
  // immediately via `immediate_errors`, delivered only to the submitting
  // rank's handle (names are set-qualified, so nothing else resolves).
  void IncrementTensorCount(const Request& req, int32_t rank,
                            std::vector<Response>* immediate_errors);
  Response ConstructResponse(int32_t set_id, const std::string& name);
  std::vector<Response> FuseResponses(std::vector<Response> ready);
  static ResponseList ErrorList(const std::string& reason);

  ControllerOptions opts_;
  int bound_port_ = 0;

  // transport
  Listener listener_;                 // coordinator
  std::vector<Socket> worker_socks_; // coordinator: index = rank-1
  Socket coord_sock_;                 // worker

  // per-tensor submission table: name -> per-rank request + rank set
  struct TensorRecord {
    std::map<int32_t, Request> requests;
    std::set<int32_t> ranks;
    std::string error;  // first metadata mismatch
  };
  // Per-process-set negotiation state (reference process_set.h:89: each
  // set owns its controller/table; here one transport carries every
  // set's traffic and the coordinator keys state by set id). Set 0 = the
  // global set, always present. Readiness for a set counts only its
  // members; barrier likewise.
  struct SetState {
    std::vector<int32_t> members;  // sorted global ranks
    std::unordered_map<std::string, TensorRecord> table;
    std::set<int32_t> barrier_ranks;
    std::string barrier_name;  // qualified name from the requests
    bool Contains(int32_t r) const {
      return std::binary_search(members.begin(), members.end(), r);
    }
  };
  std::map<int32_t, SetState> sets_;
  // error responses generated while constructing another response (e.g.
  // tensors stranded by a deregistered set), emitted in the same cycle
  std::vector<Response> pending_set_errors_;
  std::set<int32_t> joined_ranks_;

  StallInspector stall_inspector_;
  int64_t stall_warnings_ = 0;

  // cycle accounting accumulators (bg loop writes, API thread reads)
  std::atomic<int64_t> cs_cycles_{0}, cs_busy_{0}, cs_wait_us_{0},
      cs_work_us_{0}, cs_bytes_rx_{0}, cs_bytes_tx_{0},
      cs_cache_hits_{0}, cs_responses_{0};

  // --- autotune (coordinator-only; the reference runs ParameterManager
  // on the coordinator and broadcasts winners, parameter_manager.cc:528).
  // Search = coordinate descent: sweep fusion thresholds at the initial
  // cycle time, pin the best, then sweep cycle times. Scores are
  // bytes/sec over windows of busy (response-emitting) cycles. The
  // threshold applies only HERE (fusion is a coordinator decision); the
  // cycle time ships to workers in the ResponseList.
  void AutotuneObserve(const ResponseList& rl);
  int64_t fusion_threshold_;  // live value FuseResponses uses
  double tuned_cycle_ms_;
  bool autotune_pinned_ = false;
  int at_phase_ = 0;  // 0 warmup, 1 thresholds, 2 cycles
  size_t at_idx_ = 0;
  int at_warmup_left_ = 0;
  int64_t at_sample_bytes_ = 0;
  int at_sample_busy_ = 0;      // busy cycles seen incl. the anchor
  double at_last_busy_ = 0.0;   // time of the previous busy cycle
  double at_sample_elapsed_ = 0.0;  // capped busy-interval sum
  double at_best_score_ = 0.0;
  int64_t at_best_threshold_ = 0;
  double at_best_cycle_ = 0.0;
  // widened space (reference parameter_manager.h:186): response-cache
  // toggle, hierarchical-collective toggle + block size. The cache
  // toggle gates the coordinator's agreed-bits fast path directly; all
  // three ship to workers in every ResponseList.
  bool at_cache_enabled_ = true;
  bool at_hierarchical_ = false;
  int64_t at_hier_block_ = 0;
  // Bayesian path (HOROVOD_AUTOTUNE_BAYES): tuner lives on the
  // coordinator only; winners still ship in every ResponseList
  std::unique_ptr<BayesianTuner> bayes_;
  void ApplyBayesPoint(const std::vector<double>& x);

 public:
  // The coordinator needs a cache replica to resolve cache-bit positions
  // to names; set by the runtime which owns the per-rank cache.
  ResponseCache* cache = nullptr;
};

}  // namespace hvd
