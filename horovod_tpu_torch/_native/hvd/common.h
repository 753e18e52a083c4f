// Core types for the native control-plane runtime.
//
// Reference surface: horovod/common/common.h:318-349
// (Tensor/OpContext abstractions), message.h:50,159 (Request/Response).
//
// Control plane only: the reference's C++ runtime owns both negotiation
// (which tensors are globally ready, in what fused order) and execution
// (NCCL/MPI). Here the data plane is torch.distributed collectives (NCCL
// on the card, gloo on the CPU) driven from Python,
// so this runtime is the *control plane only*: readiness negotiation,
// deterministic fusion order, response caching, stall detection. What it
// hands back to the caller is an ordered stream of fused execution
// batches, the exact analog of the reference controller's ResponseList
// (controller.cc:75 ComputeResponseList).
#pragma once

#include <cstdint>
#include <string>
#include <vector>

namespace hvd {

enum class DataType : int32_t {
  kUint8 = 0,
  kInt8 = 1,
  kUint16 = 2,
  kInt16 = 3,
  kInt32 = 4,
  kInt64 = 5,
  kFloat16 = 6,
  kFloat32 = 7,
  kFloat64 = 8,
  kBool = 9,
  kBFloat16 = 10,  // torch.bfloat16
};

inline int64_t DataTypeSize(DataType t) {
  switch (t) {
    case DataType::kUint8:
    case DataType::kInt8:
    case DataType::kBool:
      return 1;
    case DataType::kUint16:
    case DataType::kInt16:
    case DataType::kFloat16:
    case DataType::kBFloat16:
      return 2;
    case DataType::kInt32:
    case DataType::kFloat32:
      return 4;
    default:
      return 8;
  }
}

enum class OpType : int32_t {
  kAllreduce = 0,
  kAllgather = 1,
  kBroadcast = 2,
  kAlltoall = 3,
  kReducescatter = 4,
  kJoin = 5,
  kBarrier = 6,
  kError = 7,  // response-only: negotiation failure delivered to all ranks
  // process-set registration (reference process_set.h:89 ProcessSetTable
  // + process_sets.py:123 add_process_set): membership rides Request.shape,
  // the set id rides Request.root_rank. Negotiated like any tensor — all
  // world ranks must submit identical membership (the reference's
  // synchronized registration), mismatches fail via the ordinary
  // metadata-validation channel.
  kRegisterSet = 8,
  kDeregisterSet = 9,
};

enum class StatusType : int32_t {
  kOk = 0,
  kUnknownError = 1,
  kPreconditionError = 2,
  kAborted = 3,
  kInvalidArgument = 4,
  kInProgress = 5,
};

struct Status {
  StatusType type = StatusType::kOk;
  std::string reason;
  bool ok() const { return type == StatusType::kOk; }
  static Status OK() { return {}; }
  static Status Invalid(std::string r) {
    return {StatusType::kInvalidArgument, std::move(r)};
  }
  static Status Error(std::string r) {
    return {StatusType::kUnknownError, std::move(r)};
  }
};

// Worker -> coordinator: "rank R is ready to run op on tensor N"
// (reference message.h:50).
struct Request {
  int32_t rank = 0;
  OpType op = OpType::kAllreduce;
  DataType dtype = DataType::kFloat32;
  std::string name;
  int32_t root_rank = 0;          // broadcast only
  int32_t reduce_op = 0;          // ReduceOp id (mpi_ops.py:60 values)
  double prescale = 1.0;
  double postscale = 1.0;
  std::vector<int64_t> shape;
  // alltoall only: rows of dim 0 destined to each rank (reference
  // operations.cc:1858 uneven splits); empty = even split
  std::vector<int64_t> splits;
  // grouped collectives (reference group_table.h:25): all members of a
  // group become ready together or not at all. The tag is derived from
  // the member names (identical across ranks); group_size is the member
  // count the coordinator waits for. Empty tag = ungrouped.
  std::string group;
  int32_t group_size = 0;
  // process set this op negotiates in (reference process_set.h:89): 0 =
  // global. Readiness counts only the set's members; the Python layer
  // qualifies tensor names per set so name-keyed tables never collide
  // across sets.
  int32_t process_set_id = 0;

  int64_t NumElements() const {
    int64_t n = 1;
    for (auto d : shape) n *= d;
    return n;
  }
  int64_t ByteSize() const { return NumElements() * DataTypeSize(dtype); }
};

// Coordinator -> all ranks: "run this (possibly fused) op now"
// (reference message.h:159). tensor_names order is the fusion order every
// rank must follow.
struct Response {
  OpType op = OpType::kAllreduce;
  std::vector<std::string> tensor_names;
  std::string error_reason;  // op == kError
  int32_t root_rank = 0;
  int32_t reduce_op = 0;
  double prescale = 1.0;
  double postscale = 1.0;
  DataType dtype = DataType::kFloat32;
  int64_t total_bytes = 0;
  std::vector<int64_t> first_shape;  // representative shape (validation)
  // per-tensor shapes parallel to tensor_names: lets ranks without a
  // local pending entry (joined ranks) replicate exact cache metadata
  // for fused batches instead of guessing from first_shape
  std::vector<std::vector<int64_t>> tensor_shapes;
  // allgather: every rank's dim-0 extent in rank order — the negotiated
  // size collection of reference ConstructResponse (controller.cc:497)
  // that makes ragged (variable first-dim) allgather executable
  std::vector<int64_t> rank_dim0;
  // alltoall: the full splits matrix, row r = rank r's outgoing splits,
  // flattened [rank * size + dest]; empty when every rank is even
  std::vector<int64_t> all_splits;
  // non-empty when the constituent tensors were group members: joined
  // ranks must also skip caching them (grouped responses are uncached so
  // the cache fast path can never split a group across cycles)
  std::string group;
  // the process set this response belongs to; non-member ranks still
  // mutate their response cache identically (replicated positions) but
  // never execute the batch. For kRegisterSet acks, first_shape carries
  // the agreed membership.
  int32_t process_set_id = 0;
  // kError only: the single rank this error addresses, or -1 for all.
  // A non-member enqueue fails just the offender — the broadcast error
  // must not pop a member's legitimately pending entry of the same name.
  int32_t error_rank = -1;
};

struct RequestList {
  std::vector<Request> requests;
  std::vector<uint64_t> cache_bits;    // bitvector of cache-hit positions
  std::vector<uint64_t> invalid_bits;  // positions whose cached metadata no
                                       // longer matches this rank's request
  bool shutdown = false;
  bool join = false;
};

struct ResponseList {
  std::vector<Response> responses;
  // OR of every rank's invalid_bits: all ranks erase these cache positions
  // in the same cycle, keeping position tables replicated (reference
  // CacheCoordinator, controller.cc:802).
  std::vector<uint64_t> agreed_invalid_bits;
  bool shutdown = false;
  int32_t join_count = 0;
  // ranks whose kJoin is pending (not yet full coverage), broadcast
  // every cycle: the Python plan cache checks this before dispatching a
  // bypassed step so peers of a joining rank fall back to negotiation
  // (the joiner's zero-contribution semantics only exist there)
  int32_t pending_joins = 0;
  // Control-plane autotune (reference parameter_manager.cc:528, which
  // broadcasts the winning parameters): the coordinator owns the search
  // and ships the currently-applied values with every cycle, so all
  // ranks hold identical parameters by construction. 0 = autotune off.
  double tuned_cycle_ms = 0.0;
  int64_t tuned_threshold = 0;
  bool tuned_pinned = false;
  // Widened search space (reference parameter_manager.h:186 also flips
  // response-cache and hierarchical-collective toggles): shipped every
  // cycle like the scalar knobs above.
  bool tuned_cache_enabled = true;
  bool tuned_hierarchical = false;
  // ranks per inner (ICI) domain for hierarchical collectives
  // (ops/hierarchical.py resolve_block); 0 = launcher-topology default
  int64_t tuned_hier_block = 0;
  // true only when the 5-D Bayes search owns the cache/hierarchical
  // dims; the 2-D coordinate-descent tuner never explores them, so its
  // defaults must not override user-set knobs at pin time
  bool tuned_bayes = false;
};

}  // namespace hvd
