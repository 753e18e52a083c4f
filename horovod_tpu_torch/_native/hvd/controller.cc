#include "controller.h"

#include <chrono>
#include <cmath>
#include <cstdio>

#include "wire.h"

namespace hvd {

namespace {
// autotune candidate grids (coordinate descent; reference searches a
// joint space with a GP — a 2-phase sweep covers this 2-D space without
// Eigen/LBFGS baggage)
const int64_t kAtThresholds[] = {
    1ll << 20, 4ll << 20, 16ll << 20, 64ll << 20,
    128ll << 20, 256ll << 20,
};
const double kAtCycles[] = {0.25, 0.5, 1.0, 2.5, 5.0};

double MonoSeconds() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}
}  // namespace

TcpController::TcpController(const ControllerOptions& opts)
    : opts_(opts),
      stall_inspector_(opts.stall_warning_s, opts.stall_shutdown_s),
      fusion_threshold_(opts.fusion_threshold_bytes),
      tuned_cycle_ms_(opts.cycle_ms),
      at_warmup_left_(opts.autotune_warmup_samples) {
  // set 0 = the global set (reference process_set.h:42 Global)
  SetState& global = sets_[0];
  for (int32_t r = 0; r < opts_.size; ++r) global.members.push_back(r);
  // a 1-cycle sample has no measurable interval (the anchor cycle opens
  // the window); two counted cycles is the floor for a meaningful score
  if (opts_.autotune_cycles_per_sample < 2) {
    opts_.autotune_cycles_per_sample = 2;
  }
  if (opts_.autotune && opts_.autotune_warmup_samples <= 0) {
    at_phase_ = 1;  // warmup disabled: start the threshold sweep at once
    fusion_threshold_ = kAtThresholds[0];
  }
}

bool TcpController::Initialize() {
  if (opts_.size == 1) return true;
  if (opts_.rank == 0) {
    if (!listener_.Listen(opts_.coordinator_port)) return false;
    bound_port_ = listener_.bound_port();
    worker_socks_.resize(opts_.size - 1);
    int connected = 0;
    while (connected < opts_.size - 1) {
      Socket s = listener_.Accept(opts_.connect_timeout_s);
      if (!s.valid()) return false;
      std::vector<uint8_t> frame;
      if (!s.RecvFrame(&frame) || frame.size() < 4) return false;
      int32_t rank;
      std::copy(frame.begin(), frame.begin() + 4,
                reinterpret_cast<uint8_t*>(&rank));
      if (rank < 1 || rank >= opts_.size || worker_socks_[rank - 1].valid()) {
        return false;
      }
      worker_socks_[rank - 1] = std::move(s);
      ++connected;
    }
    return true;
  }
  if (!coord_sock_.Connect(opts_.coordinator_addr, opts_.coordinator_port,
                           opts_.connect_timeout_s)) {
    return false;
  }
  std::vector<uint8_t> frame(4);
  std::copy(reinterpret_cast<uint8_t*>(&opts_.rank),
            reinterpret_cast<uint8_t*>(&opts_.rank) + 4, frame.begin());
  return coord_sock_.SendFrame(frame);
}

ResponseList TcpController::ErrorList(const std::string& reason) {
  ResponseList rl;
  Response r;
  r.op = OpType::kError;
  r.error_reason = reason;
  rl.responses.push_back(r);
  return rl;
}

ResponseList TcpController::RunCycle(const RequestList& own) {
  // size==1 runs the coordinator logic with no transport
  return opts_.rank == 0 ? CoordinatorCycle(own) : WorkerCycle(own);
}

ResponseList TcpController::WorkerCycle(const RequestList& own) {
  if (!coord_sock_.SendFrame(SerializeRequestList(own))) {
    return ErrorList("lost connection to coordinator (send)");
  }
  std::vector<uint8_t> frame;
  if (!coord_sock_.RecvFrame(&frame)) {
    return ErrorList("lost connection to coordinator (recv)");
  }
  ResponseList rl;
  if (!DeserializeResponseList(frame.data(), frame.size(), &rl)) {
    return ErrorList("malformed response list");
  }
  return rl;
}

// Per-request (rank-independent) validity: alltoall splits must address
// every rank *of the op's process set* and cover the tensor exactly
// (reference operations.cc:1858).
static std::string ValidateSplits(const Request& req, int32_t size) {
  if (req.op != OpType::kAlltoall) return "";
  int64_t d0 = req.shape.empty() ? 0 : req.shape[0];
  if (req.splits.empty()) {
    if (size > 0 && d0 % size) {
      return "alltoall tensor '" + req.name + "' dim0 " +
             std::to_string(d0) + " not divisible by world size";
    }
    return "";
  }
  if (static_cast<int32_t>(req.splits.size()) != size) {
    return "alltoall tensor '" + req.name + "' has " +
           std::to_string(req.splits.size()) + " splits for " +
           std::to_string(size) + " ranks";
  }
  int64_t sum = 0;
  for (int64_t s : req.splits) {
    if (s < 0) {
      return "alltoall tensor '" + req.name + "' has negative split " +
             std::to_string(s);
    }
    sum += s;
  }
  if (sum != d0) {
    return "alltoall tensor '" + req.name + "' splits sum " +
           std::to_string(sum) + " != dim0 " + std::to_string(d0);
  }
  return "";
}

void TcpController::IncrementTensorCount(
    const Request& req, int32_t rank,
    std::vector<Response>* immediate_errors) {
  // resolve the op's process set; unknown sets / non-member submissions
  // cannot accumulate coverage and fail immediately (only the submitting
  // rank holds a handle for the set-qualified name)
  auto sit = sets_.find(req.process_set_id);
  if (sit == sets_.end() ||
      (req.op != OpType::kRegisterSet && req.op != OpType::kDeregisterSet &&
       !sit->second.Contains(rank))) {
    Response err;
    err.op = OpType::kError;
    err.tensor_names = {req.name};
    err.process_set_id = req.process_set_id;
    err.error_rank = rank;  // fail only the offender's handle
    err.error_reason =
        sit == sets_.end()
            ? "tensor '" + req.name + "' names unregistered process set " +
                  std::to_string(req.process_set_id)
            : "rank " + std::to_string(rank) +
                  " is not a member of process set " +
                  std::to_string(req.process_set_id);
    immediate_errors->push_back(std::move(err));
    return;
  }
  auto& table = sit->second.table;
  // reference: controller.cc:1006 — first request creates the record;
  // metadata must agree with what rank 0 of the record submitted
  auto it = table.find(req.name);
  if (it == table.end()) {
    TensorRecord rec;
    rec.error = ValidateSplits(
        req, static_cast<int32_t>(sit->second.members.size()));
    rec.requests[rank] = req;
    rec.ranks.insert(rank);
    table[req.name] = std::move(rec);
    stall_inspector_.RecordRank(req.name, rank);
    return;
  }
  TensorRecord& rec = it->second;
  if (rec.ranks.count(rank)) {
    rec.error = "rank " + std::to_string(rank) +
                " submitted tensor '" + req.name + "' twice in one step";
  }
  const Request& first = rec.requests.begin()->second;
  // validation mirrors ConstructResponse (controller.cc:497): op, dtype
  // and shape must be consistent; allgather tolerates differing first dim
  if (req.op != first.op) {
    rec.error = "mismatched op types for tensor '" + req.name + "'";
  } else if (req.group != first.group ||
             req.group_size != first.group_size) {
    rec.error = "mismatched group membership for tensor '" + req.name +
                "' (group '" + req.group + "'/" +
                std::to_string(req.group_size) + " vs '" + first.group +
                "'/" + std::to_string(first.group_size) + ")";
  } else if (req.dtype != first.dtype) {
    rec.error = "mismatched dtypes for tensor '" + req.name + "'";
  } else if (req.op == OpType::kBroadcast &&
             req.root_rank != first.root_rank) {
    rec.error = "mismatched broadcast root for tensor '" + req.name + "'";
  } else if (req.op != OpType::kAllgather && req.op != OpType::kAlltoall &&
             req.shape != first.shape) {
    rec.error = "mismatched shapes for tensor '" + req.name + "'";
  } else if (req.op == OpType::kAllgather || req.op == OpType::kAlltoall) {
    // ragged ops: first dim may differ per rank; everything else must
    // agree (reference ConstructResponse, controller.cc:497)
    if (req.shape.size() != first.shape.size()) {
      rec.error = "mismatched ranks for tensor '" + req.name + "'";
    } else {
      for (size_t d = 1; d < req.shape.size(); ++d) {
        if (req.shape[d] != first.shape[d]) {
          rec.error =
              "mismatched non-first dims for tensor '" + req.name + "'";
        }
      }
    }
  }
  if (rec.error.empty()) {
    rec.error = ValidateSplits(
        req, static_cast<int32_t>(sit->second.members.size()));
  }
  rec.requests[rank] = req;
  rec.ranks.insert(rank);
  stall_inspector_.RecordRank(req.name, rank);
}

Response TcpController::ConstructResponse(int32_t set_id,
                                          const std::string& name) {
  SetState& set = sets_[set_id];
  TensorRecord& rec = set.table[name];
  const Request& first = rec.requests.begin()->second;
  Response resp;
  resp.process_set_id = set_id;
  if (!rec.error.empty()) {
    resp.op = OpType::kError;
    resp.error_reason = rec.error;
    resp.tensor_names = {name};
    return resp;
  }
  if (first.op == OpType::kRegisterSet ||
      first.op == OpType::kDeregisterSet) {
    // membership agreed by all world ranks (shape equality validated
    // above); activate/retire the set here so the very next cycle
    // negotiates in it (reference process_set_table.cc Register)
    int32_t target = first.root_rank;  // set id rides root_rank
    resp.op = first.op;
    resp.tensor_names = {name};
    resp.process_set_id = target;
    resp.first_shape = first.shape;
    resp.tensor_shapes = {first.shape};
    if (first.op == OpType::kRegisterSet) {
      std::vector<int32_t> members(first.shape.begin(), first.shape.end());
      std::sort(members.begin(), members.end());
      auto tit = sets_.find(target);
      if (target <= 0) {
        resp.op = OpType::kError;
        resp.error_reason = "process set id must be positive, got " +
                            std::to_string(target);
      } else if (members.empty() ||
                 std::adjacent_find(members.begin(), members.end()) !=
                     members.end() ||
                 members.front() < 0 || members.back() >= opts_.size) {
        resp.op = OpType::kError;
        resp.error_reason =
            "invalid membership for process set " + std::to_string(target);
      } else if (tit != sets_.end() && tit->second.members != members) {
        resp.op = OpType::kError;
        resp.error_reason = "process set " + std::to_string(target) +
                            " already registered with different members";
      } else {
        sets_[target].members = std::move(members);  // idempotent re-ack
      }
    } else {
      auto tit = sets_.find(target);
      if (target == 0 || tit == sets_.end()) {
        resp.op = OpType::kError;
        resp.error_reason = "cannot deregister process set " +
                            std::to_string(target);
      } else {
        // in-flight tensors of a retired set can never complete; fail
        // them in this same cycle via the error channel
        for (auto& kv : tit->second.table) {
          Response dead;
          dead.op = OpType::kError;
          dead.tensor_names = {kv.first};
          dead.process_set_id = target;
          dead.error_reason = "process set " + std::to_string(target) +
                              " was deregistered";
          pending_set_errors_.push_back(std::move(dead));
          stall_inspector_.RemoveTensor(kv.first);
        }
        // a half-arrived set barrier likewise: fail the arrived members'
        // handles (and clear their queue entries) instead of letting
        // them block the full timeout — and leaving a permanent
        // duplicate-name entry that would poison a re-registered set
        if (!tit->second.barrier_ranks.empty() &&
            !tit->second.barrier_name.empty()) {
          Response dead;
          dead.op = OpType::kError;
          dead.tensor_names = {tit->second.barrier_name};
          dead.process_set_id = target;
          dead.error_reason = "process set " + std::to_string(target) +
                              " was deregistered during its barrier";
          pending_set_errors_.push_back(std::move(dead));
        }
        sets_.erase(tit);
      }
    }
    return resp;
  }
  resp.op = first.op;
  resp.tensor_names = {name};
  resp.root_rank = first.root_rank;
  resp.reduce_op = first.reduce_op;
  resp.prescale = first.prescale;
  resp.postscale = first.postscale;
  resp.dtype = first.dtype;
  resp.first_shape = first.shape;
  resp.tensor_shapes = {first.shape};
  resp.group = first.group;
  const auto& members = set.members;
  const int32_t ssize = static_cast<int32_t>(members.size());
  auto set_local = [&](int32_t global_rank) {
    return static_cast<int32_t>(
        std::lower_bound(members.begin(), members.end(), global_rank) -
        members.begin());
  };
  // allgather: total bytes sums every member's first dim; the negotiated
  // per-member dim-0 sizes ship in the response in SET-LOCAL order so
  // ragged gathers execute (reference allgather size collection,
  // controller.cc:497)
  if (first.op == OpType::kAllgather) {
    resp.rank_dim0.resize(ssize, 0);
    for (const auto& kv : rec.requests) {
      resp.total_bytes += kv.second.ByteSize();
      resp.rank_dim0[set_local(kv.first)] =
          kv.second.shape.empty() ? 0 : kv.second.shape[0];
    }
  } else if (first.op == OpType::kAlltoall) {
    // full splits matrix in set-local coordinates, row i = member i's
    // outgoing splits (even rows synthesized as dim0/set_size)
    resp.total_bytes = first.ByteSize();
    resp.all_splits.assign(static_cast<size_t>(ssize) * ssize, 0);
    for (const auto& kv : rec.requests) {
      const Request& r = kv.second;
      int64_t d0 = r.shape.empty() ? 0 : r.shape[0];
      int32_t i = set_local(kv.first);
      for (int32_t j = 0; j < ssize; ++j) {
        resp.all_splits[i * ssize + j] =
            r.splits.empty() ? d0 / ssize : r.splits[j];
      }
    }
  } else {
    resp.total_bytes = first.ByteSize();
  }
  return resp;
}

std::vector<Response> TcpController::FuseResponses(
    std::vector<Response> ready) {
  // reference: controller.cc:830 — merge responses of the same kind up to
  // the fusion threshold, with lookahead past non-matching entries (a
  // mixed-dtype tensor between two f32 tensors must not break the f32
  // bucket). Emitted order = first-constituent order; every rank receives
  // the fused list verbatim, so fusion is trivially consistent.
  std::vector<Response> out;
  // fusion key -> index of the open (not-yet-full) batch in `out`
  std::map<std::string, size_t> open;
  for (auto& r : ready) {
    // allgather left unfused: responses carry per-rank dim-0 layouts and
    // the executors run per-tensor anyway (no packed fusion buffer for
    // them; the executor packs fused allreduce/reducescatter batches)
    bool fusable_kind =
        (r.op == OpType::kAllreduce || r.op == OpType::kReducescatter) &&
        r.tensor_names.size() == 1;
    if (!fusable_kind) {
      out.push_back(std::move(r));
      continue;
    }
    // group is part of the key: a mixed grouped/ungrouped bucket would
    // inherit one constituent's group tag and silently break the
    // grouped-responses-are-never-cached invariant for the others.
    // process_set_id likewise: a fused batch is one collective over one
    // set's sub-mesh — members of another set couldn't execute it.
    std::string key = std::to_string(static_cast<int>(r.op)) + "/" +
                      std::to_string(static_cast<int>(r.dtype)) + "/" +
                      std::to_string(r.reduce_op) + "/" +
                      std::to_string(r.root_rank) + "/" +
                      std::to_string(r.prescale) + "/" +
                      std::to_string(r.postscale) + "/" + r.group + "/" +
                      std::to_string(r.process_set_id);
    auto it = open.find(key);
    if (it != open.end() &&
        out[it->second].total_bytes + r.total_bytes <=
            fusion_threshold_) {
      out[it->second].tensor_names.push_back(r.tensor_names[0]);
      out[it->second].tensor_shapes.push_back(
          r.tensor_shapes.empty() ? r.first_shape : r.tensor_shapes[0]);
      out[it->second].total_bytes += r.total_bytes;
    } else {
      open[key] = out.size();
      out.push_back(std::move(r));
    }
  }
  return out;
}

ResponseList TcpController::CoordinatorCycle(const RequestList& own) {
  // cycle accounting: RecvFrame blocking is WAIT (worker lag + box
  // contention); everything else in this function is coordinator WORK
  const double t_enter = MonoSeconds();
  double wait_s = 0.0;

  // 1. gather every worker's RequestList (rank order; lock-step cycle)
  std::vector<RequestList> all(opts_.size);
  all[0] = own;
  for (int32_t r = 1; r < opts_.size; ++r) {
    std::vector<uint8_t> frame;
    const double t_rx = MonoSeconds();
    bool got = worker_socks_[r - 1].RecvFrame(&frame);
    wait_s += MonoSeconds() - t_rx;
    if (!got ||
        !DeserializeRequestList(frame.data(), frame.size(), &all[r])) {
      ResponseList err = ErrorList("lost connection to rank " +
                                   std::to_string(r));
      err.shutdown = true;
      for (int32_t w = 1; w < opts_.size; ++w) {
        if (w != r) {
          worker_socks_[w - 1].SendFrame(SerializeResponseList(err));
        }
      }
      return err;
    }
    cs_bytes_rx_.fetch_add(static_cast<int64_t>(frame.size()));
  }

  bool shutdown = false;
  for (int32_t r = 0; r < opts_.size; ++r) {
    shutdown = shutdown || all[r].shutdown;
    if (all[r].join) joined_ranks_.insert(r);
  }

  // 2. cache coordination (reference CoordinateCacheAndState,
  // controller.cc:802): a hit position executes from cache only when
  // every non-joined MEMBER of the entry's process set claimed it —
  // non-members replicate the entry (positions stay identical on all
  // ranks) but never enqueue the tensor, so a world-wide AND would
  // permanently disable the fast path for subset collectives. Agreed
  // invalidations stay a world-wide OR: every rank holds the entry and
  // must erase it in the same cycle.
  std::vector<uint32_t> agreed_positions;
  std::vector<uint64_t> agreed_invalid;
  if (cache != nullptr && cache->capacity() > 0 && at_cache_enabled_) {
    std::vector<std::vector<uint64_t>> bitsets;
    std::vector<uint64_t> any_bits;  // OR of all claims
    for (int32_t r = 0; r < opts_.size; ++r) {
      if (!joined_ranks_.count(r)) {
        bitsets.push_back(all[r].cache_bits);
        for (size_t w = 0; w < all[r].cache_bits.size(); ++w) {
          if (w >= any_bits.size()) any_bits.resize(w + 1, 0);
          any_bits[w] |= all[r].cache_bits[w];
        }
      }
      for (size_t w = 0; w < all[r].invalid_bits.size(); ++w) {
        if (w >= agreed_invalid.size()) agreed_invalid.resize(w + 1, 0);
        agreed_invalid[w] |= all[r].invalid_bits[w];
      }
    }
    if (!bitsets.empty()) {
      // Fast path (the steady-state common case, all entries global):
      // word-wide AND over every non-joined rank, exactly the reference
      // CacheCoordinator. Subset entries can never pass it — their
      // non-members never claim — so positions claimed by someone but
      // not unanimous get a member-scoped check below; global entries
      // there are simply not agreed yet.
      auto hits = ResponseCache::Intersect(bitsets);
      for (size_t w = 0; w < hits.size() && w < agreed_invalid.size();
           ++w) {
        hits[w] &= ~agreed_invalid[w];
      }
      std::vector<uint64_t> partial = any_bits;
      for (size_t w = 0; w < partial.size(); ++w) {
        uint64_t h = w < hits.size() ? hits[w] : 0ull;
        uint64_t inv = w < agreed_invalid.size() ? agreed_invalid[w] : 0ull;
        partial[w] &= ~h & ~inv;
      }
      agreed_positions = ResponseCache::BitsToPositions(hits);
      for (uint32_t pos : ResponseCache::BitsToPositions(partial)) {
        if (cache->NameAt(pos).empty()) continue;  // stale claim
        int32_t sid = cache->Get(pos).process_set_id;
        if (sid == 0) continue;  // global entry, not unanimous
        auto sit = sets_.find(sid);
        if (sit == sets_.end()) continue;  // deregistered since caching
        bool agreed = true;
        for (int32_t m : sit->second.members) {
          if (joined_ranks_.count(m)) continue;
          const auto& bits = all[m].cache_bits;
          size_t w = pos / 64;
          if (w >= bits.size() || !((bits[w] >> (pos % 64)) & 1)) {
            agreed = false;
            break;
          }
        }
        if (agreed) agreed_positions.push_back(pos);
      }
      // deterministic execution order every rank agrees on
      std::sort(agreed_positions.begin(), agreed_positions.end());
    }
  }

  // 3. count full submissions (routed to each op's process-set table)
  std::vector<Response> immediate_errors;
  for (int32_t r = 0; r < opts_.size; ++r) {
    for (const auto& req : all[r].requests) {
      if (req.op == OpType::kBarrier) {
        auto sit = sets_.find(req.process_set_id);
        if (sit == sets_.end() || !sit->second.Contains(r)) {
          Response err;
          err.op = OpType::kError;
          err.tensor_names = {req.name};
          err.process_set_id = req.process_set_id;
          err.error_rank = r;  // fail only the offender's handle
          err.error_reason =
              "barrier on unregistered process set or from non-member "
              "rank " + std::to_string(r);
          immediate_errors.push_back(std::move(err));
          continue;
        }
        sit->second.barrier_ranks.insert(r);
        sit->second.barrier_name = req.name;
        continue;
      }
      IncrementTensorCount(req, r, &immediate_errors);
    }
  }

  // 4. readiness per set: submitted ∪ (joined ∩ members) covers the set
  std::vector<Response> ready;
  for (uint32_t pos : agreed_positions) {
    Response resp = cache->Get(pos);
    ready.push_back(resp);
  }
  std::vector<std::pair<int32_t, std::string>> done;
  // covered group members withheld until their whole group is covered;
  // groups are scoped to their set (a fused batch is one sub-mesh op)
  std::map<std::pair<int32_t, std::string>, std::vector<std::string>>
      group_covered;
  std::set<std::pair<int32_t, std::string>> errored_groups;
  for (auto& skv : sets_) {
    const int32_t sid = skv.first;
    SetState& set = skv.second;
    for (auto& kv : set.table) {
      const Request& first = kv.second.requests.begin()->second;
      auto gkey = std::make_pair(sid, first.group);
      if (!first.group.empty() && !kv.second.error.empty()) {
        errored_groups.insert(gkey);
      }
      size_t covered = kv.second.ranks.size();
      for (int32_t jr : joined_ranks_) {
        if (set.Contains(jr) && !kv.second.ranks.count(jr)) ++covered;
      }
      if (covered < set.members.size()) continue;
      if (first.group.empty()) {
        done.emplace_back(sid, kv.first);
      } else {
        group_covered[gkey].push_back(kv.first);
      }
    }
  }
  // all-or-nothing group readiness (reference group_table.h:25,
  // operations.cc:1518): a group releases only when every member is
  // globally covered; a member missing on any rank holds the whole group
  // (and eventually trips the stall inspector for the missing names)
  for (auto& kv : group_covered) {
    if (errored_groups.count(kv.first)) continue;  // failed below
    const std::string& any = kv.second.front();
    int32_t expect = sets_[kv.first.first]
                         .table[any]
                         .requests.begin()
                         ->second.group_size;
    if (static_cast<int32_t>(kv.second.size()) >= expect) {
      for (auto& n : kv.second) done.emplace_back(kv.first.first, n);
    }
  }
  // A group with any errored member fails as a WHOLE, immediately and on
  // every rank — covered or not. Waiting for full coverage could block
  // forever (e.g. mismatched group sizes mean the larger count never
  // arrives) and would bury the recorded error. Error responses are safe
  // to emit for partially-covered names: ranks without a local entry
  // simply have no handle to fail.
  for (const auto& gkey : errored_groups) {
    for (auto& kv : sets_[gkey.first].table) {
      const Request& first = kv.second.requests.begin()->second;
      if (first.group != gkey.second) continue;
      if (kv.second.error.empty()) {
        kv.second.error =
            "group '" + gkey.second + "' failed on another member";
      }
      done.emplace_back(gkey.first, kv.first);
    }
  }
  // deterministic order: sort newly-ready by (set, name) — completion
  // order across a cycle is unordered anyway since all arrive in the
  // same gather
  std::sort(done.begin(), done.end());
  for (const auto& sn : done) {
    auto sit = sets_.find(sn.first);
    // a deregistration processed earlier in this loop may have retired
    // the set (its stranded tensors were failed via pending_set_errors_)
    if (sit == sets_.end() || !sit->second.table.count(sn.second)) {
      continue;
    }
    ready.push_back(ConstructResponse(sn.first, sn.second));
    sit = sets_.find(sn.first);  // deregister may erase inside Construct
    if (sit != sets_.end()) sit->second.table.erase(sn.second);
    stall_inspector_.RemoveTensor(sn.second);
  }
  for (auto& e : pending_set_errors_) ready.push_back(std::move(e));
  pending_set_errors_.clear();
  for (auto& e : immediate_errors) ready.push_back(std::move(e));

  // 5. join / per-set barrier completion
  ResponseList rl;
  if (static_cast<int32_t>(joined_ranks_.size()) >= opts_.size) {
    Response j;
    j.op = OpType::kJoin;
    rl.join_count = static_cast<int32_t>(joined_ranks_.size());
    ready.push_back(j);
    joined_ranks_.clear();
  }
  // joins still awaiting coverage, broadcast every cycle: peers running
  // the bypassed plan cache must fall back to negotiation so the
  // joiner's zero-contribution semantics can apply (ResponseList
  // pending_joins → hvd_native_pending_joins)
  rl.pending_joins = static_cast<int32_t>(joined_ranks_.size());
  for (auto& skv : sets_) {
    SetState& set = skv.second;
    if (set.barrier_ranks.empty()) continue;
    size_t covered = set.barrier_ranks.size();
    for (int32_t jr : joined_ranks_) {
      if (set.Contains(jr) && !set.barrier_ranks.count(jr)) ++covered;
    }
    if (covered < set.members.size()) continue;
    Response b;
    b.op = OpType::kBarrier;
    b.process_set_id = skv.first;
    // resolves the worker-side handle (Python qualifies per set)
    b.tensor_names = {
        set.barrier_name.empty() ? "__barrier__" : set.barrier_name};
    ready.push_back(b);
    set.barrier_ranks.clear();
  }

  // 6. stall check
  if (stall_inspector_.enabled()) {
    bool kill = stall_inspector_.Check(opts_.size, [&](const std::string& m) {
      ++stall_warnings_;
      fprintf(stderr, "[hvd_tpu_core] WARNING: %s\n", m.c_str());
    });
    if (kill) {
      ready.clear();
      Response r;
      r.op = OpType::kError;
      r.error_reason = "stall shutdown threshold exceeded";
      ready.push_back(r);
      shutdown = true;
    }
  }

  rl.responses = FuseResponses(std::move(ready));
  rl.agreed_invalid_bits = std::move(agreed_invalid);
  rl.shutdown = shutdown;

  // 6b. autotune: score this cycle's traffic, maybe advance the search,
  // and ship the currently-applied parameters so every rank holds the
  // same values (reference parameter_manager.cc:528 SyncParams)
  if (opts_.autotune && !autotune_pinned_) AutotuneObserve(rl);
  if (opts_.autotune) {
    rl.tuned_cycle_ms = tuned_cycle_ms_;
    rl.tuned_threshold = fusion_threshold_;
    rl.tuned_pinned = autotune_pinned_;
    rl.tuned_cache_enabled = at_cache_enabled_;
    rl.tuned_hierarchical = at_hierarchical_;
    rl.tuned_hier_block = at_hier_block_;
    rl.tuned_bayes = opts_.autotune_bayes;
  }

  // 7. broadcast the agreed list
  auto frame = SerializeResponseList(rl);
  for (int32_t r = 1; r < opts_.size; ++r) {
    worker_socks_[r - 1].SendFrame(frame);
  }

  cs_cycles_.fetch_add(1);
  if (!rl.responses.empty()) cs_busy_.fetch_add(1);
  cs_responses_.fetch_add(static_cast<int64_t>(rl.responses.size()));
  cs_cache_hits_.fetch_add(
      static_cast<int64_t>(agreed_positions.size()));
  cs_bytes_tx_.fetch_add(
      static_cast<int64_t>(frame.size()) * (opts_.size - 1));
  cs_wait_us_.fetch_add(static_cast<int64_t>(wait_s * 1e6));
  cs_work_us_.fetch_add(static_cast<int64_t>(
      (MonoSeconds() - t_enter - wait_s) * 1e6));
  return rl;
}

void TcpController::AutotuneObserve(const ResponseList& rl) {
  int64_t bytes = 0;
  for (const auto& r : rl.responses) {
    if (r.op == OpType::kError || r.op == OpType::kJoin ||
        r.op == OpType::kBarrier) {
      continue;
    }
    bytes += r.total_bytes;
  }
  if (bytes == 0) return;  // idle cycle: no signal
  double now = MonoSeconds();
  if (at_sample_busy_ == 0) {
    // anchor cycle: opens the window; its bytes are not counted so N
    // busy cycles score N-1 complete intervals (a 1-cycle window would
    // measure microseconds of its own bookkeeping)
    at_last_busy_ = now;
    at_sample_elapsed_ = 0.0;
    at_sample_bytes_ = 0;
    at_sample_busy_ = 1;
    return;
  }
  // per-interval cap: an idle pause between busy cycles (data stall,
  // eval break) must not poison the candidate's score — it appears as
  // one capped interval instead of the full gap
  double cap = std::max(10.0 * tuned_cycle_ms_ / 1000.0, 0.05);
  at_sample_elapsed_ += std::min(now - at_last_busy_, cap);
  at_last_busy_ = now;
  at_sample_bytes_ += bytes;
  if (++at_sample_busy_ < opts_.autotune_cycles_per_sample + 1) return;

  double elapsed = at_sample_elapsed_;
  double score = at_sample_bytes_ / (elapsed > 1e-9 ? elapsed : 1e-9);
  at_sample_bytes_ = 0;
  at_sample_busy_ = 0;

  if (opts_.autotune_bayes) {
    if (at_phase_ == 0) {
      if (--at_warmup_left_ > 0) return;
      at_phase_ = 1;
      // 5-D space: threshold, cycle, cache toggle, hierarchical toggle,
      // hierarchical block size (reference parameter_manager.h:186's
      // BayesianParameter set, continuous-relaxed)
      bayes_.reset(new BayesianTuner(5));
      ApplyBayesPoint(bayes_->Next());
      return;
    }
    bayes_->Observe(bayes_->Next(), score);
    if (bayes_->n_samples() >= opts_.autotune_bayes_samples) {
      ApplyBayesPoint(bayes_->Best());
      autotune_pinned_ = true;
      return;
    }
    ApplyBayesPoint(bayes_->Next());
    return;
  }

  const size_t n_thr = sizeof(kAtThresholds) / sizeof(kAtThresholds[0]);
  const size_t n_cyc = sizeof(kAtCycles) / sizeof(kAtCycles[0]);
  if (at_phase_ == 0) {
    if (--at_warmup_left_ > 0) return;
    at_phase_ = 1;
    at_idx_ = 0;
    at_best_score_ = 0.0;
    fusion_threshold_ = kAtThresholds[0];
    return;
  }
  if (at_phase_ == 1) {
    if (score > at_best_score_) {
      at_best_score_ = score;
      at_best_threshold_ = fusion_threshold_;
    }
    if (++at_idx_ < n_thr) {
      fusion_threshold_ = kAtThresholds[at_idx_];
      return;
    }
    fusion_threshold_ = at_best_threshold_;
    at_phase_ = 2;
    at_idx_ = 0;
    at_best_score_ = 0.0;
    tuned_cycle_ms_ = kAtCycles[0];
    return;
  }
  // phase 2: cycle-time sweep at the pinned threshold
  if (score > at_best_score_) {
    at_best_score_ = score;
    at_best_cycle_ = tuned_cycle_ms_;
  }
  if (++at_idx_ < n_cyc) {
    tuned_cycle_ms_ = kAtCycles[at_idx_];
    return;
  }
  tuned_cycle_ms_ = at_best_cycle_;
  autotune_pinned_ = true;
}

void TcpController::ApplyBayesPoint(const std::vector<double>& x) {
  // unit cube → knobs: x0 = log2(threshold) in [20, 28] (1 MB..256 MB),
  // x1 = ln(cycle_ms) in [ln 0.25, ln 5] — the same ranges the
  // coordinate-descent grids span; x2/x3 = response-cache and
  // hierarchical toggles (>= 0.5 = on; the seeding design's corners
  // guarantee both values are explored); x4 = log2(ranks per inner ICI
  // domain) in [1, 4] (2..16 ranks, ops/hierarchical.py resolve_block)
  double lg2 = 20.0 + 8.0 * x[0];
  fusion_threshold_ = static_cast<int64_t>(std::pow(2.0, lg2));
  double lo = std::log(0.25), hi = std::log(5.0);
  tuned_cycle_ms_ = std::exp(lo + (hi - lo) * x[1]);
  if (x.size() >= 5) {
    at_cache_enabled_ = x[2] >= 0.5;
    at_hierarchical_ = x[3] >= 0.5;
    at_hier_block_ = static_cast<int64_t>(
        std::pow(2.0, std::floor(1.0 + 3.0 * x[4] + 0.5)));
  }
}

}  // namespace hvd
