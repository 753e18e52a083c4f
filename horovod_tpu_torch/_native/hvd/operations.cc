// Per-process runtime: background negotiation thread + C API.
//
// Reference: horovod/common/operations.cc —
// `InitializeHorovodOnce` (:827) spawns the background thread,
// `BackgroundThreadLoop` (:401) / `RunLoopOnce` (:722) drive negotiation
// cycles, `EnqueueTensorAllreduces` (:1400) is the entry point, and the C
// API (:903-1370) backs the Python ctypes layer (common/basics.py).
//
// Control/data split: after negotiation this runtime does NOT execute
// collectives — it emits ordered *execution batches* that the Python layer
// runs as torch.distributed collectives on its own process group
// (hvd_native_next_batch / hvd_native_batch_done). The background thread
// owns all communication state; user threads only touch the queue and
// handle table (the reference's single-proxy-thread design rationale,
// operations.cc:379-398).

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include "common.h"
#include "controller.h"
#include "response_cache.h"
#include "tensor_queue.h"
#include "wire.h"

namespace hvd {
namespace {

enum HandleState : int {
  kPending = 0,
  kBatched = 1,
  kDone = 2,
  kFailed = -1,
};

struct Batch {
  int64_t id = 0;
  int64_t cycle = 0;  // negotiation cycle that produced this batch
  Response response;
  std::vector<int64_t> handles;
  // set membership SNAPSHOTTED at batch creation: a deregistration
  // landing between negotiation and the executor's pop must not turn a
  // subset batch into an (empty-members = global) one
  std::vector<int64_t> set_members;
  // autotune sample point SNAPSHOTTED at batch creation, cycle-coherent
  // with the ResponseList that delivered it: workers lag the loop by
  // many cycles (an executor batch can take milliseconds, a cycle ~1ms), so reading
  // the live atomics at pop time lets two ranks stamp different routing
  // for the same negotiated batch — mismatched SPMD programs for one
  // logical collective
  bool tuned_hierarchical = false;
  int64_t tuned_hier_block = 0;
};

struct Global {
  std::unique_ptr<TcpController> controller;
  TensorQueue tensor_queue;
  std::unique_ptr<ResponseCache> cache;

  std::thread bg_thread;
  std::atomic<bool> shutdown{false};
  std::atomic<bool> broken{false};
  std::atomic<bool> initialized{false};
  std::atomic<int64_t> handle_counter{1};
  std::atomic<int64_t> batch_counter{1};
  std::atomic<int64_t> cycle_counter{0};
  std::atomic<int64_t> cache_hits{0};
  std::atomic<int64_t> bytes_negotiated{0};

  std::mutex handle_mu;
  std::condition_variable handle_cv;
  std::unordered_map<int64_t, int> handle_states;

  std::mutex batch_mu;
  std::condition_variable batch_cv;
  std::deque<Batch> batches;

  std::mutex join_mu;
  std::vector<int64_t> join_handles;
  std::atomic<bool> join_requested{false};
  // ranks whose join awaits coverage, mirrored from each cycle's
  // ResponseList: the Python plan cache polls this before dispatching a
  // negotiation-bypassed step (see controller.cc pending_joins)
  std::atomic<int> pending_joins{0};

  // a request held aside because it cache-hit, awaiting global agreement;
  // age counts cycles without agreement — past kMaxHitParkCycles the
  // request renegotiates instead of deadlocking on a peer whose cache
  // entry is gone
  struct ParkedHit {
    Request request;
    int age = 0;
  };
  std::unordered_map<std::string, ParkedHit> pending_hits;
  // requests whose cached metadata changed: parked one cycle while the
  // coordinated invalidation round erases the entry on every rank
  std::unordered_map<std::string, Request> pending_invalid;
  // requests to re-submit through full negotiation next cycle
  std::vector<Request> retry_requests;

  std::atomic<double> cycle_ms{1.0};
  int32_t rank = 0;
  int32_t size = 1;

  // registered process sets, mirrored from kRegisterSet acks (reference
  // process_set.h:89 ProcessSetTable): set id -> sorted member ranks.
  // Batches for sets this rank is not a member of are never emitted.
  std::mutex sets_mu;
  std::map<int32_t, std::vector<int32_t>> process_sets;

  // autotuned values distributed by the coordinator (ResponseList)
  std::atomic<double> tuned_cycle_ms{0.0};
  std::atomic<long long> tuned_threshold{0};
  std::atomic<bool> tuned_pinned{false};
  std::atomic<bool> tuned_cache_enabled{true};
  std::atomic<bool> tuned_hierarchical{false};
  std::atomic<long long> tuned_hier_block{0};
  std::atomic<bool> tuned_bayes{false};

  std::mutex err_mu;
  std::string last_error;
};

Global* g = nullptr;

void SetError(const std::string& e) {
  std::lock_guard<std::mutex> l(g->err_mu);
  g->last_error = e;
}

void SetHandle(int64_t h, int state) {
  {
    std::lock_guard<std::mutex> l(g->handle_mu);
    g->handle_states[h] = state;
  }
  g->handle_cv.notify_all();
}

void FailHandles(const std::vector<int64_t>& hs, const std::string& why) {
  if (!why.empty()) SetError(why);
  {
    std::lock_guard<std::mutex> l(g->handle_mu);
    for (int64_t h : hs) g->handle_states[h] = kFailed;
  }
  g->handle_cv.notify_all();
}

void PushBatch(Batch b) {
  {
    std::lock_guard<std::mutex> l(g->batch_mu);
    g->batches.push_back(std::move(b));
  }
  g->batch_cv.notify_all();
}

// Time a cache-hit request stays parked waiting for every rank to agree
// before falling back to full negotiation — long enough to ride out
// ordinary inter-rank enqueue skew (data-loading jitter spans tens of
// ms), far shorter than the stall window.
constexpr double kHitParkSeconds = 2.0;

// One negotiation cycle (reference RunLoopOnce, operations.cc:722).
// Returns false to stop the loop.
bool RunLoopOnce() {
  const int64_t cycle = g->cycle_counter.fetch_add(1) + 1;
  RequestList own;

  // requests kicked back to full negotiation by earlier cycles
  for (auto& req : g->retry_requests) own.requests.push_back(std::move(req));
  g->retry_requests.clear();

  // drain new requests, classify against the cache
  auto drained = g->tensor_queue.PopMessages(512);
  bool cache_on = g->cache && g->cache->capacity() > 0 &&
                  g->tuned_cache_enabled.load();
  for (auto& req : drained) {
    // grouped requests never ride the cache fast path: a partial set of
    // agreed cache hits could release some group members while others
    // negotiate, splitting the group across cycles — exactly what
    // all-or-nothing readiness forbids (group_table.h:25)
    if (cache_on && req.group.empty()) {
      auto state = g->cache->Lookup(req);
      if (state == ResponseCache::State::kHit) {
        // key copied before the move: C++17 sequences the RHS (which
        // guts req) before the subscript expression
        const std::string name = req.name;
        g->pending_hits[name] = Global::ParkedHit{std::move(req), 0};
        g->cache_hits.fetch_add(1);
        continue;
      }
      if (state == ResponseCache::State::kInvalid) {
        // don't erase locally — rank-local mutation would diverge the
        // replicated position table. Park the request and raise the
        // invalid bit; every rank erases on the coordinator's ORed
        // verdict this cycle (reference CacheCoordinator).
        const std::string name = req.name;
        g->pending_invalid[name] = std::move(req);
        continue;
      }
    }
    own.requests.push_back(std::move(req));
  }
  if (!cache_on && !g->pending_hits.empty()) {
    // the autotune cache toggle flipped off between park and agreement
    // (ApplyBayesPoint explores cache-off samples): hits parked while
    // the cache was on would otherwise never be claimed NOR aged into
    // retry — a permanent hang for those handles. Renegotiate them.
    for (auto& kv : g->pending_hits) {
      g->retry_requests.push_back(std::move(kv.second.request));
    }
    g->pending_hits.clear();
  }
  if (cache_on) {
    if (!g->pending_hits.empty()) {
      // a parked hit whose entry was LRU-evicted since parking must
      // renegotiate: its position slot may now hold a different tensor,
      // and Position() on a missing name would throw
      std::vector<uint32_t> positions;
      positions.reserve(g->pending_hits.size());
      for (auto it = g->pending_hits.begin();
           it != g->pending_hits.end();) {
        if (!g->cache->Contains(it->first)) {
          g->retry_requests.push_back(std::move(it->second.request));
          it = g->pending_hits.erase(it);
        } else {
          positions.push_back(g->cache->Position(it->first));
          ++it;
        }
      }
      own.cache_bits = g->cache->HitBits(positions);
    }
    if (!g->pending_invalid.empty()) {
      std::vector<uint32_t> positions;
      positions.reserve(g->pending_invalid.size());
      for (auto it = g->pending_invalid.begin();
           it != g->pending_invalid.end();) {
        if (!g->cache->Contains(it->first)) {
          // entry vanished (evicted) — nothing left to invalidate
          g->retry_requests.push_back(std::move(it->second));
          it = g->pending_invalid.erase(it);
        } else {
          positions.push_back(g->cache->Position(it->first));
          ++it;
        }
      }
      own.invalid_bits = g->cache->HitBits(positions);
    }
  }
  own.join = g->join_requested.load();
  own.shutdown = g->shutdown.load();

  ResponseList rl = g->controller->RunCycle(own);
  g->pending_joins.store(rl.pending_joins);

  // coordinator-distributed autotune values: every rank applies the same
  // cycle time in the same cycle (threshold is applied inside the
  // coordinator's FuseResponses; recorded here for observability)
  if (rl.tuned_cycle_ms > 0.0) {
    g->cycle_ms.store(rl.tuned_cycle_ms);
    g->tuned_cycle_ms.store(rl.tuned_cycle_ms);
  }
  if (rl.tuned_threshold > 0) g->tuned_threshold.store(rl.tuned_threshold);
  if (rl.tuned_pinned) g->tuned_pinned.store(true);
  g->tuned_cache_enabled.store(rl.tuned_cache_enabled);
  g->tuned_hierarchical.store(rl.tuned_hierarchical);
  if (rl.tuned_hier_block > 0) {
    g->tuned_hier_block.store(rl.tuned_hier_block);
  }
  if (rl.tuned_bayes) g->tuned_bayes.store(true);

  // Apply the coordinated invalidations before any Put from this cycle's
  // responses: same order on every rank, identical cache state after.
  if (cache_on && !rl.agreed_invalid_bits.empty()) {
    for (uint32_t pos :
         ResponseCache::BitsToPositions(rl.agreed_invalid_bits)) {
      const std::string name = g->cache->NameAt(pos);
      if (name.empty()) continue;
      g->cache->Erase(name);
      auto ph = g->pending_hits.find(name);
      if (ph != g->pending_hits.end()) {
        // our parked hit's entry was invalidated elsewhere: renegotiate
        g->retry_requests.push_back(std::move(ph->second.request));
        g->pending_hits.erase(ph);
      }
      auto pi = g->pending_invalid.find(name);
      if (pi != g->pending_invalid.end()) {
        g->retry_requests.push_back(std::move(pi->second));
        g->pending_invalid.erase(pi);
      }
    }
  }
  // Any invalidation the coordinator didn't echo back (shouldn't happen —
  // the verdict is an OR) still renegotiates rather than lingering.
  for (auto& kv : g->pending_invalid) {
    g->retry_requests.push_back(std::move(kv.second));
  }
  g->pending_invalid.clear();

  for (auto& resp : rl.responses) {
    if (resp.op == OpType::kError && resp.error_rank >= 0 &&
        resp.error_rank != g->rank) {
      // a per-rank error (e.g. a non-member enqueue) addressed to
      // another rank: our pending entry of the same qualified name — if
      // any — is legitimate and still negotiating
      continue;
    }
    if (resp.op == OpType::kError && resp.tensor_names.empty()) {
      // global/transport error: fail everything pending (DrainAll covers
      // parked hits and retries — their table entries were never popped)
      auto all = g->tensor_queue.DrainAll();
      g->pending_hits.clear();
      g->pending_invalid.clear();
      g->retry_requests.clear();
      g->broken.store(true);
      FailHandles(all, resp.error_reason);
      continue;
    }
    if (resp.op == OpType::kJoin) {
      std::vector<int64_t> hs;
      {
        std::lock_guard<std::mutex> l(g->join_mu);
        hs.swap(g->join_handles);
      }
      g->join_requested.store(false);
      Batch b;
      b.id = g->batch_counter.fetch_add(1);
      b.cycle = cycle;
      b.response = resp;
      b.handles = hs;
      b.tuned_hierarchical = g->tuned_hierarchical.load();
      b.tuned_hier_block = g->tuned_hier_block.load();
      for (int64_t h : hs) SetHandle(h, kBatched);
      PushBatch(std::move(b));
      continue;
    }
    if (resp.op == OpType::kRegisterSet ||
        resp.op == OpType::kDeregisterSet) {
      // registration acks mutate the local set table and complete their
      // handles directly — there is nothing for the data plane to run
      {
        std::lock_guard<std::mutex> l(g->sets_mu);
        if (resp.op == OpType::kRegisterSet) {
          g->process_sets[resp.process_set_id] = std::vector<int32_t>(
              resp.first_shape.begin(), resp.first_shape.end());
        } else {
          g->process_sets.erase(resp.process_set_id);
        }
      }
      auto regs = g->tensor_queue.PopEntriesWithRequests(resp.tensor_names);
      {
        std::lock_guard<std::mutex> l(g->handle_mu);
        for (const auto& e : regs) g->handle_states[e.handle] = kDone;
      }
      g->handle_cv.notify_all();
      continue;
    }
    // a response for a set this rank is not a member of: replicate the
    // cache mutation below (position tables must stay identical on every
    // rank) but never execute — the sub-mesh collective belongs to the
    // members alone
    bool member = true;
    std::vector<int64_t> snapshot_members;
    if (resp.process_set_id != 0 && resp.op != OpType::kError) {
      std::lock_guard<std::mutex> l(g->sets_mu);
      auto psit = g->process_sets.find(resp.process_set_id);
      member = psit != g->process_sets.end() &&
               std::binary_search(psit->second.begin(), psit->second.end(),
                                  g->rank);
      if (member) {
        snapshot_members.assign(psit->second.begin(), psit->second.end());
      }
    }

    // Non-members must NOT pop pending entries for the response's names:
    // a non-member's same-named entry is its own (illegitimate) enqueue
    // into that set, which the coordinator fails with a TARGETED error —
    // popping it here on the members' success response would orphan its
    // handle as forever-pending. kError responses keep member=true, so
    // the offender's targeted error still resolves its entry.
    std::vector<PendingEntry> entries;
    if (member) {
      entries = g->tensor_queue.PopEntriesWithRequests(resp.tensor_names);
    }
    std::vector<int64_t> handles;
    handles.reserve(entries.size());
    for (const auto& e : entries) handles.push_back(e.handle);
    if (resp.op == OpType::kError) {
      for (const auto& n : resp.tensor_names) g->pending_hits.erase(n);
      FailHandles(handles, resp.error_reason);
      continue;
    }
    // refresh/insert cache entries in response order with each tensor's
    // *own* metadata (never the fused response's representative
    // shape): the local pending Request when we enqueued this
    // tensor, else the response's per-tensor shape (joined ranks receive
    // responses for tensors they never enqueued and must mutate their
    // cache identically to keep positions replicated,
    // response_cache.h:45).
    if (cache_on && resp.op != OpType::kBarrier && resp.group.empty()) {
      std::unordered_map<std::string, const Request*> local;
      for (const auto& e : entries) local[e.request.name] = &e.request;
      for (size_t i = 0; i < resp.tensor_names.size(); ++i) {
        const std::string& name = resp.tensor_names[i];
        // members only: a non-member's parked hit on this name is its
        // own illegitimate request — it must age out and renegotiate
        // into a targeted error, not vanish with an orphaned handle
        if (member) g->pending_hits.erase(name);
        Request req;
        auto it = local.find(name);
        if (it != local.end()) {
          req = *it->second;
        } else {
          req.name = name;
          req.op = resp.op;
          req.dtype = resp.dtype;
          req.reduce_op = resp.reduce_op;
          req.root_rank = resp.root_rank;
          req.prescale = resp.prescale;
          req.postscale = resp.postscale;
          req.process_set_id = resp.process_set_id;
          req.shape = i < resp.tensor_shapes.size() ? resp.tensor_shapes[i]
                                                    : resp.first_shape;
        }
        Response single = resp;
        single.tensor_names = {name};
        single.first_shape = req.shape;
        single.tensor_shapes = {req.shape};
        single.total_bytes = req.ByteSize();
        g->cache->Put(single, req);
      }
    } else if (member) {
      for (const auto& n : resp.tensor_names) g->pending_hits.erase(n);
    }
    if (!member) continue;  // cache replicated; execution is members-only
    g->bytes_negotiated.fetch_add(resp.total_bytes);
    Batch b;
    b.id = g->batch_counter.fetch_add(1);
    b.cycle = cycle;
    b.response = resp;
    b.handles = handles;
    b.set_members = std::move(snapshot_members);
    // loop thread is the sole writer of the tuned atomics and updated
    // them above from THIS cycle's ResponseList — reading them here is
    // cycle-coherent in a way the worker thread's pop-time read is not
    b.tuned_hierarchical = g->tuned_hierarchical.load();
    b.tuned_hier_block = g->tuned_hier_block.load();
    for (int64_t h : handles) SetHandle(h, kBatched);
    PushBatch(std::move(b));
  }

  // Hits still parked after this cycle's verdict: age them; once a hit
  // has waited ~kHitParkSeconds without global agreement (a peer's entry
  // was evicted, or it will simply never hit), fall back to full
  // negotiation so a partial cache hit cannot deadlock.
  if (cache_on && !g->pending_hits.empty()) {
    const int max_park_cycles = std::max(
        8, static_cast<int>(kHitParkSeconds * 1000.0 /
                            std::max(0.01, g->cycle_ms.load())));
    for (auto it = g->pending_hits.begin(); it != g->pending_hits.end();) {
      if (++it->second.age >= max_park_cycles) {
        g->retry_requests.push_back(std::move(it->second.request));
        it = g->pending_hits.erase(it);
      } else {
        ++it;
      }
    }
  }

  return !rl.shutdown;
}

void BackgroundLoop() {
  while (true) {
    // re-read each iteration: autotune retunes the cycle time live
    auto cycle = std::chrono::duration<double, std::milli>(
        g->cycle_ms.load());
    auto start = std::chrono::steady_clock::now();
    // Shutdown exits ONLY through the protocol: the flag rides out in
    // own.shutdown, the coordinator ORs all ranks' flags and echoes the
    // verdict, and RunLoopOnce returns false everywhere in the same
    // cycle. A local early-exit here would leave the coordinator blocked
    // in RecvFrame on our open socket while our process exit waits in the
    // process group's teardown barrier for the coordinator — a cross-
    // process deadlock cycle. (Reference: shutdown is a negotiated,
    // world-wide event — operations.cc:722 RunLoopOnce's should_shut_down.)
    if (!RunLoopOnce()) break;
    auto elapsed = std::chrono::steady_clock::now() - start;
    if (elapsed < cycle) {
      std::this_thread::sleep_for(cycle - elapsed);
    }
  }
  // fail anything still pending so no waiter blocks forever
  auto rest = g->tensor_queue.DrainAll();
  FailHandles(rest, rest.empty() ? "" : "runtime shut down");
  g->batch_cv.notify_all();
  g->initialized.store(false);
}

}  // namespace
}  // namespace hvd

using namespace hvd;

extern "C" {

// --- Bayesian tuner test surface -----------------------------------------
// Lets Python unit-test the GP+EI searcher (bayes.cc) against a known
// objective without spinning up a multi-process world.

static BayesianTuner* bayes_test = nullptr;

void hvd_bayes_test_create(int dims) {
  delete bayes_test;
  bayes_test = new BayesianTuner(dims);
}

// Null guards: ctypes misuse (calling before _create / after _free)
// degrades to a no-op instead of a segfault in the embedding
// process.
void hvd_bayes_test_next(double* out, int dims) {
  if (bayes_test == nullptr) return;
  const std::vector<double>& x = bayes_test->Next();
  for (int d = 0; d < dims; ++d) out[d] = x[d];
}

void hvd_bayes_test_observe(const double* x, int dims, double y) {
  if (bayes_test == nullptr) return;
  bayes_test->Observe(std::vector<double>(x, x + dims), y);
}

void hvd_bayes_test_best(double* out, int dims) {
  if (bayes_test == nullptr) return;
  std::vector<double> b = bayes_test->Best();
  for (int d = 0; d < dims; ++d) out[d] = b[d];
}

void hvd_bayes_test_free() {
  delete bayes_test;
  bayes_test = nullptr;
}

int hvd_native_init(int rank, int size, const char* coord_addr,
                    int coord_port, double cycle_ms, long long fusion_bytes,
                    int cache_capacity, double stall_warning_s,
                    double stall_shutdown_s, int autotune,
                    int autotune_warmup, int autotune_cycles_per_sample,
                    int autotune_bayes) {
  if (g != nullptr && g->initialized.load()) return 0;
  delete g;
  g = new Global();
  g->rank = rank;
  g->size = size;
  g->cycle_ms = cycle_ms;
  for (int r = 0; r < size; ++r) g->process_sets[0].push_back(r);
  g->cache.reset(new ResponseCache(
      cache_capacity < 0 ? 0 : static_cast<size_t>(cache_capacity)));
  ControllerOptions opts;
  opts.rank = rank;
  opts.size = size;
  opts.coordinator_addr = coord_addr ? coord_addr : "127.0.0.1";
  opts.coordinator_port = coord_port;
  opts.fusion_threshold_bytes = fusion_bytes;
  opts.stall_warning_s = stall_warning_s;
  opts.stall_shutdown_s = stall_shutdown_s;
  opts.autotune = autotune != 0;
  opts.cycle_ms = cycle_ms;
  // negative = "use the built-in default"; an explicit 0 is honored
  // (warmup 0 = start sweeping immediately)
  if (autotune_warmup >= 0) opts.autotune_warmup_samples = autotune_warmup;
  if (autotune_cycles_per_sample >= 0) {
    opts.autotune_cycles_per_sample = autotune_cycles_per_sample;
  }
  opts.autotune_bayes = autotune_bayes != 0;
  g->controller.reset(new TcpController(opts));
  g->controller->cache = g->cache.get();
  if (!g->controller->Initialize()) {
    SetError("controller transport initialization failed");
    return -1;
  }
  g->initialized.store(true);
  g->bg_thread = std::thread(BackgroundLoop);
  return 0;
}

void hvd_native_shutdown() {
  if (g == nullptr) return;
  g->shutdown.store(true);
  if (g->bg_thread.joinable()) g->bg_thread.join();
}

int hvd_native_initialized() {
  return g != nullptr && g->initialized.load() ? 1 : 0;
}

int hvd_native_rank() { return g ? g->rank : -1; }
int hvd_native_size() { return g ? g->size : -1; }

long long hvd_native_enqueue(const char* name, int op, int dtype,
                             const long long* shape, int ndim, int reduce_op,
                             int root_rank, double prescale,
                             double postscale, const long long* splits,
                             int nsplits, const char* group,
                             int group_size, int process_set_id) {
  if (g == nullptr || !g->initialized.load() || g->broken.load()) return -1;
  Request req;
  req.rank = g->rank;
  req.op = static_cast<OpType>(op);
  req.dtype = static_cast<DataType>(dtype);
  req.name = name;
  req.root_rank = root_rank;
  req.reduce_op = reduce_op;
  req.prescale = prescale;
  req.postscale = postscale;
  for (int i = 0; i < ndim; ++i) req.shape.push_back(shape[i]);
  for (int i = 0; i < nsplits; ++i) req.splits.push_back(splits[i]);
  if (group != nullptr) req.group = group;
  req.group_size = group_size;
  req.process_set_id = process_set_id;
  int64_t h = g->handle_counter.fetch_add(1);
  SetHandle(h, kPending);
  if (!g->tensor_queue.Add(req, h)) {
    SetError("tensor '" + req.name + "' already pending (duplicate name)");
    SetHandle(h, kFailed);
    return h;
  }
  return h;
}

long long hvd_native_join() {
  if (g == nullptr || !g->initialized.load()) return -1;
  int64_t h = g->handle_counter.fetch_add(1);
  SetHandle(h, kPending);
  {
    std::lock_guard<std::mutex> l(g->join_mu);
    g->join_handles.push_back(h);
  }
  g->join_requested.store(true);
  return h;
}

long long hvd_native_barrier() {
  long long shape[1] = {0};
  return hvd_native_enqueue("__barrier__", static_cast<int>(OpType::kBarrier),
                            0, shape, 0, 0, 0, 1.0, 1.0, nullptr, 0,
                            nullptr, 0, 0);
}

// Register a process set: negotiated like a tensor named "__set__<id>"
// in the global set — every world rank must call this with identical
// membership (reference process_sets.py:123 add_process_set under
// HOROVOD_DYNAMIC_PROCESS_SETS). Returns a handle; kDone once the
// coordinator activated the set on every rank.
long long hvd_native_register_set(int set_id, const long long* ranks,
                                  int n) {
  if (g == nullptr || !g->initialized.load() || g->broken.load()) return -1;
  Request req;
  req.rank = g->rank;
  req.op = OpType::kRegisterSet;
  req.name = "__set__" + std::to_string(set_id);
  req.root_rank = set_id;  // set id rides root_rank (common.h kRegisterSet)
  for (int i = 0; i < n; ++i) req.shape.push_back(ranks[i]);
  std::sort(req.shape.begin(), req.shape.end());
  int64_t h = g->handle_counter.fetch_add(1);
  SetHandle(h, kPending);
  if (!g->tensor_queue.Add(req, h)) {
    SetError("process set " + std::to_string(set_id) +
             " registration already pending");
    SetHandle(h, kFailed);
  }
  return h;
}

long long hvd_native_deregister_set(int set_id) {
  if (g == nullptr || !g->initialized.load() || g->broken.load()) return -1;
  Request req;
  req.rank = g->rank;
  req.op = OpType::kDeregisterSet;
  req.name = "__unset__" + std::to_string(set_id);
  req.root_rank = set_id;
  int64_t h = g->handle_counter.fetch_add(1);
  SetHandle(h, kPending);
  if (!g->tensor_queue.Add(req, h)) {
    SetError("process set " + std::to_string(set_id) +
             " deregistration already pending");
    SetHandle(h, kFailed);
  }
  return h;
}

// Members of a registered set in sorted order; returns the member count,
// 0 for unknown sets (set 0 always answers the full world).
int hvd_native_set_members(int set_id, long long* out, int cap) {
  if (g == nullptr) return 0;
  std::lock_guard<std::mutex> l(g->sets_mu);
  auto it = g->process_sets.find(set_id);
  if (it == g->process_sets.end()) return 0;
  int n = static_cast<int>(it->second.size());
  for (int i = 0; i < n && i < cap; ++i) out[i] = it->second[i];
  return n;
}

int hvd_native_poll(long long handle) {
  if (g == nullptr) return kFailed;
  std::lock_guard<std::mutex> l(g->handle_mu);
  auto it = g->handle_states.find(handle);
  return it == g->handle_states.end() ? kFailed : it->second;
}

int hvd_native_wait(long long handle, double timeout_s) {
  if (g == nullptr) return kFailed;
  std::unique_lock<std::mutex> l(g->handle_mu);
  // an unknown handle was never enqueued or was already released after a
  // terminal wait: report kFailed (same verdict as poll) instead of
  // kPending, which would make a repeat synchronize spin forever
  if (g->handle_states.find(handle) == g->handle_states.end()) {
    return kFailed;
  }
  auto pred = [&] {
    auto it = g->handle_states.find(handle);
    return it == g->handle_states.end() ||
           (it->second == kDone || it->second == kFailed ||
            it->second == kBatched);
  };
  if (!g->handle_cv.wait_for(
          l, std::chrono::duration<double>(timeout_s), pred)) {
    return kPending;
  }
  auto it = g->handle_states.find(handle);
  return it == g->handle_states.end() ? kFailed : it->second;
}

// Serialized batch: id, cycle, op, reduce_op, root_rank, prescale,
// postscale, dtype, total_bytes, names, handles, first_shape,
// error_reason, rank_dim0, all_splits, tensor_shapes, process_set_id,
// set_members, tuned_hierarchical, tuned_hier_block.
// Returns: >0 bytes written; 0 timeout/none; <0 the NEGATED required
// buffer size — the batch stays queued so the caller can retry with a
// larger buffer (an alltoall batch carries an O(size^2) splits matrix,
// which outgrows any fixed buffer at large world sizes).
long long hvd_native_next_batch(unsigned char* buf, long long buflen,
                                double timeout_s) {
  if (g == nullptr) return 0;
  Batch b;
  {
    std::unique_lock<std::mutex> l(g->batch_mu);
    if (!g->batch_cv.wait_for(l, std::chrono::duration<double>(timeout_s),
                              [] { return !g->batches.empty() ||
                                          !g->initialized.load(); })) {
      return 0;
    }
    if (g->batches.empty()) return 0;
    b = std::move(g->batches.front());
    g->batches.pop_front();
  }
  Writer w;
  w.I64(b.id);
  w.I64(b.cycle);
  w.I32(static_cast<int32_t>(b.response.op));
  w.I32(b.response.reduce_op);
  w.I32(b.response.root_rank);
  w.F64(b.response.prescale);
  w.F64(b.response.postscale);
  w.I32(static_cast<int32_t>(b.response.dtype));
  w.I64(b.response.total_bytes);
  w.I32(static_cast<int32_t>(b.response.tensor_names.size()));
  for (const auto& n : b.response.tensor_names) w.Str(n);
  w.Vec(b.handles);
  w.Vec(b.response.first_shape);
  w.Str(b.response.error_reason);
  w.Vec(b.response.rank_dim0);
  w.Vec(b.response.all_splits);
  // per-tensor shapes parallel to tensor_names: a rank executing a fused
  // batch containing tensors it never enqueued (join semantics) must
  // contribute zeros of each tensor's true shape, not first_shape
  w.I32(static_cast<int32_t>(b.response.tensor_shapes.size()));
  for (const auto& s : b.response.tensor_shapes) w.Vec(s);
  // process set: id + sorted global member ranks (empty = global set) —
  // the executor builds the sub-mesh over exactly these processes. The
  // membership was snapshotted when the batch was created: reading the
  // live table here would race with deregistration and emit an
  // empty-members (= global!) batch for a subset op.
  w.I32(b.response.process_set_id);
  w.Vec(b.set_members);
  // the cycle-coherent autotune sample point (see Batch)
  w.U8(b.tuned_hierarchical ? 1 : 0);
  w.I64(b.tuned_hier_block);
  if (static_cast<long long>(w.data().size()) > buflen) {
    // too small: requeue at the front (order preserved) and report the
    // needed size so the caller can retry — dropping a popped batch
    // would hang every handle in it
    {
      std::lock_guard<std::mutex> l(g->batch_mu);
      g->batches.push_front(std::move(b));
    }
    g->batch_cv.notify_all();
    return -static_cast<long long>(w.data().size());
  }
  std::memcpy(buf, w.data().data(), w.data().size());
  return static_cast<long long>(w.data().size());
}

void hvd_native_batch_done(long long batch_id, const long long* handles,
                           int n, int ok) {
  (void)batch_id;
  if (g == nullptr) return;
  {
    std::lock_guard<std::mutex> l(g->handle_mu);
    for (int i = 0; i < n; ++i) {
      // update-only: a waiter that already consumed its result may have
      // released the handle — re-inserting here would leak it forever
      auto it = g->handle_states.find(handles[i]);
      if (it != g->handle_states.end()) it->second = ok ? kDone : kFailed;
    }
  }
  g->handle_cv.notify_all();
}

// Drop a handle's state once the caller has observed a terminal state —
// without this the handle table grows by one entry per collective ever
// issued.
void hvd_native_release(long long handle) {
  if (g == nullptr) return;
  std::lock_guard<std::mutex> l(g->handle_mu);
  g->handle_states.erase(handle);
}

const char* hvd_native_last_error() {
  static thread_local std::string copy;
  if (g == nullptr) return "";
  std::lock_guard<std::mutex> l(g->err_mu);
  copy = g->last_error;
  return copy.c_str();
}

long long hvd_native_stall_warnings() {
  return g && g->controller ? g->controller->stall_warnings() : 0;
}

long long hvd_native_cache_hits() { return g ? g->cache_hits.load() : 0; }

// Ranks whose join is still awaiting full coverage (coordinator state,
// broadcast in every cycle's ResponseList). The eager fast path checks
// this before dispatching a cached-plan step: a pending join means a
// peer stopped contributing, and only negotiation's zero-contribution
// join semantics can reconcile the world.
int hvd_native_pending_joins() { return g ? g->pending_joins.load() : 0; }

long long hvd_native_bytes_negotiated() {
  return g ? g->bytes_negotiated.load() : 0;
}

int hvd_native_coordinator_port() {
  return g && g->controller ? g->controller->bound_port() : 0;
}

// Autotuned parameters as distributed by the coordinator — identical on
// every rank (the agreement test's observable).
double hvd_native_tuned_cycle_ms() {
  return g ? g->tuned_cycle_ms.load() : 0.0;
}

long long hvd_native_tuned_threshold() {
  return g ? g->tuned_threshold.load() : 0;
}

int hvd_native_tuned_pinned() {
  return g && g->tuned_pinned.load() ? 1 : 0;
}

int hvd_native_tuned_cache_enabled() {
  return (g == nullptr || g->tuned_cache_enabled.load()) ? 1 : 0;
}

int hvd_native_tuned_hierarchical() {
  return g && g->tuned_hierarchical.load() ? 1 : 0;
}

// true iff the 5-D Bayes search owns the cache/hierarchical dims —
// gate for applying those winners to user-visible knobs
int hvd_native_tuned_bayes() {
  return g && g->tuned_bayes.load() ? 1 : 0;
}

// Coordinator cycle accounting (rank 0 only; zeros elsewhere). out[8]:
// cycles, busy_cycles, wait_us, work_us, bytes_rx, bytes_tx,
// cache_hit_positions, responses. Separates coordinator CPU work from
// wall-clock blocked on worker frames (controller.h CycleStats).
void hvd_native_coord_cycle_stats(double* out) {
  for (int i = 0; i < 8; ++i) out[i] = 0.0;
  if (g == nullptr || g->controller == nullptr) return;
  auto s = g->controller->cycle_stats();
  out[0] = static_cast<double>(s.cycles);
  out[1] = static_cast<double>(s.busy_cycles);
  out[2] = static_cast<double>(s.wait_us);
  out[3] = static_cast<double>(s.work_us);
  out[4] = static_cast<double>(s.bytes_rx);
  out[5] = static_cast<double>(s.bytes_tx);
  out[6] = static_cast<double>(s.cache_hit_positions);
  out[7] = static_cast<double>(s.responses);
}

long long hvd_native_tuned_hier_block() {
  return g ? g->tuned_hier_block.load() : 0;
}

}  // extern "C"
