#include "wire.h"

namespace hvd {

// Wire protocol version, checked FIRST on every control-plane frame: a
// mixed-version coordinator/worker pair fails cleanly at deserialize
// instead of misparsing the stream from the first changed field onward.
// Bump whenever any serialized layout changes.
//   v1: the first versioned layout + ResponseList.tuned_bayes
static constexpr uint8_t kWireMagic = 0xB5;
// bump on ANY frame-layout change (v2: ResponseList.pending_joins) so a
// mixed-build world fails the version gate loudly instead of misparsing
static constexpr uint8_t kWireVersion = 2;

static void WriteRequest(Writer* w, const Request& r) {
  w->I32(r.rank);
  w->I32(static_cast<int32_t>(r.op));
  w->I32(static_cast<int32_t>(r.dtype));
  w->Str(r.name);
  w->I32(r.root_rank);
  w->I32(r.reduce_op);
  w->F64(r.prescale);
  w->F64(r.postscale);
  w->Vec(r.shape);
  w->Vec(r.splits);
  w->Str(r.group);
  w->I32(r.group_size);
  w->I32(r.process_set_id);
}

static Request ReadRequest(Reader* r) {
  Request q;
  q.rank = r->I32();
  q.op = static_cast<OpType>(r->I32());
  q.dtype = static_cast<DataType>(r->I32());
  q.name = r->Str();
  q.root_rank = r->I32();
  q.reduce_op = r->I32();
  q.prescale = r->F64();
  q.postscale = r->F64();
  q.shape = r->Vec<int64_t>();
  q.splits = r->Vec<int64_t>();
  q.group = r->Str();
  q.group_size = r->I32();
  q.process_set_id = r->I32();
  return q;
}

std::vector<uint8_t> SerializeRequestList(const RequestList& rl) {
  Writer w;
  w.U8(kWireMagic);
  w.U8(kWireVersion);
  w.U8(rl.shutdown ? 1 : 0);
  w.U8(rl.join ? 1 : 0);
  w.Vec(rl.cache_bits);
  w.Vec(rl.invalid_bits);
  w.I32(static_cast<int32_t>(rl.requests.size()));
  for (const auto& r : rl.requests) WriteRequest(&w, r);
  return w.data();
}

bool DeserializeRequestList(const uint8_t* data, size_t len,
                            RequestList* rl) {
  Reader r(data, len);
  if (r.U8() != kWireMagic || r.U8() != kWireVersion) return false;
  rl->shutdown = r.U8() != 0;
  rl->join = r.U8() != 0;
  rl->cache_bits = r.Vec<uint64_t>();
  rl->invalid_bits = r.Vec<uint64_t>();
  int32_t n = r.I32();
  rl->requests.clear();
  for (int32_t i = 0; i < n && r.ok(); ++i) {
    rl->requests.push_back(ReadRequest(&r));
  }
  return r.ok();
}

static void WriteResponse(Writer* w, const Response& resp) {
  w->I32(static_cast<int32_t>(resp.op));
  w->I32(static_cast<int32_t>(resp.tensor_names.size()));
  for (const auto& n : resp.tensor_names) w->Str(n);
  w->Str(resp.error_reason);
  w->I32(resp.root_rank);
  w->I32(resp.reduce_op);
  w->F64(resp.prescale);
  w->F64(resp.postscale);
  w->I32(static_cast<int32_t>(resp.dtype));
  w->I64(resp.total_bytes);
  w->Vec(resp.first_shape);
  w->I32(static_cast<int32_t>(resp.tensor_shapes.size()));
  for (const auto& s : resp.tensor_shapes) w->Vec(s);
  w->Vec(resp.rank_dim0);
  w->Vec(resp.all_splits);
  w->Str(resp.group);
  w->I32(resp.process_set_id);
  w->I32(resp.error_rank);
}

static Response ReadResponse(Reader* r) {
  Response resp;
  resp.op = static_cast<OpType>(r->I32());
  int32_t n = r->I32();
  for (int32_t i = 0; i < n && r->ok(); ++i) {
    resp.tensor_names.push_back(r->Str());
  }
  resp.error_reason = r->Str();
  resp.root_rank = r->I32();
  resp.reduce_op = r->I32();
  resp.prescale = r->F64();
  resp.postscale = r->F64();
  resp.dtype = static_cast<DataType>(r->I32());
  resp.total_bytes = r->I64();
  resp.first_shape = r->Vec<int64_t>();
  int32_t ns = r->I32();
  for (int32_t i = 0; i < ns && r->ok(); ++i) {
    resp.tensor_shapes.push_back(r->Vec<int64_t>());
  }
  resp.rank_dim0 = r->Vec<int64_t>();
  resp.all_splits = r->Vec<int64_t>();
  resp.group = r->Str();
  resp.process_set_id = r->I32();
  resp.error_rank = r->I32();
  return resp;
}

std::vector<uint8_t> SerializeResponseList(const ResponseList& rl) {
  Writer w;
  w.U8(kWireMagic);
  w.U8(kWireVersion);
  w.U8(rl.shutdown ? 1 : 0);
  w.I32(rl.join_count);
  w.I32(rl.pending_joins);
  w.Vec(rl.agreed_invalid_bits);
  w.F64(rl.tuned_cycle_ms);
  w.I64(rl.tuned_threshold);
  w.U8(rl.tuned_pinned ? 1 : 0);
  w.U8(rl.tuned_cache_enabled ? 1 : 0);
  w.U8(rl.tuned_hierarchical ? 1 : 0);
  w.I64(rl.tuned_hier_block);
  w.U8(rl.tuned_bayes ? 1 : 0);
  w.I32(static_cast<int32_t>(rl.responses.size()));
  for (const auto& r : rl.responses) WriteResponse(&w, r);
  return w.data();
}

bool DeserializeResponseList(const uint8_t* data, size_t len,
                             ResponseList* rl) {
  Reader r(data, len);
  if (r.U8() != kWireMagic || r.U8() != kWireVersion) return false;
  rl->shutdown = r.U8() != 0;
  rl->join_count = r.I32();
  rl->pending_joins = r.I32();
  rl->agreed_invalid_bits = r.Vec<uint64_t>();
  rl->tuned_cycle_ms = r.F64();
  rl->tuned_threshold = r.I64();
  rl->tuned_pinned = r.U8() != 0;
  rl->tuned_cache_enabled = r.U8() != 0;
  rl->tuned_hierarchical = r.U8() != 0;
  rl->tuned_hier_block = r.I64();
  rl->tuned_bayes = r.U8() != 0;
  int32_t n = r.I32();
  rl->responses.clear();
  for (int32_t i = 0; i < n && r.ok(); ++i) {
    rl->responses.push_back(ReadResponse(&r));
  }
  return r.ok();
}

}  // namespace hvd
