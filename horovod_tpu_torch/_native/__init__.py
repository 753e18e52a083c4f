"""ctypes bindings for the native control-plane runtime.

The port of the JAX package's ``_native/__init__.py`` (reference
common/basics.py:29: ``HorovodBasics`` loads the compiled C library with
ctypes and wraps the C API of operations.cc:903-1370). The C++ sources
in ``hvd/`` are the controller, copied: TCP negotiation, the response
cache, fusion planning and the stall inspector. They depend on no
framework.

The library is built on first use with ``g++ -std=c++17 -O2 -fPIC
-pthread`` into ``build/native/`` at the checkout's root, one compiler
per source in parallel, then linked. The build holds an ``fcntl`` lock
and moves the finished library into place with ``os.replace``, so
processes that build at once (test workers) never load a half-written
file, and a process that already loaded the old library keeps it. It
rebuilds when any source is newer than the library. A failed build
raises.

The module imports only the standard library, so a process can load it
by its path without the package (``tests/test_torch_native_runtime.py``
does, to keep its spawned ranks light); ``torch`` is imported only to
map dtype codes to ``torch.dtype``\\ s.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import struct
import subprocess
import tempfile
import threading
from typing import List, Optional, Sequence

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC_DIR = os.path.join(_DIR, "hvd")
#: the checkout's root (this file is horovod_tpu_torch/_native/__init__.py)
_ROOT = os.path.dirname(os.path.dirname(_DIR))
BUILD_DIR = os.path.join(_ROOT, "build", "native")
LIB_PATH = os.path.join(BUILD_DIR, "libhvd_torch_core.so")
SOURCES = ("wire.cc", "tcp.cc", "tensor_queue.cc", "response_cache.cc",
           "stall_inspector.cc", "bayes.cc", "controller.cc",
           "operations.cc")
CXX_FLAGS = ("-std=c++17", "-O2", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

# OpType values (hvd/common.h)
OP_ALLREDUCE = 0
OP_ALLGATHER = 1
OP_BROADCAST = 2
OP_ALLTOALL = 3
OP_REDUCESCATTER = 4
OP_JOIN = 5
OP_BARRIER = 6
OP_ERROR = 7
OP_REGISTER_SET = 8
OP_DEREGISTER_SET = 9

# DataType values (hvd/common.h), by the dtype's name (torch.<name>)
DTYPE_CODES = {
    "uint8": 0, "int8": 1, "uint16": 2, "int16": 3, "int32": 4,
    "int64": 5, "float16": 6, "float32": 7, "float64": 8, "bool": 9,
    "bfloat16": 10,
}
DTYPE_NAMES = {v: k for k, v in DTYPE_CODES.items()}

# handle states (operations.cc)
PENDING = 0
BATCHED = 1
DONE = 2
FAILED = -1


def dtype_name(dtype) -> str:
    """The name of a ``torch.dtype`` (or of a dtype name) as the codes
    key it: ``torch.bfloat16`` -> ``"bfloat16"``."""
    name = str(dtype)
    return name[len("torch."):] if name.startswith("torch.") else name


def dtype_code(dtype) -> int:
    """The controller's code of a ``torch.dtype`` or dtype name."""
    name = dtype_name(dtype)
    if name not in DTYPE_CODES:
        raise ValueError(f"the native runtime carries no dtype {name!r}")
    return DTYPE_CODES[name]


def torch_dtype(code):
    """The ``torch.dtype`` of a controller code (10 is
    ``torch.bfloat16``), or of a dtype name."""
    import torch

    name = DTYPE_NAMES.get(code, code)
    return getattr(torch, name)


# -- build --------------------------------------------------------------------

def _sources() -> List[str]:
    return sorted(os.path.join(_SRC_DIR, f) for f in os.listdir(_SRC_DIR)
                  if f.endswith((".cc", ".h")))


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    lib_mtime = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(p) > lib_mtime for p in _sources())


def _compile(tmp: str, cxx: str) -> str:
    """Compile every source in parallel into ``tmp`` and link them; the
    library's path in ``tmp``. Raises with the compiler's output."""
    procs = []
    for src in SOURCES:
        obj = os.path.join(tmp, src[:-3] + ".o")
        procs.append((src, subprocess.Popen(
            [cxx, *CXX_FLAGS, "-c", "-o", obj, os.path.join(_SRC_DIR, src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for src, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"{src}:\n{out.decode(errors='replace')}")
    if errors:
        raise RuntimeError("native runtime build failed:\n"
                           + "\n".join(errors))
    lib = os.path.join(tmp, os.path.basename(LIB_PATH))
    link = subprocess.run(
        [cxx, "-shared", "-pthread", "-o", lib,
         *(os.path.join(tmp, s[:-3] + ".o") for s in SOURCES)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if link.returncode != 0:
        raise RuntimeError("native runtime link failed:\n"
                           + link.stdout.decode(errors="replace"))
    return lib


def build(force: bool = False) -> str:
    """Build the library when it is missing or older than a source (or
    ``force``); returns its path. Safe with several processes building
    at once: they queue on a lock file, and the first one's library is
    moved into place whole."""
    import fcntl

    with _lock:
        if not force and not _stale():
            return LIB_PATH
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(os.path.join(BUILD_DIR, ".lock"), "w") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            try:
                if force or _stale():
                    cxx = os.environ.get("CXX", "g++")
                    tmp = tempfile.mkdtemp(prefix=".build-", dir=BUILD_DIR)
                    try:
                        os.replace(_compile(tmp, cxx), LIB_PATH)
                    finally:
                        shutil.rmtree(tmp, ignore_errors=True)
            finally:
                fcntl.flock(lk, fcntl.LOCK_UN)
    return LIB_PATH


def load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    lib.hvd_native_init.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_double, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.hvd_native_init.restype = ctypes.c_int
    lib.hvd_bayes_test_create.argtypes = [ctypes.c_int]
    lib.hvd_bayes_test_next.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
    ]
    lib.hvd_bayes_test_observe.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_double,
    ]
    lib.hvd_bayes_test_best.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
    ]
    lib.hvd_native_tuned_cycle_ms.restype = ctypes.c_double
    lib.hvd_native_tuned_threshold.restype = ctypes.c_longlong
    lib.hvd_native_tuned_pinned.restype = ctypes.c_int
    lib.hvd_native_tuned_cache_enabled.restype = ctypes.c_int
    lib.hvd_native_tuned_hierarchical.restype = ctypes.c_int
    lib.hvd_native_tuned_hier_block.restype = ctypes.c_longlong
    lib.hvd_native_tuned_bayes.restype = ctypes.c_int
    lib.hvd_native_coord_cycle_stats.argtypes = [
        ctypes.POINTER(ctypes.c_double)]
    lib.hvd_native_coord_cycle_stats.restype = None
    lib.hvd_native_enqueue.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
    ]
    lib.hvd_native_enqueue.restype = ctypes.c_longlong
    lib.hvd_native_register_set.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
    ]
    lib.hvd_native_register_set.restype = ctypes.c_longlong
    lib.hvd_native_deregister_set.argtypes = [ctypes.c_int]
    lib.hvd_native_deregister_set.restype = ctypes.c_longlong
    lib.hvd_native_set_members.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
    ]
    lib.hvd_native_set_members.restype = ctypes.c_int
    lib.hvd_native_join.restype = ctypes.c_longlong
    lib.hvd_native_barrier.restype = ctypes.c_longlong
    lib.hvd_native_poll.argtypes = [ctypes.c_longlong]
    lib.hvd_native_poll.restype = ctypes.c_int
    lib.hvd_native_wait.argtypes = [ctypes.c_longlong, ctypes.c_double]
    lib.hvd_native_wait.restype = ctypes.c_int
    lib.hvd_native_next_batch.argtypes = [
        ctypes.c_char_p, ctypes.c_longlong, ctypes.c_double,
    ]
    lib.hvd_native_next_batch.restype = ctypes.c_longlong
    lib.hvd_native_batch_done.argtypes = [
        ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
        ctypes.c_int,
    ]
    lib.hvd_native_release.argtypes = [ctypes.c_longlong]
    lib.hvd_native_last_error.restype = ctypes.c_char_p
    lib.hvd_native_stall_warnings.restype = ctypes.c_longlong
    lib.hvd_native_cache_hits.restype = ctypes.c_longlong
    lib.hvd_native_pending_joins.restype = ctypes.c_int
    lib.hvd_native_bytes_negotiated.restype = ctypes.c_longlong
    lib.hvd_native_coordinator_port.restype = ctypes.c_int
    _lib = lib
    return lib


class ExecutionBatch:
    """A negotiated, fused batch the data plane must now execute: the
    Python-side view of a controller Response. ``dtype`` is a controller
    code (native batches) or a dtype name (batches built in Python)."""

    def __init__(self, batch_id, op, reduce_op, root_rank, prescale,
                 postscale, dtype, total_bytes, names, handles, first_shape,
                 error_reason, cycle=0, rank_dim0=(), all_splits=(),
                 shapes=(), process_set_id=0, set_ranks=(),
                 tuned_hierarchical=False, tuned_hier_block=0):
        self.batch_id = batch_id
        self.cycle = cycle
        # autotune sample point snapshotted by the native loop at batch
        # creation: cycle-coherent across ranks, unlike a pop-time read
        # of the rank-local atomics
        self.tuned_hierarchical = tuned_hierarchical
        self.tuned_hier_block = tuned_hier_block
        self.rank_dim0 = list(rank_dim0)    # allgather: per-MEMBER dim-0
        self.all_splits = list(all_splits)  # alltoall: set-local matrix
        self.shapes = [list(s) for s in shapes]  # per-tensor, ∥ names
        self.process_set_id = process_set_id
        # sorted global ranks of the op's process set; [] = global set
        self.set_ranks = [int(r) for r in set_ranks]
        self.op = op
        self.reduce_op = reduce_op
        self.root_rank = root_rank
        self.prescale = prescale
        self.postscale = postscale
        self.dtype = dtype
        self.total_bytes = total_bytes
        self.names = names
        self.handles = handles
        self.first_shape = first_shape
        self.error_reason = error_reason

    def __repr__(self):
        return (f"ExecutionBatch(id={self.batch_id}, op={self.op}, "
                f"names={self.names})")


class _BatchReader:
    def __init__(self, data: bytes):
        self._d = data
        self._p = 0

    def _take(self, fmt: str, n: int):
        v = struct.unpack_from(fmt, self._d, self._p)[0]
        self._p += n
        return v

    def i32(self):
        return self._take("<i", 4)

    def i64(self):
        return self._take("<q", 8)

    def f64(self):
        return self._take("<d", 8)

    def s(self):
        n = self.i32()
        v = self._d[self._p:self._p + n].decode()
        self._p += n
        return v

    def vec64(self):
        n = self.i32()
        return [self.i64() for _ in range(n)]

    def u8(self):
        v = self._d[self._p]
        self._p += 1
        return v


class NativeRuntime:
    """Typed wrapper over the C API for one process."""

    def __init__(self):
        self._lib = load()

    def init(self, rank: int, size: int, coordinator_addr: str = "127.0.0.1",
             coordinator_port: int = 0, cycle_ms: float = 1.0,
             fusion_threshold: int = 128 << 20, cache_capacity: int = 1024,
             stall_warning_s: float = 60.0,
             stall_shutdown_s: float = 0.0,
             autotune: bool = False,
             autotune_warmup: int = -1,
             autotune_cycles_per_sample: int = -1,
             autotune_bayes: bool = False) -> None:
        rc = self._lib.hvd_native_init(
            rank, size, coordinator_addr.encode(), coordinator_port,
            cycle_ms, fusion_threshold, cache_capacity, stall_warning_s,
            stall_shutdown_s, 1 if autotune else 0, autotune_warmup,
            autotune_cycles_per_sample, 1 if autotune_bayes else 0,
        )
        if rc != 0:
            raise RuntimeError(
                f"native runtime init failed: {self.last_error()}"
            )

    def shutdown(self) -> None:
        self._lib.hvd_native_shutdown()

    def initialized(self) -> bool:
        return bool(self._lib.hvd_native_initialized())

    def enqueue(self, name: str, op: int, dtype,
                shape: Sequence[int], reduce_op: int = 1,
                root_rank: int = 0, prescale: float = 1.0,
                postscale: float = 1.0,
                splits: Optional[Sequence[int]] = None,
                group: Optional[str] = None,
                group_size: int = 0,
                process_set_id: int = 0) -> int:
        """Submit one tensor's metadata; ``dtype`` is a ``torch.dtype``
        or its name. Returns the handle."""
        arr = (ctypes.c_longlong * len(shape))(*shape)
        sp = (ctypes.c_longlong * len(splits))(*splits) if splits else None
        h = self._lib.hvd_native_enqueue(
            name.encode(), op, dtype_code(dtype), arr, len(shape),
            reduce_op, root_rank, prescale, postscale,
            sp, len(splits) if splits else 0,
            group.encode() if group else None, group_size, process_set_id,
        )
        if h < 0:
            raise RuntimeError(
                f"enqueue failed: {self.last_error()}"
            )
        return h

    def register_set(self, set_id: int, ranks: Sequence[int]) -> int:
        """Negotiated process-set registration (all world ranks must call
        with identical membership); returns a handle to wait on."""
        arr = (ctypes.c_longlong * len(ranks))(*ranks)
        h = self._lib.hvd_native_register_set(set_id, arr, len(ranks))
        if h < 0:
            raise RuntimeError(
                f"register_set failed: {self.last_error()}"
            )
        return h

    def deregister_set(self, set_id: int) -> int:
        h = self._lib.hvd_native_deregister_set(set_id)
        if h < 0:
            raise RuntimeError(
                f"deregister_set failed: {self.last_error()}"
            )
        return h

    def set_members(self, set_id: int) -> Optional[List[int]]:
        """Sorted global ranks of a registered set; None if unknown."""
        cap = 4096
        arr = (ctypes.c_longlong * cap)()
        n = self._lib.hvd_native_set_members(set_id, arr, cap)
        if n <= 0:
            return None
        if n > cap:  # world larger than cap: retry exact
            arr = (ctypes.c_longlong * n)()
            n = self._lib.hvd_native_set_members(set_id, arr, n)
        return [int(arr[i]) for i in range(n)]

    def join(self) -> int:
        return self._lib.hvd_native_join()

    def barrier(self) -> int:
        return self._lib.hvd_native_barrier()

    def poll(self, handle: int) -> int:
        return self._lib.hvd_native_poll(handle)

    def wait(self, handle: int, timeout_s: float = 60.0) -> int:
        return self._lib.hvd_native_wait(handle, timeout_s)

    def release(self, handle: int) -> None:
        """Free a handle's runtime state after a terminal wait/poll."""
        self._lib.hvd_native_release(handle)

    def next_batch(self, timeout_s: float = 1.0) -> Optional[ExecutionBatch]:
        buf = ctypes.create_string_buffer(1 << 20)
        n = self._lib.hvd_native_next_batch(buf, len(buf), timeout_s)
        if n < 0:
            # buffer too small (large-world splits matrix): the batch was
            # requeued; retry with the exact required size
            buf = ctypes.create_string_buffer(-n)
            n = self._lib.hvd_native_next_batch(buf, len(buf), timeout_s)
        if n <= 0:
            return None
        r = _BatchReader(buf.raw[:n])
        batch_id = r.i64()
        cycle = r.i64()
        op = r.i32()
        reduce_op = r.i32()
        root_rank = r.i32()
        prescale = r.f64()
        postscale = r.f64()
        dtype = r.i32()
        total_bytes = r.i64()
        names = [r.s() for _ in range(r.i32())]
        handles = r.vec64()
        first_shape = r.vec64()
        error_reason = r.s()
        rank_dim0 = r.vec64()
        all_splits = r.vec64()
        shapes = [r.vec64() for _ in range(r.i32())]
        process_set_id = r.i32()
        set_ranks = r.vec64()
        tuned_hierarchical = r.u8() != 0
        tuned_hier_block = r.i64()
        return ExecutionBatch(batch_id, op, reduce_op, root_rank, prescale,
                              postscale, dtype, total_bytes, names, handles,
                              first_shape, error_reason, cycle=cycle,
                              rank_dim0=rank_dim0, all_splits=all_splits,
                              shapes=shapes, process_set_id=process_set_id,
                              set_ranks=set_ranks,
                              tuned_hierarchical=tuned_hierarchical,
                              tuned_hier_block=tuned_hier_block)

    def batch_done(self, batch: ExecutionBatch, ok: bool = True) -> None:
        arr = (ctypes.c_longlong * len(batch.handles))(*batch.handles)
        self._lib.hvd_native_batch_done(
            batch.batch_id, arr, len(batch.handles), 1 if ok else 0
        )

    def last_error(self) -> str:
        return self._lib.hvd_native_last_error().decode()

    def stall_warnings(self) -> int:
        return self._lib.hvd_native_stall_warnings()

    def cache_hits(self) -> int:
        return self._lib.hvd_native_cache_hits()

    def pending_joins(self) -> int:
        """Ranks whose join still awaits full coverage (broadcast in
        every negotiation cycle's ResponseList): the plan cache's
        fall-back trigger for a peer that stopped contributing."""
        return self._lib.hvd_native_pending_joins()

    def bytes_negotiated(self) -> int:
        return self._lib.hvd_native_bytes_negotiated()

    def coordinator_port(self) -> int:
        return self._lib.hvd_native_coordinator_port()

    def tuned_cycle_ms(self) -> float:
        return self._lib.hvd_native_tuned_cycle_ms()

    def tuned_threshold(self) -> int:
        return self._lib.hvd_native_tuned_threshold()

    def tuned_pinned(self) -> bool:
        return bool(self._lib.hvd_native_tuned_pinned())

    def tuned_cache_enabled(self) -> bool:
        return bool(self._lib.hvd_native_tuned_cache_enabled())

    def tuned_hierarchical(self) -> bool:
        return bool(self._lib.hvd_native_tuned_hierarchical())

    def tuned_hier_block(self) -> int:
        return self._lib.hvd_native_tuned_hier_block()

    def tuned_bayes(self) -> bool:
        """Whether the 5-D Bayes search owns the cache/hierarchical
        dims (the 2-D coordinate-descent tuner never explores them)."""
        return bool(self._lib.hvd_native_tuned_bayes())

    def stats(self) -> dict:
        """One cumulative-stats snapshot: cache, wire, stalls and the
        coordinator's cycle accounting."""
        s = {
            "cache_hits": int(self.cache_hits()),
            "bytes_negotiated": int(self.bytes_negotiated()),
            "stall_warnings": int(self.stall_warnings()),
        }
        s.update(self.coord_cycle_stats())
        return s

    def coord_cycle_stats(self) -> dict:
        """Coordinator-side cycle accounting (rank 0; zeros elsewhere):
        the coordinator's CPU work per cycle apart from the wall time it
        waited on worker frames, bytes on the wire and cache-hit
        positions (reference cycle bookkeeping, operations.cc:722)."""
        buf = (ctypes.c_double * 8)()
        self._lib.hvd_native_coord_cycle_stats(buf)
        keys = ("cycles", "busy_cycles", "wait_us", "work_us",
                "bytes_rx", "bytes_tx", "cache_hit_positions",
                "responses")
        return {k: float(v) for k, v in zip(keys, buf)}
