"""Chrome-tracing timeline of the host's phases.

The port of the JAX package's ``utils/timeline.py`` (the reference
Horovod's timeline.cc: per-tensor phase events written as Chrome trace
JSON by a writer thread, started and stopped at run time). The
framework's host-side phases (an eager collective's dispatch, a fusion
plan, the negotiation cycle's marks) are recorded here under the
reference's activity names, so ``chrome://tracing`` and Perfetto show
them as they show a Horovod timeline. The device's side is
``torch.profiler``'s: :func:`profiler_trace` records it into a log
directory.

Every trace opens with a ``CLOCK_ANCHOR`` instant that maps its
relative microseconds onto the wall clock and names the rank, so
``python -m horovod_tpu_torch.tools.trace_merge`` can put several
ranks' timelines and flight dumps on one axis. With metrics on, every
closed B/E span also lands in a latency histogram
(``metrics.record_timeline_activity``), trace file or not.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from typing import Optional

from . import metrics as _metrics

# the JAX package's activity names, so one tool reads both packages'
# traces: an eager collective's host-side dispatch span, the negotiation
# cycle's mark and the fusion plan's instant (the eager runtime's
# negotiation and execution phases carry the reference's common.h:79-113
# names, ``ops/eager_runtime._OP_ACTIVITIES``; the serving tier's spans
# are ``serving/server.SERVING_REQUEST`` and ``batcher.SERVING_EXEC``)
XLA_COLLECTIVE = "XLA_COLLECTIVE"
CYCLE_START = "CYCLE_START"
FUSION_PLAN = "FUSION_PLAN"

#: the first event of every trace: the wall time of its own ``ts`` and
#: the emitting rank (wall = time_unix + (ts - anchor ts) / 1e6)
CLOCK_ANCHOR = "CLOCK_ANCHOR"

#: open spans whose end never comes (a failed handle, a name that never
#: repeats) would grow the span table forever: at this size its oldest
#: SPAN_EVICT entries go
SPAN_TABLE_MAX = 8192
SPAN_EVICT = 1024


class Timeline:
    """Chrome trace JSON writer with a background writer thread.

    ``activity_start``/``activity_end`` emit B/E pairs, ``instant`` an
    ``i`` event, each keyed by a tensor (the event's ``tid``)."""

    def __init__(self, filename: Optional[str] = None,
                 mark_cycles: bool = False):
        self._filename = filename
        self._mark_cycles = mark_cycles
        self._q: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._active = False
        self._start_ns = time.perf_counter_ns()
        # the metrics bridge: each open span's start, by (tensor,
        # activity)
        self._span_starts: dict = {}
        if filename:
            self.start(filename)

    def start(self, filename: str, mark_cycles: Optional[bool] = None) -> None:
        """Start writing to ``filename`` (a no-op while writing)."""
        if self._active:
            return
        if mark_cycles is not None:
            self._mark_cycles = mark_cycles
        self._filename = filename
        self._active = True
        self._thread = threading.Thread(
            target=self._writer, name="hvd_torch_timeline", daemon=True)
        self._thread.start()
        self._emit_anchor()

    def _emit_anchor(self) -> None:
        from . import flight as _flight

        self.emit("i", CLOCK_ANCHOR, "clock", {
            "time_unix": time.time(),
            "rank": _flight.rank(),
            "pid": os.getpid(),
        })

    def stop(self) -> None:
        """Stop writing: every queued event is written, then the file
        closes as a JSON array."""
        if not self._active:
            return
        self._active = False
        self._q.put(None)
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def close(self) -> None:
        """``stop``, by the JAX package's name (``shutdown()`` calls
        it); closing a closed timeline does nothing."""
        self.stop()

    @property
    def active(self) -> bool:
        return self._active

    def _now_us(self) -> float:
        return (time.perf_counter_ns() - self._start_ns) / 1e3

    def emit(self, ph: str, name: str, tensor: str,
             args: Optional[dict] = None) -> None:
        if not self._active:
            return
        ev = {
            "ph": ph,
            "name": name,
            "ts": self._now_us(),
            "pid": os.getpid(),
            "tid": tensor,
        }
        if args:
            ev["args"] = args
        self._q.put(ev)

    def activity_start(self, tensor: str, activity: str,
                       args: Optional[dict] = None) -> None:
        if _metrics.enabled():
            if len(self._span_starts) >= SPAN_TABLE_MAX:
                for k in list(self._span_starts)[:SPAN_EVICT]:
                    self._span_starts.pop(k, None)
            self._span_starts[(tensor, activity)] = time.perf_counter_ns()
        self.emit("B", activity, tensor, args)

    def activity_end(self, tensor: str, activity: str) -> None:
        if _metrics.enabled():
            t0 = self._span_starts.pop((tensor, activity), None)
            if t0 is not None:
                _metrics.record_timeline_activity(
                    activity, (time.perf_counter_ns() - t0) / 1e9)
        self.emit("E", activity, tensor)

    def instant(self, tensor: str, name: str,
                args: Optional[dict] = None) -> None:
        self.emit("i", name, tensor, args)

    def mark_cycle_start(self) -> None:
        if self._mark_cycles:
            self.instant("cycle", CYCLE_START)

    class _Activity:
        def __init__(self, tl: "Timeline", tensor: str, activity: str):
            self.tl, self.tensor, self.activity = tl, tensor, activity

        def __enter__(self):
            self.tl.activity_start(self.tensor, self.activity)
            return self

        def __exit__(self, *exc):
            self.tl.activity_end(self.tensor, self.activity)
            return False

    def activity(self, tensor: str, activity: str) -> "Timeline._Activity":
        """A ``with`` block as one B/E span."""
        return Timeline._Activity(self, tensor, activity)

    def _writer(self) -> None:
        with open(self._filename, "w") as f:
            f.write("[\n")
            first = True
            while True:
                ev = self._q.get()
                if ev is None:
                    break
                if not first:
                    f.write(",\n")
                f.write(json.dumps(ev))
                first = False
            f.write("\n]\n")


def active_timeline() -> Optional[Timeline]:
    """The framework's timeline when tracing is on, else None: the one
    gate every event-emitting layer uses. With metrics on it is returned
    even when no trace file is written, since its spans still feed the
    phase histograms (``emit`` drops the events)."""
    from ..core.state import global_state

    tl = global_state().timeline
    if tl is None:
        return None
    return tl if (tl.active or _metrics.enabled()) else None


def profiler_trace(logdir: str):
    """Context manager: the device's side next to the host timeline, a
    ``torch.profiler`` trace of the CPU and (with a card) CUDA
    activities, written as a Chrome trace under ``logdir`` when the
    block ends. The JAX package traces XLA (``jax.profiler.trace``)
    instead. ``utils/kineto.py`` reads the trace, and
    ``tools.device_summary`` summarizes it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)

    def on_trace_ready(prof):
        prof.export_chrome_trace(os.path.join(
            logdir, f"torch_trace_pid{os.getpid()}_{time.time_ns()}.json"))

    return profile(activities=activities, on_trace_ready=on_trace_ready)
