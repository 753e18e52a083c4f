"""Continuous step profiler: sampled device capture and live attribution.

The port of the JAX package's ``utils/prof.py``. The host timeline,
metrics and the flight recorder stop at the host; this module sees what
the card ran. Every ``HOROVOD_PROF_EVERY``-th step is wrapped in a
``torch.profiler`` window with CUDA activity (CPU activity on a machine
without a card), exported as a Chrome trace, read off the step's thread
(``utils/kineto.py``), and the sampled step is attributed into
**compute / exposed collective / host gap / idle**, which feed the
registry:

* ``hvd_step_compute_frac``, ``hvd_step_exposed_wire_frac``,
  ``hvd_step_idle_frac``: where the sampled step's wall time went;
* ``hvd_overlap_window_measured_frac``: the collective time the card
  hid under compute;
* ``hvd_mfu``: model-FLOPs utilization every step (not only sampled
  ones), once :func:`set_step_flops` declared the step's cost, over the
  card's peak from ``utils/mfu.py`` (no gauge on a card the table does
  not know: the peak is never guessed).

Cost: sampling is off by default, and then the step hook is not even
installed. When on, each sample's measured overhead T (the profiler's
start, the card's synchronize, stop and export on the step's thread;
the sidecar and the parse on their own) charges a budget: the next
sample cannot start until ``T*(1/d - 1)`` seconds have passed
(``HOROVOD_PROF_DUTY_CYCLE`` d, default 2%), so profiling takes at most
about d of the run however slow the export or the parse.

One process holds one profiler window at a time. A sampled step that
finds another window open (a caller's ``torch.profiler``,
``utils/timeline.profiler_trace``) counts an error and skips the
sample; a capture that fails, or whose trace holds no device work, is
an error and not a sample. Nothing here raises into the step.

On a card, each window first runs ``LEAD_SPINS`` short spin kernels,
left out of the attribution: ``torch.profiler`` loses a window's first
device records, the more the older the process, and the spins take
that loss. A trace that kept none of them may have lost the step's
first kernels too, and is refused.

Each sample directory (``HOROVOD_PROF_DIR``, default
``<tmpdir>/hvd_prof/rank<r>``, ``step<N>`` under it) holds the trace and
a ``hvd_prof_meta.json`` sidecar (rank, step, the capture's wall-clock
window, the ``/clock`` offset to the driver), from which
``python -m horovod_tpu_torch.tools.trace_merge --xplane`` places the
card's spans on the merged axis. The profiler rides the step boundary:
``with hvd.metrics.step():`` is the only annotation needed.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import threading
import time
from typing import Callable, Optional

from . import flight as _flight
from . import metrics as _metrics

#: spin kernels (``torch.cuda._sleep``, ATen's ``spin_kernel``) that open
#: every window on a card, and their length in cycles
LEAD_SPINS = 128
LEAD_SPIN_CYCLES = 1000
SPIN_KERNEL = "spin_kernel"
#: seconds the window stays open after the card finished the step: the
#: profiler keeps only device spans inside its window on the host's
#: clock, and a span's end carried over to that clock can fall past it
TAIL_PAD_S = 0.02
#: the trace's file name in a sample directory
TRACE_FILE = "trace.json"

# -- module state (the no-op fast path) ----------------------------------------

_active = False          # True iff sampling and/or MFU accounting is on
_configured = False      # True when configure() (init) armed us
_every = 0               # sample every N-th step; 0 = sampling off
_duty = 0.02             # most of the wall time spent profiling
_dir = ""                # sample-capture root
_step_flops = 0.0        # model FLOPs a step (the whole global batch)
_n_chips = 0             # cards dividing the FLOPs; 0 = the world's size
_lock = threading.Lock()
_counter = 0             # steps seen
_samples = 0             # captures taken
_next_ok_t = 0.0         # monotonic floor for the next sample
_inflight = False        # a capture or its parse is outstanding
_force_next = False      # capture the next step whatever the cadence
_parse_thread: Optional[threading.Thread] = None
_last_attribution: Optional[dict] = None
_last_mfu: Optional[float] = None
_overhead_s = 0.0        # cumulative measured profiling overhead
_errors = 0
_clock: Callable[[], float] = time.monotonic   # injectable for tests


def active() -> bool:
    return _active


def sample_count() -> int:
    return _samples


def overhead_s() -> float:
    """Cumulative measured profiling overhead (capture, export and
    parse): the numerator of the duty-cycle bound."""
    return _overhead_s


def last_attribution() -> Optional[dict]:
    """The latest sampled step's attribution (``kineto.attribute`` with
    ``sampled_step`` and ``mfu``), or None before the first sample."""
    return _last_attribution


def last_mfu() -> Optional[float]:
    return _last_mfu


def set_step_flops(flops: float, n_chips: int = 0) -> None:
    """Declare the model FLOPs of one optimizer step over the whole
    global batch (``utils/mfu.transformer_train_flops`` or
    ``cnn_train_flops``). Turns on the per-step ``hvd_mfu`` gauge: mfu =
    flops / (step time x cards x the card's peak). ``n_chips`` 0: the
    world's size."""
    global _step_flops, _n_chips, _peak_total
    _step_flops = float(flops)
    _n_chips = int(n_chips)
    _peak_total = 0.0  # the card count may have changed
    if _configured:
        _update_activation()


def step_flops() -> float:
    return _step_flops


_peak_total = 0.0  # cached cards x peak FLOP/s; -1: no known peak


def _peak_total_flops() -> Optional[float]:
    """Cards x the card's peak FLOP/s, resolved once (not a per-step
    cost) and cached until ``set_step_flops`` or ``reset``; None off a
    card ``utils/mfu.py`` knows."""
    global _peak_total
    if _peak_total == 0.0:
        from . import mfu as _mfu

        peak = _mfu.peak_flops_per_chip()
        n = _n_chips
        if n <= 0:
            from ..core.state import global_state

            st = global_state()
            n = st.size if st.initialized else 1
        _peak_total = max(n, 1) * peak if peak else -1.0
    return _peak_total if _peak_total > 0 else None


def default_dir() -> str:
    base = _dir or os.path.join(tempfile.gettempdir(), "hvd_prof")
    r = _flight.rank()
    return os.path.join(base, f"rank{max(r, 0)}")


# -- the step wrapper (registered with metrics.set_step_wrapper) --------------

class _Token:
    __slots__ = ("t0", "t0_wall", "logdir", "step", "capture", "cuda",
                 "capture_overhead_s", "mfu")

    def __init__(self, t0: float, t0_wall: float,
                 logdir: Optional[str], step: int):
        self.t0 = t0
        self.t0_wall = t0_wall
        self.logdir = logdir
        self.step = step
        self.capture = None
        self.cuda = False
        self.capture_overhead_s = 0.0
        self.mfu: Optional[float] = None


class _StepWrapper:
    """What ``metrics.step()`` drives: one begin/end pair a step."""

    def begin_step(self):
        if not _active:
            return None
        return _begin_step()

    def end_step(self, token) -> None:
        if token is not None:
            _end_step(token)


_wrapper = _StepWrapper()


def _profiler_busy() -> bool:
    """Whether a ``torch.profiler`` window is already open in this
    process (it holds one at a time)."""
    import torch

    return bool(torch.autograd.profiler._is_profiler_enabled
                or torch._C._autograd._profiler_enabled())


def _start_capture():
    """Open the window: (capture, cuda). On a card, CUDA activity and
    the leading spins; without one, CPU activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if _profiler_busy():
        raise RuntimeError("another torch.profiler window is open")
    cuda = torch.cuda.is_available()
    capture = profile(activities=[ProfilerActivity.CUDA if cuda
                                  else ProfilerActivity.CPU])
    capture.start()
    if cuda:
        for _ in range(LEAD_SPINS):
            torch.cuda._sleep(LEAD_SPIN_CYCLES)
    return capture, cuda


def _stop_capture(token: _Token) -> None:
    """Close the window after the card finished the step, and export its
    trace into the sample directory."""
    import torch

    if token.cuda:
        torch.cuda.synchronize()
        time.sleep(TAIL_PAD_S)
    token.capture.stop()
    token.capture.export_chrome_trace(
        os.path.join(token.logdir, TRACE_FILE))


def _drop_sample() -> None:
    """A capture that failed, or that reads as no device work, is an
    error and not a sample."""
    global _samples
    _note_error()
    with _lock:
        _samples -= 1


def _begin_step() -> _Token:
    global _counter, _inflight, _samples, _force_next
    with _lock:
        _counter += 1
        step = _counter
        sample = not _inflight and (
            (_every > 0
             and step % _every == 0
             and _clock() >= _next_ok_t)
            # a capture requested by the health monitor bypasses the
            # cadence and the duty floor: the one step that explains an
            # alert is worth its cost
            or _force_next
        )
        if sample:
            _inflight = True
            _samples += 1
            _force_next = False
    if not sample:
        return _Token(_clock(), time.time(), None, step)
    logdir = os.path.join(default_dir(), f"step{step}")
    t0 = _clock()
    try:
        os.makedirs(logdir, exist_ok=True)
        capture, cuda = _start_capture()
    except Exception:
        _drop_sample()
        # charged to the budget: a capture that keeps failing backs off
        # under the same bound instead of paying its cost every N steps
        _finish_sample(_clock() - t0)
        return _Token(_clock(), time.time(), None, step)
    tok = _Token(_clock(), time.time(), logdir, step)
    tok.capture, tok.cuda = capture, cuda
    tok.capture_overhead_s = _clock() - t0
    return tok


def _end_step(token: _Token) -> None:
    dt = _clock() - token.t0
    if _step_flops > 0 and dt > 0:
        peak = _peak_total_flops()
        if peak is not None:
            # on the token too: the parse must attach this step's MFU,
            # not a later step's
            token.mfu = _step_flops / (dt * peak)
            _record_mfu(token.mfu)
    if token.logdir is None:
        return
    t0 = _clock()
    try:
        _stop_capture(token)
    except Exception:
        _drop_sample()
        _finish_sample(token.capture_overhead_s + (_clock() - t0))
        return
    token.capture = None
    token.capture_overhead_s += _clock() - t0
    _spawn_parse(token, dt)


def _record_mfu(mfu: float) -> None:
    global _last_mfu
    _last_mfu = mfu
    _metrics.record_mfu(mfu)


def _write_sidecar(token: _Token, host_wall_s: float) -> None:
    """The clock anchor ``tools.trace_merge`` places the card's spans
    by: the capture's wall window on this rank and the ``/clock`` offset
    to the driver (the flight dumps' probe). Written atomically: a torn
    sidecar must not exist under its name."""
    meta = {
        "hvd_prof_meta": 1,
        "rank": _flight.rank(),
        "step": token.step,
        "t_start_unix": token.t0_wall,
        "t_stop_unix": time.time(),
        "host_wall_s": round(host_wall_s, 6),
    }
    meta.update(_flight.clock_probe())
    path = os.path.join(token.logdir, "hvd_prof_meta.json")
    with open(path + ".tmp", "w") as f:
        json.dump(meta, f)
        f.write("\n")
    os.replace(path + ".tmp", path)


def _spawn_parse(token: _Token, host_wall_s: float) -> None:
    """Sidecar, parse and attribution off the step's thread; their time
    charges the duty budget when the thread finishes."""
    global _parse_thread

    def work():
        t0 = _clock()
        try:
            _write_sidecar(token, host_wall_s)
            _parse_sample(token, host_wall_s)
        except Exception:
            _drop_sample()
        finally:
            _finish_sample(token.capture_overhead_s + (_clock() - t0))

    try:
        t = threading.Thread(target=work, daemon=True,
                             name="hvd-prof-parse")
        t.start()
    except Exception:
        # thread exhaustion must not crash the step or wedge sampling
        _drop_sample()
        _finish_sample(token.capture_overhead_s)
        return
    _parse_thread = t


#: capture directories kept a rank: a continuous run must not grow its
#: directory without bound; the newest K stay for trace_merge
_KEEP_SAMPLES = 8


def _prune_samples() -> None:
    """Drop all but the newest ``_KEEP_SAMPLES`` ``step<N>`` directories
    under this rank's root (on the parse thread). Newest by mtime, not
    step number: a restarted run's fresh low-step captures must survive
    a dead run's high-step leftovers in the same root."""
    root = default_dir()
    entries = []
    try:
        for name in os.listdir(root):
            if re.fullmatch(r"step\d+", name):
                try:
                    entries.append(
                        (os.path.getmtime(os.path.join(root, name)),
                         name))
                except OSError:
                    continue
    except OSError:
        return
    entries.sort()
    for _, name in entries[:-_KEEP_SAMPLES or None]:
        shutil.rmtree(os.path.join(root, name), ignore_errors=True)


def _parse_sample(token: _Token, host_wall_s: float) -> None:
    global _last_attribution
    from . import kineto

    _prune_samples()
    trace, _ = kineto.load_trace(os.path.join(token.logdir, TRACE_FILE))
    if token.cuda:
        spins = kineto.op_events(trace)
        spins = [o for o in spins if SPIN_KERNEL in o["name"]]
        if not spins:
            raise kineto.TraceUnavailable(
                f"the window lost all its {LEAD_SPINS} leading spins, "
                "and maybe the step's first kernels")
    ops = kineto.op_events(trace, device_ops=token.cuda,
                           skip=(SPIN_KERNEL,))
    if not ops:
        raise kineto.TraceUnavailable("the capture holds no device work")
    attr = kineto.attribute_by_plane(ops, host_wall_us=host_wall_s * 1e6)
    attr["sampled_step"] = token.step
    if token.mfu is not None:
        attr["mfu"] = round(token.mfu, 6)
    _last_attribution = attr
    _metrics.record_step_attribution(attr)
    _flight.record("prof_sample", f"step{token.step}",
                   compute_frac=attr["compute_frac"],
                   exposed_wire_frac=attr["exposed_wire_frac"])


def _finish_sample(overhead_s: float) -> None:
    """Charge the duty budget and reopen the sampling gate: after a
    sample costing T the next waits T*(1/d - 1), so profiling's share of
    the wall time stays at most d."""
    global _inflight, _next_ok_t, _overhead_s
    with _lock:
        _overhead_s += overhead_s
        if _duty > 0:
            _next_ok_t = _clock() + overhead_s * (1.0 / _duty - 1.0)
        _inflight = False
    # a requested capture may have armed the wrapper with sampling
    # otherwise off: back to the knobs' state
    if not _force_next:
        _update_activation()


def _note_error() -> None:
    global _errors
    _errors += 1


# -- manual step marking (for callers not using metrics.step()) ---------------

class _StepCtx:
    __slots__ = ("_token",)

    def __enter__(self):
        self._token = _wrapper.begin_step()
        return self

    def __exit__(self, *exc):
        _wrapper.end_step(self._token)
        return False


def step() -> "_StepCtx":
    """A step boundary for code that does not use ``metrics.step()``
    (which already drives the profiler). Do not nest the two: each
    entry counts one step."""
    return _StepCtx()


# -- lifecycle (core/basics.py calls configure and on_shutdown) ---------------

def _activate() -> None:
    global _active
    _active = True
    _metrics.set_step_wrapper(_wrapper)


def _update_activation() -> None:
    """Arm or disarm to match the knobs: sampling or MFU wanted, the
    wrapper installed; neither, fully off (``metrics.step()`` back to
    its no-op path)."""
    global _active
    if _every > 0 or _step_flops > 0:
        _activate()
    elif _active:
        _active = False
        if _metrics._step_wrapper is _wrapper:
            _metrics.set_step_wrapper(None)


def request_sample(reason: str = "") -> None:
    """Capture the next step, bypassing the cadence and the duty floor
    (one outstanding capture at a time still holds): the health monitor
    calls this when an alert fires. Arms the wrapper if sampling was
    off; the knobs' state returns after the capture."""
    global _force_next
    _force_next = True
    _flight.record("prof_request", reason or "manual")
    _activate()


def configure(knobs=None, *, every: Optional[int] = None,
              duty_cycle: Optional[float] = None,
              directory: Optional[str] = None,
              clock: Optional[Callable[[], float]] = None) -> None:
    """Arm the profiler from the knobs (``init()``) or explicit
    overrides (tests). ``HOROVOD_PROF_EVERY=0`` (the default) leaves it
    a no-op: no wrapper is installed unless sampling or MFU is
    wanted."""
    global _configured, _every, _duty, _dir, _clock
    _every = int(every if every is not None
                 else getattr(knobs, "prof_every", 0) or 0)
    if duty_cycle is not None:
        _duty = float(duty_cycle)
    else:
        knob_duty = getattr(knobs, "prof_duty_cycle", None)
        # 0 is a valid value (no floor); only None falls back
        _duty = 0.02 if knob_duty is None else float(knob_duty)
    if directory is not None:
        _dir = directory
    elif knobs is not None:
        # a re-init with another HOROVOD_PROF_DIR captures under it
        _dir = getattr(knobs, "prof_dir", "") or ""
    if clock is not None:
        _clock = clock
    _configured = True
    _update_activation()


def join(timeout_s: float = 10.0) -> None:
    """Wait at most ``timeout_s`` for an outstanding sample's parse."""
    t = _parse_thread
    if t is not None and t.is_alive():
        t.join(timeout=timeout_s)


def summary() -> dict:
    """The profiler's state at this moment."""
    return {
        "active": _active,
        "every": _every,
        "duty_cycle": _duty,
        "steps": _counter,
        "samples": _samples,
        "overhead_s": round(_overhead_s, 6),
        "errors": _errors,
        "mfu": _last_mfu,
        "attribution": _last_attribution,
    }


def on_shutdown() -> None:
    """``shutdown()``: stop sampling; the counters stay readable."""
    global _active, _configured
    join(timeout_s=5.0)
    if _configured:
        _configured = False
        _active = False
        if _metrics._step_wrapper is _wrapper:
            _metrics.set_step_wrapper(None)


def reset() -> None:
    """Test hook: back to the disabled, unconfigured state."""
    global _active, _configured, _every, _duty, _dir, _step_flops
    global _n_chips, _counter, _samples, _next_ok_t, _inflight
    global _last_attribution, _last_mfu, _overhead_s, _errors, _clock
    global _parse_thread, _peak_total, _force_next
    join(timeout_s=5.0)
    _active = False
    _configured = False
    _every = 0
    _duty = 0.02
    _dir = ""
    _step_flops = 0.0
    _n_chips = 0
    _peak_total = 0.0
    _counter = 0
    _samples = 0
    _next_ok_t = 0.0
    _inflight = False
    _force_next = False
    _parse_thread = None
    _last_attribution = None
    _last_mfu = None
    _overhead_s = 0.0
    _errors = 0
    _clock = time.monotonic
    if _metrics._step_wrapper is _wrapper:
        _metrics.set_step_wrapper(None)
