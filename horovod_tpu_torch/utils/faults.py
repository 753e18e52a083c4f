"""Deterministic fault injection for the control plane.

The port of the JAX package's ``utils/faults.py``: a spec string —
``HOROVOD_TPU_FAULT_SPEC`` (the launcher's ``--fault-spec``) — compiles
into rules that fire at named injection points. The port's points are
the HTTP key/value client's verbs (``http.put``, ``http.get``,
``http.delete``) and its server (``http.server``, a 503), the elastic
driver's and workers' (``discovery.poll``, ``worker.register``,
``rendezvous.init``, ``driver.exec``, ``worker.notify``, ``worker``),
and the eager runtime's (``ops/eager_runtime.py``): ``collective`` at
every enqueue (an ``error`` there is raised as
``HorovodInternalError``) and ``eager.fast_path`` when a plan would
freeze (an ``error`` vetoes it and the runtime stays on negotiation).

Spec grammar (entries separated by ``;`` or ``,``; fields by ``:``)::

    point:action[:probability][:key=value ...]

    http.put:error:0.3:seed=7        30% of KV puts raise (seeded rng)
    worker:kill:rank=2:step=5        rank 2's worker dies at commit 5
    discovery:flap:after=5:times=1   one empty discovery poll
    collective:delay:secs=0.02       20ms pause on every enqueue
    checkpoint.save:error:times=2    first two saves fail (then heal)

Actions:

* ``error`` — raise :class:`InjectedFault` (a ``ConnectionError``, so
  real retry paths treat it exactly like a transport failure).
* ``delay`` — sleep ``secs`` (default 0.05) in the caller.
* ``kill``  — ``os._exit(code)`` (default 1): simulated process death.
* ``flap``  — cooperative: ``inject()`` returns the action name and the
  call site implements the behavior (discovery returns an empty host
  set for one poll).
* ``corrupt`` — at a payload site (:func:`corrupt`: the emergency
  snapshot's ``emergency.payload``, the replica's
  ``replication.payload``) XOR-flips ``nbytes`` (default 8) bytes at
  positions drawn from the rule's seeded rng; at an ``inject()`` site,
  which has no payload, it is cooperative like ``flap``.

A rule's ``point`` matches an injection point exactly or as a
dot-prefix (``http`` matches ``http.put``). Remaining ``key=value``
fields are either rule parameters (``seed``, ``times``, ``after``,
``secs``, ``code``) or context constraints matched against the
``inject()`` call's keyword context (``rank=2``, ``step=5``,
``scope=workers``); a constraint whose key the call site does not
supply never matches, so a ``worker:kill:step=5`` rule cannot
accidentally fire at ``worker.register``.

Determinism: each rule owns a ``random.Random(seed)`` (seed defaults
to 0), so a given spec produces the same fire pattern every run —
chaos tests assert exact recovery behavior, not luck.

Cost discipline: with the spec unset the module is disabled and every
``inject()`` is a single predicted branch.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from . import metrics as _metrics

# ---------------------------------------------------------------------------
# module gate (the no-op fast path)
# ---------------------------------------------------------------------------

_enabled = False
_rules: List["_Rule"] = []
# RLock, not Lock: a signal handler that injects may interrupt the
# main thread while it holds this lock inside inject() — re-entry from
# the same thread must not self-deadlock
_lock = threading.RLock()

# test hook: kill-action exit (os._exit in production)
_exit = os._exit
# test hook: delay-action sleep
_sleep = time.sleep

ENV_SPEC = "HOROVOD_TPU_FAULT_SPEC"

_ACTIONS = ("error", "delay", "kill", "flap", "corrupt")
_PARAM_KEYS = ("seed", "times", "after", "secs", "code", "nbytes")


class InjectedFault(ConnectionError):
    """An injected transport-shaped failure. Subclasses
    ``ConnectionError`` so the retry machinery and every call site that
    survives real ECONNRESETs handles it identically."""


class FaultSpecError(ValueError):
    """The fault spec string could not be parsed."""


class _Rule:
    __slots__ = (
        "point", "action", "prob", "times", "after", "secs", "code",
        "nbytes", "match", "_rng", "calls", "fires", "text",
    )

    def __init__(self, text: str):
        import random

        fields = [f for f in text.strip().split(":") if f != ""]
        if len(fields) < 2:
            raise FaultSpecError(
                f"fault rule {text!r} needs at least point:action"
            )
        self.text = text.strip()
        self.point = fields[0]
        self.action = fields[1]
        if self.action not in _ACTIONS:
            raise FaultSpecError(
                f"unknown fault action {self.action!r} in {text!r} "
                f"(know {_ACTIONS})"
            )
        self.prob = 1.0
        self.times: Optional[int] = None
        self.after = 0
        self.secs = 0.05
        self.code = 1
        self.nbytes = 8
        self.match: Dict[str, str] = {}
        seed = 0
        for field in fields[2:]:
            key, sep, value = field.partition("=")
            if not sep:
                try:
                    self.prob = float(field)
                except ValueError:
                    raise FaultSpecError(
                        f"bare field {field!r} in {text!r} is not a "
                        "probability"
                    ) from None
                if not 0.0 <= self.prob <= 1.0:
                    raise FaultSpecError(
                        f"probability {self.prob} in {text!r} not in [0,1]"
                    )
                continue
            if key == "seed":
                seed = int(value)
            elif key == "times":
                self.times = int(value)
            elif key == "after":
                self.after = int(value)
            elif key == "secs":
                self.secs = float(value)
            elif key == "code":
                self.code = int(value)
            elif key == "nbytes":
                self.nbytes = int(value)
            elif key == "p":
                self.prob = float(value)
            else:
                self.match[key] = value
        self._rng = random.Random(seed)
        self.calls = 0
        self.fires = 0

    def matches_point(self, point: str) -> bool:
        return point == self.point or point.startswith(self.point + ".")

    def consider(self, point: str, ctx: Dict[str, object]) -> bool:
        """Does this rule fire for this call? Mutates call/fire counts
        (caller holds the module lock)."""
        if not self.matches_point(point):
            return False
        for key, want in self.match.items():
            if key not in ctx or str(ctx[key]) != want:
                return False
        self.calls += 1
        if self.calls <= self.after:
            return False
        if self.times is not None and self.fires >= self.times:
            return False
        if self.prob < 1.0 and self._rng.random() >= self.prob:
            return False
        self.fires += 1
        return True


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def enabled() -> bool:
    return _enabled


def configure(spec: Optional[str] = None) -> None:
    """Compile a fault spec (default: the ``HOROVOD_TPU_FAULT_SPEC`` /
    ``HVD_TPU_FAULT_SPEC`` / ``HOROVOD_FAULT_SPEC`` env) and enable
    injection. An empty/absent spec disables."""
    global _enabled, _rules
    if spec is None:
        spec = (
            os.environ.get(ENV_SPEC, "")
            or os.environ.get("HVD_TPU_FAULT_SPEC", "")
            or os.environ.get("HOROVOD_FAULT_SPEC", "")
        )
    rules = []
    for chunk in spec.replace(",", ";").split(";"):
        chunk = chunk.strip()
        if chunk:
            rules.append(_Rule(chunk))
    with _lock:
        _rules = rules
        _enabled = bool(rules)


def reset() -> None:
    """Disable injection and drop all rules (test hook)."""
    global _enabled, _rules
    with _lock:
        _rules = []
        _enabled = False


def rules() -> List[str]:
    """The active rule texts, for diagnostics."""
    with _lock:
        return [r.text for r in _rules]


def _fired_rules(point: str, ctx: Dict[str, object]) -> List[_Rule]:
    fired: List[_Rule] = []
    with _lock:
        for rule in _rules:
            if rule.consider(point, ctx):
                fired.append(rule)
    return fired


def _flip_bytes(data: bytes, rule: _Rule) -> bytes:
    """XOR-flip ``rule.nbytes`` bytes of ``data`` at positions drawn
    from the rule's seeded rng: the same damage every run."""
    if not data:
        return data
    buf = bytearray(data)
    for _ in range(max(1, min(len(buf), rule.nbytes))):
        buf[rule._rng.randrange(len(buf))] ^= 0xFF
    return bytes(buf)


def _run_actions(fired: List[_Rule], point: str,
                 data: Optional[bytes] = None,
                 ) -> Tuple[Optional[str], Optional[bytes]]:
    """Execute fired rules' actions. Every fired rule is recorded and
    its non-raising action executed BEFORE any error rule raises:
    consider() already spent the rules' times/probability budget, so a
    raise must not swallow a co-fired delay/flap/kill/corrupt or its
    accounting. Returns the last cooperative action's name and the
    (possibly damaged) payload."""
    coop: Optional[str] = None
    error_rule: Optional[_Rule] = None
    for rule in fired:
        _metrics.record_fault(point, rule.action)
        if rule.action == "delay":
            _sleep(rule.secs)
        elif rule.action == "error":
            error_rule = error_rule or rule
        elif rule.action == "corrupt" and data is not None:
            data = _flip_bytes(data, rule)
        elif rule.action != "kill":
            coop = rule.action
    for rule in fired:
        if rule.action == "kill":
            _exit(rule.code)
    if error_rule is not None:
        raise InjectedFault(
            f"injected fault at {point}"
            + (f" [{error_rule.text}]" if error_rule.text else "")
        )
    return coop, data


def inject(point: str, **ctx) -> Optional[str]:
    """Fire any matching rules at a named injection point.

    Raising actions raise (``error`` → :class:`InjectedFault`); the
    ``kill`` action exits the process; ``delay`` sleeps inline.
    Cooperative actions (``flap``, ``corrupt``) are returned by name
    for the call site to implement. Returns None when
    nothing cooperative fired — including always when injection is
    disabled (the fast path).
    """
    if not _enabled:
        return None
    coop, _ = _run_actions(_fired_rules(point, ctx), point)
    return coop


def corrupt(point: str, data: bytes, **ctx) -> bytes:
    """Pass a serialized payload through the corruption gate at a named
    point. A matching ``corrupt`` rule flips ``nbytes`` bytes of it;
    co-fired error/delay/kill rules act as in :func:`inject`. Returns
    ``data`` itself when injection is off or no rule fires."""
    if not _enabled:
        return data
    _, out = _run_actions(_fired_rules(point, ctx), point, data)
    return out if out is not None else data


# Worker processes are spawned by the launcher with the spec in their
# env and never necessarily call init(), so arm at import. Never let a
# malformed spec break the import — a spec typo surfaces loudly the
# first time someone configures explicitly.
try:
    configure()
except FaultSpecError as _e:
    import logging

    logging.getLogger("horovod_tpu_torch.faults").warning(
        "ignoring malformed %s: %s", ENV_SPEC, _e
    )
