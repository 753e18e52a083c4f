"""Closed-loop autotuning of the data plane, scored by what is measured.

The port of the JAX package's ``ops/autotune.py`` (reference:
``horovod/common/parameter_manager.{cc,h}``, a Bayesian search over the
runtime knobs scored by achieved bytes/sec and broadcast from the
coordinator). Three tuners share the module:

* :class:`ParameterManager` — the in-step observer: the
  DistributedOptimizer's ``synchronize()`` (and a staged step's record)
  reports each executed step's bucket bytes, and after a warm-up it
  walks the fusion thresholds, scores each by bytes/sec and pins the
  best. The port plans an optimizer's buckets when it is built, so a
  threshold it pins applies to the optimizers built after it (the JAX
  package's: to the steps compiled after it);
* :class:`SPMDStepTuner` — the compile-and-measure backend: the user
  hands it a step *factory*, and it coordinate-descends over the knobs
  that change the step's collective structure, building and timing each
  candidate on the real arguments and pinning the winners into the
  knobs;
* :class:`OnlineTuner` — the closed-loop front end (``hvd.autotune.
  OnlineTuner``) over every knob of the data plane ({fusion threshold,
  ordered buckets, overlap schedule, hierarchical local size, FSDP
  prefetch depth} plus — opt-in, numerics-changing — wire dtype/block
  and fast-path warmup), which agrees each dimension's argmin through
  rank 0's ``broadcast_object``, persists winners to an on-disk cache
  keyed by (model fingerprint, topology) so later runs and serving
  replicas warm-start with zero tuning builds, and leaves a decision
  trail (``hvd_autotune_*`` series, flight-recorder pin/reject events,
  ``autotune`` event lines in the StepStats JSONL, which
  ``tools.metrics_summary`` renders).

The cache file's format, the cache key's text, the trial rows, the CSV
log and the pin/reject order are the JAX package's, so a cache file
written by either package reads in the other. Three things differ, each
because a port rank is a process of its own (ROADMAP queue C):

* a candidate's step returns before the card has finished it (and an
  NCCL reduction runs on its own stream), so each timed iteration waits
  with ``torch.cuda.synchronize`` on the devices of the step's CUDA
  outputs, where the JAX tuner blocks on its output arrays;
* the agreement broadcasts over the world whenever it has more than one
  rank (the JAX package's only across controllers, ``cross_size() >
  1``), and rank 0 alone writes the cache (the JAX package's
  ``cross_rank() == 0``);
* :func:`topology_key` counts the world's ranks and ``cross_size() - 1``
  DCN hops.

The port's ``model_fingerprint`` never equals the JAX package's (it
does not hash JAX's treedef), so a cache entry keyed by a fingerprint
is found only by the package that computed it.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, List, Optional

import torch

from ..core.knobs import Knobs

_CANDIDATE_THRESHOLDS = [
    1 << 20, 2 << 20, 4 << 20, 8 << 20, 16 << 20,
    32 << 20, 64 << 20, 128 << 20, 256 << 20,
]

#: bump when the tunable-knob vocabulary changes meaning or shape: a
#: cached winner from another schema generation must re-tune loudly,
#: never be silently reused
KNOB_SCHEMA_VERSION = 2

#: every knob any OnlineTuner dimension may pin — the schema the cache
#: staleness check validates entries against
TUNABLE_KNOBS = (
    "fusion_threshold_bytes",
    "ordered_buckets",
    "overlap_schedule",
    "hierarchical_allreduce",
    "hierarchical_local_size",
    "fsdp_prefetch",
    "fused_collectives",
    "compression",
    "compression_block",
    "eager_fast_path_warmup",
)

#: the opt-in group: pinning these changes NUMERICS (int8 is lossy) or
#: steady-state negotiation semantics; a consumer that did not opt in
#: (tune_wire / HOROVOD_AUTOTUNE_WIRE) never has them pinned from a
#: cache entry that tuned them
NUMERICS_KNOBS = ("compression", "compression_block",
                  "eager_fast_path_warmup")

#: stable enumerations for string-valued knobs so the
#: hvd_autotune_dimension gauge can carry them as numbers
_ENUM_VALUES = {
    "overlap_schedule": ("off", "stage", "double"),
    "compression": ("none", "fp16", "bf16", "int8", "int8-raw"),
}


def _numeric(key: str, value) -> float:
    if isinstance(value, bool):
        return 1.0 if value else 0.0
    if isinstance(value, str):
        enum = _ENUM_VALUES.get(key, ())
        return float(enum.index(value)) if value in enum else -1.0
    try:
        return float(value)
    except (TypeError, ValueError):
        return -1.0


def _block_until_ready(out) -> None:
    """Wait until the card has finished the work behind ``out`` (any
    nest of tensors): ``torch.cuda.synchronize`` on the device of each
    CUDA tensor in it, which also waits for the collectives' own
    streams. A CPU tensor has nothing pending."""
    from torch.utils import _pytree as pytree

    devices = {t.device for t in pytree.tree_leaves(out)
               if isinstance(t, torch.Tensor) and t.is_cuda}
    for d in sorted(devices, key=str):
        torch.cuda.synchronize(d)


# ---------------------------------------------------------------------------
# cache key: (model fingerprint, topology)
# ---------------------------------------------------------------------------

def topology_key() -> dict:
    """The topology half of the warm-start cache key: the world's ranks,
    the mesh's axes and the DCN hop count (``cross_size() - 1``: the
    hierarchical router's outer-leg depth). Resolved best-effort, so an
    uninitialized process (a serving replica) still gets a stable key:
    a world of one, no axes, no hops."""
    from ..core.state import global_state

    st = global_state()
    world, hosts, axes = 1, 1, {}
    if st.initialized:
        world, hosts = st.size, st.cross_size
        if st.mesh is not None:
            axes = {str(a): int(s) for a, s in
                    zip(st.mesh.axis_names, st.mesh.shape)}
    return {"world": int(world), "mesh_axes": axes,
            "dcn_hops": max(int(hosts) - 1, 0)}


def cache_key(fingerprint: str, topology: Optional[dict] = None) -> str:
    topo = topology if topology is not None else topology_key()
    axes = ",".join(f"{a}={s}" for a, s in sorted(topo["mesh_axes"].items()))
    return (f"{fingerprint}|w{topo['world']}|{axes or 'flat'}"
            f"|dcn{topo['dcn_hops']}")


class TuneCache:
    """On-disk winner store (``HOROVOD_AUTOTUNE_CACHE``): one JSON file,
    entries keyed by :func:`cache_key`, written atomically
    (tmp + ``os.replace``) so concurrent ranks/runs never observe a torn
    file. Entries carry the knob-schema version and the tuned knob list;
    :meth:`lookup` treats any mismatch as STALE — it warns, records a
    flight event, and misses, so a stale winner is re-tuned loudly
    rather than silently reused."""

    def __init__(self, path: str):
        self.path = path

    def _load(self) -> dict:
        try:
            with open(self.path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return {}
        if not isinstance(data, dict):
            return {}
        entries = data.get("entries")
        return entries if isinstance(entries, dict) else {}

    def _stale(self, key: str, entry, reason: str) -> None:
        from ..utils import flight as _flight
        from ..utils.logging import get_logger

        get_logger().warning(
            "autotune cache entry for %s is STALE (%s) — re-tuning "
            "instead of reusing it (%s)", key, reason, self.path)
        _flight.record("autotune", "cache_stale", key=key, reason=reason)

    def _validate(self, key: str, entry) -> Optional[dict]:
        if not isinstance(entry, dict) or "config" not in entry:
            self._stale(key, entry, "malformed entry")
            return None
        if entry.get("schema") != KNOB_SCHEMA_VERSION:
            self._stale(
                key, entry,
                f"knob schema {entry.get('schema')!r} != "
                f"{KNOB_SCHEMA_VERSION}")
            return None
        unknown = [k for k in entry["config"] if k not in TUNABLE_KNOBS]
        if unknown:
            self._stale(key, entry, f"unknown tuned knobs {unknown}")
            return None
        return entry

    def lookup(self, key: str) -> Optional[dict]:
        entry = self._load().get(key)
        if entry is None:
            return None
        return self._validate(key, entry)

    def lookup_fingerprint(self, fingerprint: str) -> Optional[dict]:
        """Best matching entry for a model regardless of topology — the
        serving-replica path: an inference tier rarely shares the
        training world's shape, but the model-level winners (fusion
        threshold, wire — with opt-in) still transfer. Exact-topology
        entries win; otherwise the newest entry for the fingerprint."""
        entries = self._load()
        hits = [(k, e) for k, e in entries.items()
                if k.split("|", 1)[0] == fingerprint]
        if not hits:
            return None
        hits.sort(key=lambda kv: kv[1].get("time_unix", 0)
                  if isinstance(kv[1], dict) else 0)
        key, entry = hits[-1]
        return self._validate(key, entry)

    def store(self, key: str, entry: dict) -> None:
        entries = self._load()
        entries[key] = entry
        payload = {"hvd_autotune_cache": 1,
                   "schema": KNOB_SCHEMA_VERSION,
                   "entries": entries}
        tmp = self.path + ".tmp"
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, self.path)


class ParameterManager:
    """Score-and-advance tuner (reference: parameter_manager.h:42).

    The DistributedOptimizer's ``synchronize()`` calls
    ``observe(bucket_bytes)`` once a step; after warmup the manager
    cycles candidates, keeps the best-throughput setting, then pins it.
    """

    def __init__(self, knobs: Knobs):
        self._knobs = knobs
        self._active = knobs.autotune
        self._candidates: List[int] = list(_CANDIDATE_THRESHOLDS)
        self._idx = self._candidates.index(
            min(
                self._candidates,
                key=lambda c: abs(c - knobs.fusion_threshold_bytes),
            )
        )
        self._current = self._candidates[self._idx]
        self._best = (0.0, self._current)  # (bytes/sec, threshold)
        self._warmup_left = knobs.autotune_warmup_samples
        self._steps_in_sample = 0
        self._bytes_in_sample = 0
        self._sample_start = time.perf_counter()
        self._pinned = False
        # drop the first sample window after a threshold switch: the
        # switch rebuilds the bucket plan, and that one-off cost would
        # pollute the candidate's bytes/sec score (a big candidate could
        # lose purely on its switch)
        self._skip_window = False
        self._log_rows: List[tuple] = []

    def fusion_threshold_bytes(self) -> int:
        return self._current

    def record_bytes(self, n: int) -> None:
        self._bytes_in_sample += int(n)

    def observe(self, nbytes: int) -> None:
        """One executed training step moved `nbytes` of gradient buckets
        (``DistributedOptimizer.synchronize``, a staged step's record)."""
        self.record_bytes(nbytes)
        self.tick()

    def tick(self) -> None:
        if not self._active or self._pinned:
            return
        self._steps_in_sample += 1
        if self._steps_in_sample < self._knobs.autotune_steps_per_sample:
            return
        if self._skip_window:
            # first full window at a freshly-switched threshold: its
            # one-off cost is in this window's wall clock, so scoring it
            # would bias against the new candidate — reset the
            # accumulators and score the NEXT window
            self._skip_window = False
            self._steps_in_sample = 0
            self._bytes_in_sample = 0
            self._sample_start = time.perf_counter()
            return
        elapsed = max(time.perf_counter() - self._sample_start, 1e-9)
        score = self._bytes_in_sample / elapsed
        if self._warmup_left > 0:
            self._warmup_left -= 1
        else:
            self._log_rows.append((self._current, score))
            if score > self._best[0]:
                self._best = (score, self._current)
            self._idx += 1
            if self._idx >= len(self._candidates):
                self._current = self._best[1]
                self._pinned = True
                self._write_log()
            else:
                self._current = self._candidates[self._idx]
                self._skip_window = True
        self._steps_in_sample = 0
        self._bytes_in_sample = 0
        self._sample_start = time.perf_counter()

    def _write_log(self) -> None:
        if not self._knobs.autotune_log:
            return
        with open(self._knobs.autotune_log, "w") as f:
            f.write("fusion_threshold_bytes,score_bytes_per_sec\n")
            for thr, score in self._log_rows:
                f.write(f"{thr},{score}\n")
            f.write(f"# pinned,{self._current}\n")


class SPMDStepTuner:
    """Build-and-measure backend. The port plans a step's buckets when
    its optimizer is built, so a knob that changes the collective
    structure (bucket size, ordered issue, the wire) takes effect only
    in a step built after it is set: tuning is rebuilding. The user
    hands this tuner a step *factory*, and it coordinate-descends over
    those knobs, building and timing each candidate and pinning the
    winners into the knobs:

      * ``fusion_threshold_bytes`` — bucket size (launch latency vs
        overlap window);
      * ``ordered_buckets`` — each bucket issued from the backward's
        hooks as it completes vs every bucket issued after the backward
        (``optim/distributed.py``);
      * optionally ``hierarchical_allreduce`` × ``hierarchical_local_size``
        — the two-level route (``ops/hierarchical.py``);
      * optionally ``compression`` — the wire dtype (none/bf16/int8).
        Numerics-changing (int8 is lossy), so ``tune_wire`` is opt-in
        and the factory must rebuild the optimizer and its state per
        candidate.

    :class:`OnlineTuner` extends the dimension set to the whole knob
    space and adds the persistent warm-start cache — prefer it for new
    code; this class remains the measurement engine both share.

    Coordinate descent visits O(sum of dims) candidates, not the
    product — the same economy the reference's ParameterManager buys
    with Bayesian search over its knob space.

    Scoring: each candidate's measured iterations run inside
    ``hvd.metrics.step()`` (so StepStats records them and the sampled
    profiler's MFU accounting rides along), each waited for on the card
    before the clock is read again; the candidate's score is the
    step-time **p50** over the measured iterations, and when the
    profiler is live (``hvd.prof.set_step_flops`` declared the model
    cost) the trial also records the measured ``hvd_mfu``.

    A candidate that FAILS to build or run (out of memory on an
    aggressive threshold, a launch error) is recorded as an
    ``{"error": ...}`` trial row, scores ``inf``, and the sweep
    continues — every rank still walks the same candidate list in the
    same order, so the rank-0 agreement stays in sync even when the
    failure is rank-local.

    Usage::

        def build_step(overrides):
            # knobs already carry `overrides` when this is called:
            # build the optimizer (and what plans its buckets) anew
            model, step = hvd.make_lm_train_step(cfg, factory)
            return lambda: step(tokens)

        tuner = hvd.SPMDStepTuner(tune_hierarchical=False)
        winners = tuner.tune(build_step)

    The factory is invoked once per candidate; each returned step is
    timed post-warmup on ``args``. Winners persist in
    ``global_state().knobs`` so later builds inherit them.
    """

    def __init__(
        self,
        knobs: Optional[Knobs] = None,
        thresholds: Optional[List[int]] = None,
        warmup: int = 2,
        measure: int = 8,
        tune_ordered: bool = True,
        tune_hierarchical: bool = False,
        hier_blocks: Optional[List[int]] = None,
        tune_wire: bool = False,
        wire_candidates: Optional[List[str]] = None,
        log_path: str = "",
        agree_fn: Optional[Callable] = None,
        clock: Optional[Callable[[], float]] = None,
    ):
        if knobs is None:
            from ..core.state import global_state

            knobs = global_state().knobs
        self._knobs = knobs
        self._thresholds = list(thresholds) if thresholds else [
            4 << 20, 16 << 20, 64 << 20, 128 << 20, 256 << 20,
        ]
        # seed the sweep with the incumbent so tuning can never pin a
        # setting slower than what the user already had
        if knobs.fusion_threshold_bytes not in self._thresholds:
            self._thresholds.insert(0, knobs.fusion_threshold_bytes)
        self._warmup = max(int(warmup), 0)
        self._measure = max(int(measure), 1)
        self._tune_ordered = tune_ordered
        self._tune_hier = tune_hierarchical
        self._hier_blocks = list(hier_blocks) if hier_blocks else [0]
        # wire-dtype dimension: candidates are HOROVOD_COMPRESSION
        # values; the winner pins knobs.compression so later builds
        # inherit it. OFF by default — unlike the other dimensions this
        # one changes NUMERICS (int8 is lossy) and the factory must
        # rebuild optimizer + state per candidate (an error-feedback
        # compressor adds a residual). Opt in with tune_wire=True.
        self._tune_wire = tune_wire
        self._wire_candidates = (
            list(wire_candidates) if wire_candidates
            else ["none", "bf16", "int8"])
        # distinct default path from ParameterManager's (both write mode
        # "w"; sharing knobs.autotune_log would clobber whichever
        # finishes first)
        self._log_path = log_path or (
            knobs.autotune_log + ".spmd" if knobs.autotune_log else "")
        # injectable for tests/checks: `clock` lets a harness skew one
        # rank's timings to prove agreement; `agree_fn` replaces the
        # broadcast_object round trip with a loopback channel
        self._agree_fn = agree_fn
        self._clock = clock or time.perf_counter
        self.trials: List[dict] = []
        #: successful build_step invocations — a warm-started rerun
        #: must show 0
        self.compiles = 0
        # the dimension currently being swept, carried as instance
        # state (not a _time_candidate parameter) so subclasses that
        # wrap _time_candidate with the 3-argument signature keep
        # working
        self._dimension = ""

    # -- knob plumbing -------------------------------------------------
    def _apply(self, overrides: dict) -> dict:
        saved = {k: getattr(self._knobs, k) for k in overrides}
        for k, v in overrides.items():
            setattr(self._knobs, k, v)
        return saved

    def _time_candidate(self, build_step, args, overrides: dict) -> float:
        """Build + measure one candidate; p50 step seconds, or ``inf``
        for a failed candidate (the knobs are restored and the trial is
        still logged either way — a rank-local failure must not desync
        the per-dimension agreement)."""
        from ..utils import metrics as _metrics
        from ..utils import prof as _prof

        dimension = self._dimension
        saved = self._apply(overrides)
        mfu_live = (_prof.active() and _prof.step_flops() > 0
                    and getattr(self._knobs, "autotune_mfu", True))
        try:
            step = build_step(dict(overrides))
            self.compiles += 1
            out = None
            for _ in range(self._warmup):
                out = step(*args)
            if out is not None:
                _block_until_ready(out)
            times: List[float] = []
            mfus: List[float] = []
            for _ in range(self._measure):
                with _metrics.step():
                    t0 = self._clock()
                    out = step(*args)
                    _block_until_ready(out)
                    times.append(self._clock() - t0)
                if mfu_live and _prof.last_mfu() is not None:
                    mfus.append(_prof.last_mfu())
        except Exception as e:
            # the failure is a trial row and the dimension goes on: a
            # raise here would stop this rank's sweep while the others
            # walk on toward the agreement broadcast
            trial = {**overrides, "error": repr(e)}
            if dimension:
                trial["dimension"] = dimension
            self.trials.append(trial)
            _metrics.record_autotune_trial(
                dimension or "candidate", None, error=repr(e),
                overrides=overrides)
            return float("inf")
        finally:
            self._apply(saved)
        times.sort()
        dt = times[len(times) // 2]  # p50 over measured iterations
        trial = {**overrides, "step_s": dt}
        if dimension:
            trial["dimension"] = dimension
        mfu = None
        if mfus:
            mfus.sort()
            mfu = mfus[len(mfus) // 2]
            trial["mfu"] = mfu
        self.trials.append(trial)
        _metrics.record_autotune_trial(
            dimension or "candidate", dt, mfu=mfu, overrides=overrides)
        return dt

    def _agree(self, best, best_t):
        """Agreement after EVERY dimension: each rank measured the
        candidates on its own noisy clock, and a divergent pick would
        make the NEXT dimension's candidates build rank-mismatched
        collective structures (a hang inside _time_candidate). Within a
        dimension every rank times the same candidate list in the same
        order, so only the argmin needs agreeing. Rank 0's pick wins, as
        the reference broadcasts ParameterManager winners from the
        coordinator. `best_t` ships WITH the dict: the next dimension's
        accept/reject compares against the root's baseline for the
        root's winner. Every port rank is a process of its own, so the
        round trip runs in any world of more than one rank (the JAX
        package's only across controllers). An ``agree_fn`` injected at
        construction replaces the broadcast (loopback tests/checks)."""
        if self._agree_fn is not None:
            return self._agree_fn(best, best_t)
        from ..core.basics import is_initialized, size

        if is_initialized() and size() > 1:
            from ..optim.functions import broadcast_object

            best, best_t = broadcast_object(
                (best, best_t), root_rank=0)
        return best, best_t

    # -- search --------------------------------------------------------
    def tune(self, build_step, *args) -> dict:
        """Coordinate descent; returns the winning overrides (already
        pinned into the knobs)."""
        best = {
            "fusion_threshold_bytes": self._knobs.fusion_threshold_bytes,
            "ordered_buckets": self._knobs.ordered_buckets,
        }
        if self._tune_hier:
            best["hierarchical_allreduce"] = (
                self._knobs.hierarchical_allreduce)
            best["hierarchical_local_size"] = (
                self._knobs.hierarchical_local_size)
        if self._tune_wire:
            best["compression"] = self._knobs.compression

        def score(ov, dim):
            self._dimension = dim
            return self._time_candidate(build_step, args, {**best, **ov})

        # dim 1: bucket size
        timed = {t: score({"fusion_threshold_bytes": t},
                          "fusion_threshold_bytes")
                 for t in self._thresholds}
        best["fusion_threshold_bytes"] = min(timed, key=timed.get)
        best_t = timed[best["fusion_threshold_bytes"]]
        best, best_t = self._agree(best, best_t)

        # dim 2: ordered issue on/off
        if self._tune_ordered:
            flipped = not best["ordered_buckets"]
            t = score({"ordered_buckets": flipped}, "ordered_buckets")
            if t < best_t:
                best["ordered_buckets"], best_t = flipped, t
            best, best_t = self._agree(best, best_t)

        # dim 3: hierarchical routing
        if self._tune_hier:
            for blk in self._hier_blocks:
                t = score({"hierarchical_allreduce": True,
                           "hierarchical_local_size": blk},
                          "hierarchical")
                if t < best_t:
                    best_t = t
                    best["hierarchical_allreduce"] = True
                    best["hierarchical_local_size"] = blk
            best, best_t = self._agree(best, best_t)

        # dim 4: wire dtype (none/bf16/int8) — each candidate rebuilds
        # through the factory, so the optimizer resolves the knob and
        # builds the candidate's wire; the argmin is agreed through the
        # same rank-0 broadcast as the others
        if self._tune_wire:
            for w in self._wire_candidates:
                if w == best.get("compression"):
                    continue  # the incumbent was already timed
                t = score({"compression": w}, "compression")
                if t < best_t:
                    best_t = t
                    best["compression"] = w
            best, best_t = self._agree(best, best_t)

        self._apply(best)  # pin winners
        self._write_log(best, best_t)
        return best

    def _write_log(self, best: dict, best_t: float) -> None:
        if not self._log_path:
            return
        keys = sorted({k for row in self.trials for k in row})
        with open(self._log_path, "w") as f:
            f.write(",".join(keys) + "\n")
            for row in self.trials:
                f.write(",".join(str(row.get(k, "")) for k in keys) + "\n")
            f.write(f"# pinned,{best},step_s={best_t:.6f}\n")


class OnlineTuner(SPMDStepTuner):
    """Closed-loop tuner over the whole data-plane knob space, with a
    persistent per-(model, topology) warm start
    (``hvd.autotune.OnlineTuner``).

    Dimensions (coordinate descent, each argmin agreed rank-0-wins):

    1. ``fusion_threshold_bytes`` — candidate bucket sizes, incumbent
       seeded first (the never-worse guarantee: tuning can only move
       off the user's setting for something measured faster);
    2. ``ordered_buckets`` — the issue-order flip;
    3. ``overlap_schedule`` — off / stage / double (``ops/overlap.py``;
       the port's replicated optimizers issue from their hooks in every
       mode, so on that path the candidates time one program: ROADMAP
       queue C);
    4. hierarchical routing (``tune_hierarchical=True``) —
       ``hierarchical_allreduce`` × ``hierarchical_local_size``;
    5. ``fsdp_prefetch`` (``tune_fsdp_prefetch=True``) — forward
       all-gather look-ahead depth;
    6. ``fused_collectives`` (``tune_fused_collectives=True``) — the JAX
       package's Pallas/XLA backend switch, bitwise-identical, which
       chooses nothing in the port (the device chooses the kernel), so
       its flip times one program too;
    7. opt-in, NUMERICS-CHANGING (``tune_wire=True`` /
       ``HOROVOD_AUTOTUNE_WIRE``): wire dtype (``compression``),
       quantization block (``compression_block``), and eager fast-path
       warmup K (``eager_fast_path_warmup``). The factory must rebuild
       optimizer + state per candidate on this group.

    A candidate that fails to build/run scores ``inf`` and the sweep
    continues (the error lands in the trial log and the decision
    trail). Winners are pinned into the live knobs, logged, and — when
    a cache path is configured (``HOROVOD_AUTOTUNE_CACHE``) — persisted
    under :func:`cache_key` (model fingerprint from
    ``ops.fusion.model_fingerprint`` + :func:`topology_key`). A later
    ``tune()`` against the same key pins the cached configuration with
    ZERO tuning builds; a schema-version or fingerprint mismatch
    re-tunes loudly instead of silently reusing.
    """

    def __init__(
        self,
        knobs: Optional[Knobs] = None,
        *,
        thresholds: Optional[List[int]] = None,
        warmup: int = 2,
        measure: int = 8,
        tune_ordered: bool = True,
        tune_overlap: bool = True,
        overlap_modes: Optional[List[str]] = None,
        tune_hierarchical: bool = False,
        hier_blocks: Optional[List[int]] = None,
        tune_fsdp_prefetch: bool = False,
        prefetch_depths: Optional[List[int]] = None,
        tune_fused_collectives: bool = False,
        tune_wire: Optional[bool] = None,
        wire_candidates: Optional[List[str]] = None,
        block_candidates: Optional[List[int]] = None,
        warmup_k_candidates: Optional[List[int]] = None,
        cache_path: Optional[str] = None,
        fingerprint: Optional[str] = None,
        log_path: str = "",
        agree_fn: Optional[Callable] = None,
        clock: Optional[Callable[[], float]] = None,
    ):
        if knobs is None:
            from ..core.state import global_state

            knobs = global_state().knobs
        if tune_wire is None:
            tune_wire = bool(getattr(knobs, "autotune_wire", False))
        super().__init__(
            knobs, thresholds=thresholds, warmup=warmup, measure=measure,
            tune_ordered=tune_ordered,
            tune_hierarchical=tune_hierarchical, hier_blocks=hier_blocks,
            tune_wire=tune_wire, wire_candidates=wire_candidates,
            log_path=log_path, agree_fn=agree_fn, clock=clock)
        self._tune_overlap = tune_overlap
        self._overlap_modes = (list(overlap_modes) if overlap_modes
                               else ["off", "stage", "double"])
        self._tune_fsdp = tune_fsdp_prefetch
        self._prefetch_depths = (list(prefetch_depths) if prefetch_depths
                                 else [0, 1, 2])
        self._tune_fused = tune_fused_collectives
        self._block_candidates = (list(block_candidates)
                                  if block_candidates else [128, 256, 512])
        self._warmup_ks = (list(warmup_k_candidates)
                           if warmup_k_candidates else [1, 3, 8])
        path = (cache_path if cache_path is not None
                else getattr(knobs, "autotune_cache", "") or "")
        self._cache = TuneCache(path) if path else None
        self._fingerprint = fingerprint
        #: the agreed, pinned configuration after tune(); None before
        self.pinned: Optional[dict] = None
        #: "sweep" or "cache" after tune()
        self.pin_source: Optional[str] = None

    # -- dimension plan ------------------------------------------------

    def tuned_knobs(self) -> List[str]:
        keys = ["fusion_threshold_bytes"]
        if self._tune_ordered:
            keys.append("ordered_buckets")
        if self._tune_overlap:
            keys.append("overlap_schedule")
        if self._tune_hier:
            keys += ["hierarchical_allreduce", "hierarchical_local_size"]
        if self._tune_fsdp:
            keys.append("fsdp_prefetch")
        if self._tune_fused:
            keys.append("fused_collectives")
        if self._tune_wire:
            keys += ["compression", "compression_block",
                     "eager_fast_path_warmup"]
        return keys

    def _dimension_candidates(self, best: dict):
        """Yield (dimension name, candidate override dicts) lazily, so
        each dimension's candidate set reflects the winners already
        pinned by earlier dimensions (``best`` mutates in place)."""
        yield ("fusion_threshold_bytes",
               [{"fusion_threshold_bytes": t} for t in self._thresholds])
        if self._tune_ordered:
            yield ("ordered_buckets",
                   [{"ordered_buckets": not best["ordered_buckets"]}])
        if self._tune_overlap:
            yield ("overlap_schedule",
                   [{"overlap_schedule": m} for m in self._overlap_modes
                    if m != best["overlap_schedule"]])
        if self._tune_hier:
            yield ("hierarchical",
                   [{"hierarchical_allreduce": True,
                     "hierarchical_local_size": b}
                    for b in self._hier_blocks])
        if self._tune_fsdp:
            yield ("fsdp_prefetch",
                   [{"fsdp_prefetch": d} for d in self._prefetch_depths
                    if d != best["fsdp_prefetch"]])
        if self._tune_fused:
            # bitwise-equal backends, so the single flip candidate is a
            # pure latency race against the incumbent
            yield ("fused_collectives",
                   [{"fused_collectives": not best["fused_collectives"]}])
        if self._tune_wire:
            yield ("compression",
                   [{"compression": w} for w in self._wire_candidates
                    if w != best["compression"]])
            # the quantization block only exists on a block-quantized
            # wire: sweeping it after the compression dimension pinned
            # "none"/a cast wire would burn builds timing a dead knob
            # and let noise pin an arbitrary block into the cache
            # (`best` is read lazily, AFTER the compression dimension's
            # agreement)
            if best["compression"] in ("int8", "int8-raw"):
                yield ("compression_block",
                       [{"compression_block": b}
                        for b in self._block_candidates
                        if b != best["compression_block"]])
            yield ("eager_fast_path_warmup",
                   [{"eager_fast_path_warmup": k} for k in self._warmup_ks
                    if k != best["eager_fast_path_warmup"]])

    # -- cache plumbing ------------------------------------------------

    def _consumable(self, config: dict) -> dict:
        """Filter a cached configuration down to what this consumer may
        pin: the numerics-changing group only transfers under the
        explicit opt-in."""
        if self._tune_wire:
            return dict(config)
        dropped = {k: v for k, v in config.items()
                   if k in NUMERICS_KNOBS
                   and v != getattr(self._knobs, k, v)}
        if dropped:
            from ..utils.logging import get_logger

            get_logger().info(
                "autotune cache: dropping numerics-changing winners %s "
                "(tune_wire / HOROVOD_AUTOTUNE_WIRE not opted in)",
                dropped)
        return {k: v for k, v in config.items()
                if k not in NUMERICS_KNOBS}

    def _resolve_fingerprint(self) -> Optional[str]:
        """The warm-start cache requires an EXPLICIT model fingerprint
        (constructor or tune() kwarg, from ops.fusion.model_fingerprint
        on the parameters). Deriving one from the timing args would key
        the cache on the data batch's shape — two different models fed
        same-shaped batches would then share winners. No fingerprint →
        no caching."""
        return self._fingerprint or None

    def _emit_pin(self, dimension: str, best: dict, best_t: float,
                  improved: bool, source: str = "sweep") -> None:
        from ..utils import flight as _flight
        from ..utils import metrics as _metrics

        kind = "pin" if improved else "reject"
        # None, not inf, when no candidate measured successfully: the
        # flight dump and the JSONL event line are json.dumps output,
        # and a bare Infinity token is not RFC-8259 JSON
        step_s = (best_t if best_t == best_t
                  and best_t not in (float("inf"), float("-inf"))
                  else None)
        detail = {k: best[k] for k in best}
        _flight.record("autotune", kind, dimension=dimension,
                       step_s=step_s, source=source, **detail)
        _metrics.record_autotune_pin(dimension, best, step_s,
                                     accepted=improved, source=source)

    # -- search --------------------------------------------------------

    def tune(self, build_step, *args, fingerprint: Optional[str] = None
             ) -> dict:
        """Warm-start from the cache when the (model, topology) key
        hits; otherwise coordinate-descend every enabled dimension,
        agree each argmin, pin + persist the winners. Returns the
        pinned configuration."""
        knobs = self._knobs
        tuned = self.tuned_knobs()
        best = {k: getattr(knobs, k) for k in tuned}
        fp = fingerprint or self._resolve_fingerprint()
        key = cache_key(fp) if fp else None

        # -- warm start: the cache decision is itself agreed (rank 0's
        # view of the file wins), so a rank with a cold cache file can
        # never start sweeping while its peers pin and return
        entry = None
        if key and self._cache is not None:
            entry = self._cache.lookup(key)
        if self._cache is not None:
            entry, _ = self._agree(entry, 0.0)
        if entry is not None:
            config = self._consumable(entry["config"])
            config = {k: v for k, v in config.items()
                      if k in TUNABLE_KNOBS}
            self._apply(config)
            self.pinned = dict(config)
            self.pin_source = "cache"
            self._emit_pin("warm_start", config,
                           float(entry.get("step_s") or 0.0),
                           improved=True, source="cache")
            return dict(config)

        best_t = float("inf")
        for dim, candidates in self._dimension_candidates(best):
            if not candidates:
                continue
            dim_keys = set().union(*(ov.keys() for ov in candidates))
            incumbent = {k: best[k] for k in dim_keys}
            self._dimension = dim
            for ov in candidates:
                t = self._time_candidate(build_step, args,
                                         {**best, **ov})
                if t < best_t:
                    best_t = t
                    best.update(ov)
            best, best_t = self._agree(best, best_t)
            # pin vs reject from the AGREED outcome, not this rank's
            # local accept loop: under skewed clocks a non-root rank's
            # local pick is overwritten by rank 0's, and the decision
            # trail must describe the config it actually carries
            improved = any(best[k] != incumbent[k] for k in dim_keys)
            self._emit_pin(dim, best, best_t, improved)

        self._apply(best)
        self.pinned = dict(best)
        self.pin_source = "sweep"
        self._write_log(best, best_t)
        self._emit_pin("final", best, best_t, improved=True)

        if key and self._cache is not None and self._is_writer():
            mfu = None
            for row in reversed(self.trials):
                if "mfu" in row:
                    mfu = row["mfu"]
                    break
            entry = {
                "config": dict(best),
                # an all-failed sweep pinned the incumbent with no
                # measured time; JSON has no Infinity
                "step_s": (best_t if best_t == best_t
                           and best_t != float("inf") else None),
                "mfu": mfu,
                "schema": KNOB_SCHEMA_VERSION,
                "knobs": sorted(tuned),
                "numerics_tuned": bool(self._tune_wire),
                "fingerprint": fp,
                "topology": topology_key(),
                "trials": len(self.trials),
                "time_unix": time.time(),
            }
            try:
                self._cache.store(key, entry)
            except OSError as e:
                from ..utils.logging import get_logger

                get_logger().warning(
                    "autotune cache write to %s failed: %s",
                    self._cache.path, e)
        return dict(best)

    @staticmethod
    def _is_writer() -> bool:
        """Only rank 0 persists winners (every rank agreed on the same
        ones; N writers would just race the file). Every port rank is a
        process of its own, so the writer is the world's rank 0, where
        the JAX package's is the first controller."""
        from ..core.basics import is_initialized, rank

        return not is_initialized() or rank() == 0


def warm_start(tree, knobs: Optional[Knobs] = None, *,
               cache_path: Optional[str] = None,
               allow_numerics: Optional[bool] = None,
               exact_topology: bool = False,
               context: str = "") -> Optional[dict]:
    """Pin a cached tuned configuration for this model without running
    any sweep — the consumption half of the warm-start contract, used
    by serving replicas (``serving/engine.py``) and restarted trainers.

    ``tree`` is what ``ops.fusion.model_fingerprint`` takes: a module,
    a mapping of parameter names to tensors (meta tensors do) or
    ``(name, tensor)`` pairs. With ``exact_topology`` the lookup
    requires the full (fingerprint, topology) key; otherwise it falls
    back to the newest entry for the fingerprint (the serving case — an
    inference tier rarely shares the training world's shape).
    Numerics-changing winners are dropped unless ``allow_numerics``
    (default: ``HOROVOD_AUTOTUNE_WIRE``). Returns the pinned
    configuration, or None on a miss."""
    from ..core.knobs import _env
    from ..core.state import global_state

    if knobs is None:
        knobs = global_state().knobs
    path = (cache_path or getattr(knobs, "autotune_cache", "")
            or _env("AUTOTUNE_CACHE") or "")
    if not path:
        return None
    from ..utils import flight as _flight
    from ..utils import metrics as _metrics
    from .fusion import model_fingerprint

    if allow_numerics is None:
        allow_numerics = bool(getattr(knobs, "autotune_wire", False))
    cache = TuneCache(path)
    fp = model_fingerprint(tree)
    entry = (cache.lookup(cache_key(fp)) if exact_topology
             else (cache.lookup(cache_key(fp))
                   or cache.lookup_fingerprint(fp)))
    if entry is None:
        return None
    config = {k: v for k, v in entry["config"].items()
              if k in TUNABLE_KNOBS
              and (allow_numerics or k not in NUMERICS_KNOBS)}
    for k, v in config.items():
        setattr(knobs, k, v)
    _flight.record("autotune", "warm_start", context=context,
                   fingerprint=fp, **config)
    _metrics.record_autotune_pin("warm_start", config,
                                 float(entry.get("step_s") or 0.0),
                                 accepted=True,
                                 source=f"cache:{context or 'init'}")
    return config
