"""Async peer-replicated snapshots + the layered recovery ladder.

The port of ``horovod_tpu/elastic/replication.py``. A worker's committed
snapshot lives in its own host memory: enough for a survivor that
catches ``HorovodInternalError``, useless for the rank that died. Two
pieces close the gap:

**Replication** (``HOROVOD_REPLICATION=1``): every ``State.commit()``
hands the committed snapshot to a background :class:`Replicator`
thread that ships it, pickled with protocol 5 (each
:class:`~horovod_tpu_torch.elastic.state.HostTensor`'s bytes an
out-of-band buffer, so nothing large is copied into the pickle),
chunked (``HOROVOD_REPLICATION_CHUNK_BYTES``), sha256-checksummed and
stamped with the commit epoch, into the in-memory :class:`ReplicaStore`
(a ``KVStoreServer``) of ``HOROVOD_REPLICATION_PARTNERS`` ring-partner
ranks. The commit pays a reference hand-off under a condition variable;
when commits outpace the thread only the newest pending snapshot ships;
a duty cycle bounds the thread's share of the host. A manifest (epoch,
checksum, holders) goes to the rendezvous store's ``replication`` scope
so a respawned rank finds its replicas.

**Recovery ladder** (:func:`run_recovery_ladder`, called by
``hvd.elastic.run`` on entry): restore from the freshest *verified*
source,

    surviving-peer replica  ->  emergency snapshot  ->  checkpoint

comparing the peer and emergency rungs by commit epoch (the peer wins a
tie), falling through on a checksum mismatch, a truncated file or a
snapshot of unknown attributes; the checkpoint rung is
``state.orbax_restore`` (``checkpoint.orbax_rung``). The rung taken
lands in ``hvd_recovery_rung_total{rung=...}`` and in the log.

Fault points: ``replication.send`` (per partner) and
``replication.payload`` (``corrupt``: damage in transit, which the
checksum must catch). The JAX package's routing of writes through a pod
relay and of keys to a sharded root (ROADMAP queue A entry 14) is not
here: the port has one rendezvous store.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import pickle
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..utils import faults, retry

LOG = logging.getLogger("horovod_tpu_torch.elastic")

#: scope on each worker's ReplicaStore holding partners' snapshots
REPLICA_SCOPE = "replica"
#: rendezvous KV scope: rank -> JSON list of that rank's store addresses
STORE_SCOPE = "replica_store"
#: rendezvous KV scope: rank -> manifest copy (epoch/sha256/holders)
MANIFEST_SCOPE = "replication"

DEFAULT_CHUNK_BYTES = 1 << 20
DEFAULT_DUTY_CYCLE = 0.02  # replication's bounded share of host CPU

_TIMEOUT_S = 5.0

# ---------------------------------------------------------------------------
# module state (the no-op fast path)
# ---------------------------------------------------------------------------

_enabled = False
_configured = False
_replicator: Optional["Replicator"] = None
_store: Optional["ReplicaStore"] = None
# replica payloads survive configure/shutdown cycles (elastic
# _reinitialize tears the runtime down and back up in-process; partners'
# replicas must not be lost to that round trip)
_backing: Dict[str, Dict[str, bytes]] = {}


def enabled() -> bool:
    return _enabled


def store() -> Optional["ReplicaStore"]:
    return _store


def replicator() -> Optional["Replicator"]:
    return _replicator


# ---------------------------------------------------------------------------
# raw HTTP verbs (their own bounded policy: replication is best effort
# and must not ride the control plane's 5-attempt ladder or its http.*
# fault points; chaos specs target replication.send instead)
# ---------------------------------------------------------------------------


def _http_put(addr: str, port: int, scope: str, key: str,
              value: bytes) -> None:
    req = urllib.request.Request(
        f"http://{addr}:{port}/{scope}/{key}", data=value, method="PUT"
    )
    with urllib.request.urlopen(req, timeout=_TIMEOUT_S):
        pass


def _http_get(addr: str, port: int, scope: str,
              key: str) -> Optional[bytes]:
    try:
        with urllib.request.urlopen(
                f"http://{addr}:{port}/{scope}/{key}",
                timeout=_TIMEOUT_S) as resp:
            return resp.read()
    except urllib.error.HTTPError as e:
        if e.code == 404:
            return None
        raise


# ---------------------------------------------------------------------------
# replica store (runs inside every worker)
# ---------------------------------------------------------------------------


class ReplicaStore:
    """In-worker HTTP KV store holding ring partners' snapshot chunks.

    Reuses the runner's :class:`KVStoreServer` (scope/key byte store) so
    the replication plane speaks the exact protocol the rendezvous
    already does — same client, same fault points, same ops story.
    """

    def __init__(self, backing: Optional[Dict] = None):
        from ..runner.http.http_server import KVStoreServer

        self._kv = KVStoreServer(store=backing)
        self.port = self._kv.start_server()

    def addresses(self) -> List[Tuple[str, int]]:
        from ..runner.util.network import get_local_host_addresses

        # most-routable address first (get_local_host_addresses lists
        # loopback first): a cross-host fetcher must not dial its OWN
        # loopback before the real NIC
        return [(a, self.port)
                for a in reversed(get_local_host_addresses())]

    @property
    def data(self) -> Dict[str, Dict[str, bytes]]:
        return self._kv.store

    @property
    def lock(self):
        return self._kv.lock

    def shutdown(self) -> None:
        self._kv.shutdown_server()


# ---------------------------------------------------------------------------
# replicator (background thread; one per worker process)
# ---------------------------------------------------------------------------


class Replicator:
    """Ships committed snapshots to ring partners, asynchronously.

    ``submit`` is the whole critical-path cost: stash a reference to the
    committed dict (commit rebinds ``state._saved`` to a fresh dict, so
    the reference is stable) and notify. The thread pickles, chunks,
    checksums and PUTs; when commits outpace it, only the newest pending
    snapshot is shipped — a replica is only useful if it is the
    freshest one.
    """

    def __init__(self, rank: int, size: int, partners: Sequence[int],
                 rendezvous: Tuple[str, int],
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 duty_cycle: float = DEFAULT_DUTY_CYCLE):
        self.rank = int(rank)
        self.size = int(size)
        self.partners = list(partners)
        self.chunk_bytes = max(int(chunk_bytes), 1024)
        # rate control: after a ship that took T seconds the thread
        # idles >= T*(1/d - 1), bounding replication's share of the
        # host's CPU at ~d; under contention the replica lag grows
        # instead of the step time
        self.duty_cycle = min(max(float(duty_cycle), 0.001), 1.0)
        self._rendezvous = rendezvous
        self._cond = threading.Condition()
        self._pending: Optional[Tuple[int, Dict[str, Any]]] = None
        self._stop = False
        self._stop_ev = threading.Event()
        # record_metrics=False: replication is best effort; a dead
        # partner in a respawn window must not count as a control-plane
        # give-up. Its failures have their own accounting (stats,
        # hvd_replication_errors_total, one warning an outage).
        self._policy = retry.RetryPolicy(
            max_attempts=2, base_delay_s=0.05, max_delay_s=0.25,
            record_metrics=False)
        self._outage = retry.Outage(LOG, "snapshot replication")
        self._addr_cache: Dict[int, List[Tuple[str, int]]] = {}
        self.stats = {
            "submitted": 0, "replicated": 0, "coalesced": 0,
            "errors": 0, "last_epoch": 0, "busy_s": 0.0,
        }
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="hvd-replicator")
        self._thread.start()

    # ------------------------------------------------------------- hot path

    def submit(self, epoch: int, saved: Dict[str, Any]) -> None:
        with self._cond:
            if self._pending is not None:
                self.stats["coalesced"] += 1
            self._pending = (int(epoch), saved)
            self.stats["submitted"] += 1
            self._cond.notify()

    def drain(self, timeout_s: float = 5.0) -> bool:
        """Block until the pending snapshot (if any) has shipped — a
        test/shutdown convenience, never called on the training path."""
        deadline = retry.Deadline(timeout_s)
        while not deadline.expired():
            with self._cond:
                if self._pending is None and not self._busy:
                    return True
            time.sleep(0.01)
        return False

    def stop(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify()
        self._stop_ev.set()
        self._thread.join(timeout=5)

    # ----------------------------------------------------------- background

    _busy = False

    def _loop(self) -> None:
        while True:
            with self._cond:
                while self._pending is None and not self._stop:
                    self._cond.wait(timeout=1.0)
                if self._stop:
                    return
                epoch, saved = self._pending
                self._pending = None
                self._busy = True
            t0 = time.monotonic()
            try:
                self._replicate(epoch, saved)
            except Exception as e:  # never let the thread die
                self.stats["errors"] += 1
                self._outage.failure(e)
            finally:
                self._busy = False
            took = time.monotonic() - t0
            self.stats["busy_s"] += took
            # duty-cycle gap (see __init__); newer commits coalesce
            # into _pending while we idle, so the next ship is always
            # the freshest snapshot
            gap = took * (1.0 / self.duty_cycle - 1.0)
            if gap > 0 and self._stop_ev.wait(timeout=gap):
                return

    def _partner_addrs(self, partner: int,
                       refresh: bool = False) -> List[Tuple[str, int]]:
        if not refresh and partner in self._addr_cache:
            return self._addr_cache[partner]
        addr, port = self._rendezvous
        raw = _http_get(addr, port, STORE_SCOPE, f"rank_{partner}")
        addrs = (
            [tuple(a) for a in json.loads(raw.decode())] if raw else []
        )
        if addrs:
            self._addr_cache[partner] = addrs
        else:
            self._addr_cache.pop(partner, None)
        return addrs

    def _serialize(self, epoch: int, saved: Dict[str, Any],
                   ) -> Tuple[List[memoryview], List[int], str]:
        """(parts, sizes, sha256-of-true-payload).

        Steady state pickles with protocol 5 and out-of-band buffers:
        the envelope is small and every tensor's bytes become a
        zero-copy memoryview, so the thread never holds the GIL for a
        large ``pickle.dumps`` (hashing and socket sends release it).
        With fault injection armed (or for objects that refuse
        out-of-band pickling) it falls back to one flat pickle, so a
        ``replication.payload:corrupt`` rule has one payload to damage.
        """
        obj = {
            "epoch": epoch,
            "rank": self.rank,
            "time_unix": time.time(),
            "saved": saved,
        }
        parts: Optional[List[memoryview]] = None
        if not faults.enabled():
            try:
                buffers: List[pickle.PickleBuffer] = []
                envelope = pickle.dumps(
                    obj, protocol=5, buffer_callback=buffers.append)
                parts = [memoryview(envelope)] + [
                    b.raw().cast("B") for b in buffers
                ]
            except Exception:
                parts = None
        if parts is not None:
            h = hashlib.sha256()
            for p in parts:
                h.update(p)
            return parts, [p.nbytes for p in parts], h.hexdigest()
        whole = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        # digest the TRUE payload first, then pass the wire bytes
        # through the chaos hook: a `replication.payload:corrupt` rule
        # simulates damage in transit/storage, which the recovery
        # ladder must reject by checksum mismatch (utils/faults.py)
        digest = hashlib.sha256(whole).hexdigest()
        whole = faults.corrupt(
            "replication.payload", whole, rank=self.rank, epoch=epoch)
        return [memoryview(whole)], [len(whole)], digest

    def _replicate(self, epoch: int, saved: Dict[str, Any]) -> None:
        from ..utils import metrics as _metrics

        parts, sizes, digest = self._serialize(epoch, saved)
        nbytes = sum(sizes)
        chunks: List[memoryview] = []
        for part in parts:
            for i in range(0, part.nbytes, self.chunk_bytes):
                chunks.append(part[i:i + self.chunk_bytes])
        if not chunks:
            chunks = [memoryview(b"")]
        # two alternating slots so a crash mid-write never tears the
        # last complete replica; the manifest (written last) names the
        # live slot and the checksum rejects any torn read regardless
        slot = epoch % 2
        manifest = {
            "epoch": epoch,
            "rank": self.rank,
            "slot": slot,
            "nchunks": len(chunks),
            "nbytes": nbytes,
            "sizes": sizes,
            "sha256": digest,
            "time_unix": time.time(),
        }
        manifest_bytes = json.dumps(manifest).encode()
        shipped: List[int] = []
        for partner in self.partners:
            try:
                faults.inject(
                    "replication.send", rank=self.rank, partner=partner,
                    epoch=epoch,
                )
                addrs = self._partner_addrs(partner)
                if not addrs:
                    raise ConnectionError(
                        f"rank {partner} has no registered replica store"
                    )
                try:
                    self._send_to(addrs, slot, chunks, manifest_bytes)
                except Exception:
                    # the partner may have respawned on a new port:
                    # refresh its registration once and re-try
                    addrs = self._partner_addrs(partner, refresh=True)
                    if not addrs:
                        raise
                    self._send_to(addrs, slot, chunks, manifest_bytes)
                shipped.append(partner)
            except Exception as e:
                self.stats["errors"] += 1
                self._outage.failure(e)
        if shipped:
            self._outage.success()
            self.stats["replicated"] += 1
            self.stats["last_epoch"] = epoch
            manifest["holders"] = shipped
            try:
                addr, port = self._rendezvous
                self._policy.call(
                    _http_put, addr, port, MANIFEST_SCOPE,
                    f"rank_{self.rank}", json.dumps(manifest).encode(),
                    point="replication.manifest",
                )
            except Exception as e:
                self._outage.failure(e)
            _metrics.record_replication(nbytes, len(shipped))
        else:
            _metrics.record_replication_error()

    def _send_to(self, addrs: List[Tuple[str, int]], slot: int,
                 chunks: List[memoryview], manifest_bytes: bytes) -> None:
        import http.client

        last: Optional[Exception] = None
        for a, p in addrs:
            conn = None
            try:
                # ONE keep-alive connection for the whole snapshot:
                # a multi-chunk send must not pay a TCP handshake per
                # megabyte (the KV server speaks HTTP/1.1)
                def _open():
                    return http.client.HTTPConnection(
                        a, p, timeout=_TIMEOUT_S)

                conn = _open()

                def _put(key: str, body) -> None:
                    nonlocal conn
                    try:
                        conn.request(
                            "PUT", f"/{REPLICA_SCOPE}/{key}", body=body)
                        resp = conn.getresponse()
                        resp.read()
                    except Exception:
                        # a dropped keep-alive poisons the connection
                        # object; rebuild it for the retry
                        try:
                            conn.close()
                        except Exception:
                            pass
                        conn = _open()
                        raise
                    if resp.status != 200:
                        raise ConnectionError(
                            f"replica PUT {key} -> {resp.status}")

                for i, chunk in enumerate(chunks):
                    self._policy.call(
                        _put, f"{self.rank}/s{slot}/c{i}", chunk,
                        point="replication.send",
                    )
                self._policy.call(
                    _put, f"{self.rank}/manifest", manifest_bytes,
                    point="replication.send",
                )
                return
            except Exception as e:
                last = e
            finally:
                if conn is not None:
                    try:
                        conn.close()
                    except Exception:
                        pass
        raise last if last else ConnectionError("no replica addresses")


# ---------------------------------------------------------------------------
# commit hook (the training-path entry; single predicted branch when off)
# ---------------------------------------------------------------------------


def on_commit(state) -> None:
    """Called by ``State.commit()`` after the snapshot is saved. Hands
    the committed dict to the background replicator — a reference stash
    + notify, nothing else, so the training critical path pays only
    this call when enabled and one predicted branch when disabled."""
    if not _enabled:
        return
    rep = _replicator
    if rep is None:
        return
    rep.submit(int(getattr(state, "_commit_count", 0)), state._saved)


# ---------------------------------------------------------------------------
# recovery ladder
# ---------------------------------------------------------------------------


def ring_partners(rank: int, size: int, k: int) -> List[int]:
    """The k ranks after ``rank`` on the ring (self excluded)."""
    return [
        (rank + j) % size
        for j in range(1, min(max(k, 0), size - 1) + 1)
        if (rank + j) % size != rank
    ]


def fetch_replica(
    for_rank: int, rendezvous: Tuple[str, int],
) -> Optional[Tuple[int, Dict[str, Any]]]:
    """The freshest checksum-verified replica of ``for_rank`` from any
    surviving holder, or None. Holder list comes from the replication
    manifest mirrored to the rendezvous KV; each holder's store address
    from its registration. Verification failures (corrupt chunks, torn
    slots, missing stores) are warnings that try the next holder."""
    addr, port = rendezvous
    raw = _http_get(addr, port, MANIFEST_SCOPE, f"rank_{for_rank}")
    if raw is None:
        return None
    try:
        manifest = json.loads(raw.decode())
    except ValueError:
        LOG.warning("unparseable replication manifest for rank %d",
                    for_rank)
        return None
    holders = manifest.get("holders", [])
    best: Optional[Tuple[int, Dict[str, Any]]] = None
    for holder in holders:
        try:
            reg = _http_get(addr, port, STORE_SCOPE, f"rank_{holder}")
            if reg is None:
                continue
            for a, p in [tuple(x) for x in json.loads(reg.decode())]:
                got = _fetch_from_store(a, p, for_rank)
                if got is None:
                    continue
                if best is None or got[0] > best[0]:
                    best = got
                break
        except Exception as e:
            LOG.warning(
                "replica fetch for rank %d from holder %s failed: %s",
                for_rank, holder, e,
            )
    return best


def _fetch_from_store(
    addr: str, port: int, for_rank: int,
) -> Optional[Tuple[int, Dict[str, Any]]]:
    raw = _http_get(addr, port, REPLICA_SCOPE, f"{for_rank}/manifest")
    if raw is None:
        return None
    m = json.loads(raw.decode())
    slot, nchunks = m["slot"], m["nchunks"]
    parts: List[bytes] = []
    for i in range(nchunks):
        chunk = _http_get(
            addr, port, REPLICA_SCOPE, f"{for_rank}/s{slot}/c{i}")
        if chunk is None:
            LOG.warning(
                "replica of rank %d at %s:%d is missing chunk %d/%d",
                for_rank, addr, port, i, nchunks,
            )
            return None
        parts.append(chunk)
    payload = b"".join(parts)
    digest = hashlib.sha256(payload).hexdigest()
    if digest != m.get("sha256") or len(payload) != m.get("nbytes"):
        LOG.warning(
            "replica of rank %d at %s:%d failed checksum verification "
            "(epoch %s); falling through",
            for_rank, addr, port, m.get("epoch"),
        )
        return None
    sizes = m.get("sizes") or [len(payload)]
    if len(sizes) == 1:
        obj = pickle.loads(payload)
    else:
        # out-of-band wire format: envelope pickle + raw array buffers
        # (Replicator._serialize); split the verified stream back by
        # the manifest's sizes
        view = memoryview(payload)
        offset = sizes[0]
        envelope = bytes(view[:offset])
        buffers = []
        for s in sizes[1:]:
            buffers.append(view[offset:offset + s])
            offset += s
        obj = pickle.loads(envelope, buffers=buffers)
    return int(obj.get("epoch", 0)), obj["saved"]


def _install(state, saved: Dict[str, Any], epoch: int,
             rung: str) -> bool:
    """Adopt a verified snapshot into ``state``. A snapshot whose keys
    the state never registered is treated like corruption: warn and let
    the ladder fall through."""
    unknown = [k for k in saved if k not in state._known]
    if unknown:
        LOG.warning(
            "%s snapshot carries unregistered state attributes %s "
            "(registered: %s); falling through", rung, unknown,
            state._known,
        )
        return False
    state._saved = dict(saved)
    state.restore()
    state._commit_count = max(
        int(getattr(state, "_commit_count", 0)), int(epoch))
    state._saved_epoch = int(epoch)
    return True


def _rendezvous_from_env() -> Optional[Tuple[str, int]]:
    addr = (os.environ.get("HVD_TPU_RENDEZVOUS_ADDR")
            or os.environ.get("HOROVOD_GLOO_RENDEZVOUS_ADDR"))
    port = (os.environ.get("HVD_TPU_RENDEZVOUS_PORT")
            or os.environ.get("HOROVOD_GLOO_RENDEZVOUS_PORT"))
    if not addr or not port:
        return None
    try:
        return addr, int(port)
    except ValueError:
        return None


def _env_rank() -> int:
    for name in ("HVD_TPU_RANK", "HOROVOD_RANK"):
        v = os.environ.get(name)
        if v:
            try:
                return int(v)
            except ValueError:
                pass
    return 0


def run_recovery_ladder(
    state,
    emergency_path: Optional[str] = None,
    orbax_restore=None,
    rendezvous: Optional[Tuple[str, int]] = None,
    rank: Optional[int] = None,
) -> Optional[str]:
    """Restore ``state`` from the freshest verified source and return
    the rung that supplied it (``"peer"`` / ``"emergency"`` /
    ``"orbax"``), or None when no source yielded a verified snapshot
    (the state keeps its fresh-constructed values).

    The peer and emergency rungs are compared by commit epoch — the
    fresher *verified* snapshot wins, with the peer rung breaking ties
    (it is the per-commit source). The orbax rung
    (``state.orbax_restore`` or the ``orbax_restore`` callable, e.g.
    built by ``checkpoint.orbax_rung``) is the last resort: a
    checkpoint is the stalest source. Every outcome lands in
    ``hvd_recovery_rung_total{rung=...}`` and the log.
    """
    from ..utils import metrics as _metrics

    attempted = False
    candidates: List[Tuple[int, int, str, Dict[str, Any]]] = []

    rdv = rendezvous or _rendezvous_from_env()
    my_rank = _env_rank() if rank is None else int(rank)
    if rdv is not None and (_enabled or _configured or rendezvous):
        attempted = True
        try:
            got = fetch_replica(my_rank, rdv)
            if got is not None:
                # priority 0 beats 1 on epoch ties: the peer replica is
                # the per-commit source
                candidates.append((got[0], 0, "peer", got[1]))
        except Exception as e:
            LOG.warning("peer-replica rung failed: %s", e)

    if emergency_path and os.path.exists(emergency_path):
        attempted = True
        try:
            from . import preemption

            epoch, saved = preemption.emergency_read(emergency_path)
            candidates.append((epoch, 1, "emergency", saved))
        except Exception as e:
            LOG.warning(
                "emergency snapshot %s unusable (%s); falling through "
                "to the next recovery rung", emergency_path, e,
            )

    for epoch, _prio, rung, saved in sorted(
            candidates, key=lambda c: (-c[0], c[1])):
        if _install(state, saved, epoch, rung):
            LOG.warning(
                "recovered state from %s snapshot (commit epoch %d)",
                rung, epoch,
            )
            _metrics.record_recovery_rung(rung)
            return rung

    restore_fn = orbax_restore or getattr(state, "orbax_restore", None)
    if restore_fn is not None:
        attempted = True
        try:
            if restore_fn(state):
                state.save()
                LOG.warning("recovered state from checkpoint (orbax rung)")
                _metrics.record_recovery_rung("orbax")
                return "orbax"
        except Exception as e:
            LOG.warning("orbax rung failed: %s", e)

    if attempted:
        LOG.warning(
            "recovery ladder exhausted with no verified snapshot; "
            "starting from constructed state")
        _metrics.record_recovery_rung("none")
    return None


# ---------------------------------------------------------------------------
# lifecycle (core/basics.py calls configure/on_shutdown)
# ---------------------------------------------------------------------------


def configure(
    knobs=None,
    *,
    enabled_override: Optional[bool] = None,
    rank: Optional[int] = None,
    size: Optional[int] = None,
    partners: Optional[int] = None,
    chunk_bytes: Optional[int] = None,
    duty_cycle: Optional[float] = None,
    rendezvous_addr: Optional[str] = None,
    rendezvous_port: Optional[int] = None,
) -> bool:
    """Arm replication from the knob snapshot (hvd.init) or explicit
    overrides (tests; env fallbacks for both). Starts
    the replica store, registers it in the rendezvous KV and spawns the
    replicator thread. Returns True when replication is live; False
    when disabled or the world cannot support it (size < 2, no
    rendezvous)."""
    global _enabled, _configured, _replicator, _store

    if knobs is None and enabled_override is None:
        from ..core.knobs import Knobs

        knobs = Knobs.from_env()
    want = (
        bool(getattr(knobs, "replication_enabled", False))
        if enabled_override is None else bool(enabled_override)
    )
    if not want:
        stop()
        return False

    my_rank = _env_rank() if rank is None else int(rank)
    world = (
        int(os.environ.get("HVD_TPU_SIZE")
            or os.environ.get("HOROVOD_SIZE") or 1)
        if size is None else int(size)
    )
    rdv: Optional[Tuple[str, int]]
    if rendezvous_addr is not None and rendezvous_port:
        rdv = (rendezvous_addr, int(rendezvous_port))
    else:
        rdv = _rendezvous_from_env()
    if world < 2 or rdv is None:
        LOG.warning(
            "replication requested but unusable here (world %d, "
            "rendezvous %s); disabled", world, rdv,
        )
        stop()
        return False

    k = int(partners if partners is not None
            else getattr(knobs, "replication_partners", 1) or 1)
    chunk = int(chunk_bytes if chunk_bytes is not None
                else getattr(knobs, "replication_chunk_bytes",
                             DEFAULT_CHUNK_BYTES))
    duty = float(duty_cycle if duty_cycle is not None
                 else getattr(knobs, "replication_duty_cycle",
                              DEFAULT_DUTY_CYCLE))
    stop()  # idempotent re-init (elastic _reinitialize path)
    _store = ReplicaStore(backing=_backing)
    try:
        _http_put(
            rdv[0], rdv[1], STORE_SCOPE, f"rank_{my_rank}",
            json.dumps(_store.addresses()).encode(),
        )
    except Exception as e:
        LOG.warning(
            "could not register replica store with the rendezvous "
            "(%s); peers will not find this rank's store until the "
            "next registration", e,
        )
    _replicator = Replicator(
        my_rank, world, ring_partners(my_rank, world, k), rdv,
        chunk_bytes=chunk, duty_cycle=duty,
    )
    _configured = True
    _enabled = True
    LOG.info(
        "snapshot replication armed: rank %d -> partners %s "
        "(chunk %d B)", my_rank, _replicator.partners, chunk,
    )
    return True


def stop() -> None:
    """Tear down the replicator thread and replica store. Replica
    payloads survive in the module backing dict, so an in-process
    re-init (elastic reset) does not lose partners' snapshots."""
    global _enabled, _replicator, _store
    _enabled = False
    if _replicator is not None:
        _replicator.stop()
        _replicator = None
    if _store is not None:
        _store.shutdown()
        _store = None


def on_shutdown() -> None:
    """hvd.shutdown(): stop threads if configure() armed us."""
    global _configured
    if _configured:
        _configured = False
        stop()


def reset() -> None:
    """Test hook: full teardown including the replica backing dict."""
    global _configured
    stop()
    _configured = False
    _backing.clear()
