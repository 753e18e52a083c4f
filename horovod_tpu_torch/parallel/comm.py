"""Communicators of a mesh axis: the exchanges tensor and sequence
parallelism issue.

Three primitives, each over the ranks of one slice of one axis, in the
slice's rank order:

* ``all_gather(t)`` -> every rank's ``t``, a list in rank order;
* ``all_to_all(chunks)`` -> the chunk each rank addressed to this one
  (``chunks[j]`` goes to rank j), a list in rank order;
* ``send_recv(t)`` -> the ``t`` of the previous rank on the ring, this
  rank's going to the next one;
* ``hop_forward(t)`` and ``hop_backward(t)``: the pipeline's hops along
  the chain (not the ring): forward, rank i's ``t`` to rank i + 1, rank
  0 receiving zeros; backward, rank i + 1's to rank i, the last rank
  receiving zeros (the JAX package's ``fwd_perm`` and ``bwd_perm``).
  Every rank calls each hop, an idle one with zeros, or the ranks'
  exchanges no longer pair up.

``all_reduce(t)`` is built on ``all_gather``: the ranks' tensors summed
in rank order in float32 and rounded once to ``t``'s dtype
(:func:`sum_in_rank_order`), so every rank gets the same bits, and an
in-process emulation of the world gets them too. ``reduce_scatter(t)``
is built on ``all_to_all`` (a rank moves 1/n of ``t``'s bytes): ``t``'s
first dimension splits into one chunk a rank, and rank j gets chunk j
summed over the ranks the same way.

:class:`GroupComm` runs them over a process set's ``torch.distributed``
group (NCCL on the card, gloo on the CPU). :class:`ThreadComm` runs them
between the threads of one process, one per emulated rank, behind a
barrier (:class:`ThreadWorld`, :func:`run_ranks`): one card cannot hold
an NCCL world of several ranks, so ``chip_smoke.py`` runs a tp or sp
world that way, every rank's module code the same as in a real world.
The emulated ranks share the current stream, so each reads the others'
tensors in the order the host enqueued their kernels.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Sequence, Tuple

import torch
import torch.distributed as dist


def sum_in_rank_order(parts: Sequence[torch.Tensor],
                      acc_dtype: torch.dtype = torch.float32
                      ) -> torch.Tensor:
    """``parts[0] + parts[1] + ...`` in ``acc_dtype``, rounded once to
    the first part's dtype."""
    acc = parts[0].to(acc_dtype)
    for p in parts[1:]:
        acc = acc + p.to(acc_dtype)
    return acc.to(parts[0].dtype)


def reduce_grads(params: Sequence[torch.Tensor], comm,
                 average: bool = False) -> None:
    """Sum the parameters' ``.grad`` over ``comm``'s ranks, in rank
    order, in one exchange; with ``average``, divide the sums by the
    ranks' count, as the ``DistributedOptimizer`` averages."""
    params = [p for p in params if p.grad is not None]
    flat = comm.all_reduce(torch.cat([p.grad.reshape(-1) for p in params]))
    if average:
        flat.div_(comm.size)
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad = g.view_as(p).clone()


class _Comm:
    rank: int
    size: int

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        raise NotImplementedError

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The SUM over the ranks, in rank order (see module doc)."""
        return sum_in_rank_order(self.all_gather(t))

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's chunk of ``t`` (its first dimension split into
        ``size`` equal chunks) summed over the ranks in rank order, in
        float32 and rounded once to ``t``'s dtype."""
        if t.shape[0] % self.size:
            raise ValueError(f"reduce_scatter: dimension 0 of {tuple(t.shape)}"
                             f" does not split over {self.size} ranks")
        return sum_in_rank_order(self.all_to_all(
            [c.contiguous() for c in t.chunk(self.size)]))


class GroupComm(_Comm):
    """The exchanges over ``process_set``'s group (None: the world)."""

    def __init__(self, process_set=None):
        from ..core.process_sets import set_context

        ctx = set_context(process_set)
        self.group, self.size, self.rank = ctx.group, ctx.size, ctx.rank
        self.ranks = list(ctx.ranks)

    def all_gather(self, t):
        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t, group=self.group)
        return out

    def all_to_all(self, chunks):
        from ..ops.collectives import _all_to_all_tiled

        shape = chunks[0].shape
        flat = torch.cat([c.reshape(-1) for c in chunks])
        out, work = _all_to_all_tiled(flat, self.group)
        work.wait()
        return [c.view(shape) for c in out.chunk(self.size)]

    def send_recv(self, t):
        t = t.contiguous()
        out = torch.empty_like(t)
        nxt = self.ranks[(self.rank + 1) % self.size]
        prv = self.ranks[(self.rank - 1) % self.size]
        ops = [dist.P2POp(dist.isend, t, nxt, self.group),
               dist.P2POp(dist.irecv, out, prv, self.group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return out

    def hop_forward(self, t):
        return self._hop(t, +1)

    def hop_backward(self, t):
        return self._hop(t, -1)

    def _hop(self, t, step):
        """``t`` to the rank ``step`` along the chain, the rank ``-step``
        along it received (zeros at the chain's end): P2P operations on
        the chain's edges only."""
        t = t.contiguous()
        out = torch.empty_like(t)
        to, frm = self.rank + step, self.rank - step
        ops = []
        if 0 <= to < self.size:
            ops.append(dist.P2POp(dist.isend, t, self.ranks[to], self.group))
        if 0 <= frm < self.size:
            ops.append(dist.P2POp(dist.irecv, out, self.ranks[frm],
                                  self.group))
        else:
            out.zero_()
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return out


class SelfComm(_Comm):
    """The exchanges of an axis of one rank: each gives back its input
    (a ring of one for sequence parallelism on an sp axis of size 1)."""

    rank, size = 0, 1

    def all_gather(self, t):
        return [t]

    def all_to_all(self, chunks):
        return list(chunks)

    def send_recv(self, t):
        return t

    def hop_forward(self, t):
        return torch.zeros_like(t)

    hop_backward = hop_forward


class ThreadWorld:
    """The shared state of ``n`` emulated ranks: two rows of a slot a
    rank, used in turns, and a barrier (``timeout`` seconds, so a rank
    that fails cannot hang the others: :meth:`abort` breaks the barrier
    for them)."""

    def __init__(self, n: int, timeout: float = 600.0):
        self.n = n
        self._rows: Tuple[List[object], List[object]] = ([None] * n,
                                                         [None] * n)
        self._turn = [0] * n
        self.barrier = threading.Barrier(n, timeout=timeout)

    def exchange(self, rank: int, value) -> list:
        """Every rank's ``value``, in rank order. One barrier a call: a
        rank writes a row again two calls later, when every rank has
        passed the barrier between, so has read it."""
        turn = self._turn[rank]
        self._turn[rank] = turn ^ 1
        row = self._rows[turn]
        row[rank] = value
        self.barrier.wait()
        return list(row)

    def abort(self) -> None:
        self.barrier.abort()


class ThreadComm(_Comm):
    """Rank ``rank``'s exchanges in a :class:`ThreadWorld`: the other
    ranks' tensors themselves (no copy), read on the shared stream."""

    def __init__(self, world: ThreadWorld, rank: int):
        self.world, self.rank, self.size = world, rank, world.n

    def all_gather(self, t):
        return self.world.exchange(self.rank, t)

    def all_to_all(self, chunks):
        rows = self.world.exchange(self.rank, list(chunks))
        return [rows[j][self.rank] for j in range(self.size)]

    def send_recv(self, t):
        return self.world.exchange(self.rank, t)[(self.rank - 1) % self.size]

    def hop_forward(self, t):
        return self._hop(t, +1)

    def hop_backward(self, t):
        return self._hop(t, -1)

    def _hop(self, t, step):
        frm = self.rank - step
        got = self.world.exchange(self.rank, t)
        return got[frm] if 0 <= frm < self.size else torch.zeros_like(t)


def run_ranks(worlds: Sequence[ThreadWorld], fn: Callable[[int], object],
              n: int) -> list:
    """``fn(r)`` for the ranks ``r < n`` of an emulated world, each in a
    thread of its own with the autograd engine's device threads off
    (``torch.autograd.set_multithreading_enabled(False)``: a backward
    then runs on the thread that calls it, so one rank's exchange inside
    a backward waits only for the other ranks, not for a device thread
    they share). Returns the results in rank order; the first rank that
    raises aborts ``worlds`` and its exception is raised here."""
    results: list = [None] * n
    errors: list = []

    def body(r):
        try:
            with torch.autograd.set_multithreading_enabled(False):
                results[r] = fn(r)
        except BaseException as e:  # re-raised below, in the caller
            errors.append((r, e))
            for w in worlds:
                w.abort()

    threads = [threading.Thread(target=body, args=(r,), daemon=True)
               for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        # the cause, not a barrier it broke for the other ranks
        first = min(errors, key=lambda e: isinstance(
            e[1], threading.BrokenBarrierError))
        raise first[1]
    return results
