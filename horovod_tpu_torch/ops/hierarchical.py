"""Two-level (hierarchical) collectives: an inner domain of ``block``
consecutive ranks (a host's cards) and an outer leg across the domains.

The port of the JAX package's ``ops/hierarchical.py`` (the reference
Horovod's ``NCCLHierarchicalAllreduce``: intra-node reduce-scatter,
cross-node allreduce of the shard, intra-node all-gather; and its
hierarchical allgather), selected by ``HOROVOD_HIERARCHICAL_ALLREDUCE``,
``HOROVOD_HIERARCHICAL_ALLGATHER`` and ``HOROVOD_HIERARCHICAL_LOCAL_SIZE``::

    allreduce(x)  =  all_gather_inner( sum_outer( reduce_scatter_inner(x) ) )
    allgather(x)  =  all_gather_outer( all_gather_inner(x) )

The outer leg moves 1/block of the bytes, which is the point on a slow
cross-host link. The world is one flat rank space whose ranks ``0..n-1``
pack ``block`` consecutive ranks per inner domain, as the launcher
numbers local ranks: inner domains are contiguous blocks, the outer
sets strided across them (:func:`block_groups`). Each runs on a
registered process set (``core/process_sets.py``), so the first call
with a block registers the world's inner and outer sets, on every rank:
it is collective, as ``add_process_set`` is.

The block comes from one of two places (:func:`two_level_block`):

* a world whose mesh (``hvd.mesh()``, ``HOROVOD_MESH``) has 2+ live
  axes takes the JAX package's two-axis form: the inner domain is the
  last live axis, whose ranks are contiguous blocks since the mesh is
  row-major, the outer domain the product of the others
  (:func:`mesh_block`). The collectives take it when the knob is on;
  the int8 ``DistributedOptimizer`` always (:func:`int8_block`), as
  ``horovod_tpu/optim/distributed.py:46-63`` does;
* a world of one live axis takes ``HOROVOD_HIERARCHICAL_LOCAL_SIZE``
  (0: the launcher's ranks per host), when the knob is on.

:func:`hierarchical_psum` and :func:`hierarchical_allgather` also take
the mesh's axes in place of a block, as the JAX functions take their
axes: the inner domain is the last axis given, even of one rank, and
the outer the others (:func:`axes_block`).

The outer leg of :func:`hierarchical_psum` takes a wire
(``optim/compression.py`` ``WireSpec``); the inner legs always run at
full precision:

* none: an all-reduce of the shard;
* bf16/fp16: the all-reduce in the wire dtype;
* int8: each rank quantizes its inner-reduced shard as one row of whole
  blocks (B11, or B12 with an error-feedback residual), the codes and
  scales are all-gathered over the outer set, and each rank
  dequantizes and sums the peers' rows in peer order (B13). This is the
  JAX package's fused leg (``horovod_tpu/ops/hierarchical.py:117-134``),
  bitwise its unfused one. The residual keeps the JAX layout: a buffer
  of ``x``'s shape whose first ``shard_len`` entries hold this rank's
  shard residual (:func:`_stash_shard_residual`), the rest zeros.

With ``block`` 1 (no knob value and one host, a block that does not
divide the world, or a block of the whole world; not so for axes) the
call takes the flat route: ``quantized_psum`` for int8, a cast, an all-reduce and a
cast back for the float wires.

The stages around the exchanges (:func:`stage_inner_reduce`,
:func:`stage_outer_quantize`, :func:`stage_outer_accumulate`) let one
card compose a world of several ranks with slicing in place of the
exchanges (:func:`emulated_hierarchical_psum`), as
``quantized_collectives.emulated_quantized_psum`` does for the flat
wire.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..core.basics import _require_init
from ..core.exceptions import HorovodInternalError
from ..optim.compression import _pad_flat
from . import quantized_collectives as qc


def block_groups(world: int, block: int) -> Tuple[list, list]:
    """The inner and outer rank groups of ``block`` consecutive ranks a
    domain: inner ``[0..b-1], [b..2b-1], ...``; outer the ranks at one
    offset in every domain, ``[i, i + b, i + 2b, ...]``."""
    inner = [list(range(i, i + block)) for i in range(0, world, block)]
    outer = [list(range(off, world, block)) for off in range(block)]
    return inner, outer


def resolve_block(world: int, block: int = 0) -> int:
    """The inner domain's size: ``block`` when positive, else the
    launcher's ranks per host (``local_size()``, as the reference Horovod
    takes its local communicator); 1 (no hierarchy) when it does not
    divide the world or spans it."""
    if block <= 0:
        st = _require_init()
        block = st.local_size
    if block <= 1 or block >= world or world % block:
        return 1
    return block


def hierarchy_enabled_for(op_kind: str, process_set) -> bool:
    """The knob gate: the two-level route applies to the global set's
    SUM/AVERAGE allreduce (``"allreduce"``) and allgather
    (``"allgather"``), as in the reference Horovod and the JAX package.
    The global set may come as None, as set 0 or as a set of every
    rank."""
    from ..core.state import global_state

    st = global_state()
    if not st.initialized:
        return False
    if process_set is not None and process_set.process_set_id != 0 and \
            process_set.ranks != list(range(st.size)):
        return False
    if op_kind == "allreduce":
        return bool(st.knobs.hierarchical_allreduce)
    if op_kind == "allgather":
        return bool(st.knobs.hierarchical_allgather)
    return False


def mesh_block(mesh=None) -> int:
    """The inner domain a mesh of 2+ live axes gives (default: the
    world's, ``hvd.mesh()``): the size of its last live axis, whose
    ranks are contiguous blocks in the row-major mesh; 0 for a mesh of
    fewer live axes."""
    if mesh is None:
        mesh = _require_init().mesh
    live = () if mesh is None else mesh.live_axes()
    return mesh.axis_size(live[-1]) if len(live) > 1 else 0


def two_level_block(op_kind: str, process_set=None) -> int:
    """The one routing decision of the collectives: the inner domain's
    size when the knobs send this collective through two levels
    (:func:`hierarchy_enabled_for`), from the world's mesh when it has
    2+ live axes (:func:`mesh_block`), else a block that
    :func:`resolve_block` keeps above 1 for
    ``HOROVOD_HIERARCHICAL_LOCAL_SIZE``; 1 leaves it on its flat
    route."""
    if not hierarchy_enabled_for(op_kind, process_set):
        return 1
    st = _require_init()
    return mesh_block(st.mesh) or resolve_block(
        st.size, st.knobs.hierarchical_local_size)


def int8_block() -> int:
    """The int8 ``DistributedOptimizer``'s route over the world: the
    mesh's inner domain whenever the world has 2+ live axes, knob or
    not; otherwise :func:`two_level_block`."""
    st = _require_init()
    return mesh_block(st.mesh) or two_level_block("allreduce")


def axes_block(axes: Sequence[str], mesh=None) -> int:
    """The inner domain of the two-axis form over ``axes`` of the
    world's mesh (default ``hvd.mesh()``): the size of the last axis
    given. The axes must be the mesh's, in its order, and hold every
    live axis (the sum is over the world); an axis after the last one
    given must have size 1 (its ranks would not be contiguous)."""
    if mesh is None:
        mesh = _require_init().mesh
    axes = tuple(axes)
    names = mesh.axis_names
    if not axes or any(a not in names for a in axes) or \
            list(axes) != sorted(axes, key=names.index):
        raise ValueError(f"axes {axes} are not axes of {mesh!r} in its "
                         "order")
    missing = [a for a in mesh.live_axes() if a not in axes]
    after = [a for a in names[names.index(axes[-1]) + 1:]
             if mesh.axis_size(a) > 1]
    if missing or after:
        raise ValueError(f"axes {axes} of {mesh!r} must hold every live "
                         f"axis, the inner one last; {missing or after} "
                         "left out")
    return mesh.axis_size(axes[-1])


def _resolve(world: int, block) -> Tuple[int, bool]:
    """``(inner domain size, whether the call takes two levels)`` of a
    block or of the mesh's axes (:func:`axes_block`: two levels even
    with an inner or an outer domain of one rank, as the JAX package's
    two-axis form)."""
    if isinstance(block, (tuple, list)):
        return axes_block(block), True
    block = resolve_block(world, block)
    return block, block > 1


def block_sets(block: int):
    """This rank's inner and outer process sets; registers every
    domain's inner and outer set on first use (collective: every rank,
    in the same order)."""
    from ..core.process_sets import add_or_get_process_set

    st = _require_init()
    inner, outer = block_groups(st.size, block)
    inner_sets = [add_or_get_process_set(g) for g in inner]
    outer_sets = [add_or_get_process_set(g) for g in outer]
    return inner_sets[st.rank // block], outer_sets[st.rank % block]


# -- the stages ---------------------------------------------------------------

def stage_inner_reduce(chunks: Sequence[torch.Tensor]) -> torch.Tensor:
    """The inner reduce-scatter's sum of one shard over the domain's
    ranks, in rank order (the emulation's; NCCL or gloo sums it on a
    real world)."""
    acc = chunks[0]
    for c in chunks[1:]:
        acc = acc + c
    return acc


def stage_outer_quantize(shard: torch.Tensor,
                         residual: Optional[torch.Tensor], block: int):
    """The int8 outer leg's first stage on one rank: its float32
    inner-reduced shard (L,) as one row of whole blocks, quantized (B11;
    B12 after adding ``residual``, the shard's error-feedback residual
    (L,)). Returns ``(q int8 (m,), scales (m / block,), err)``, ``err``
    the new shard residual (L,) or None."""
    if residual is None:
        q, s = qc.quantize_rows(shard, 1, block)
        return q.reshape(-1), s.reshape(-1), None
    q, s, err = qc.quantize_ef_rows(shard, residual, 1, block)
    return q.reshape(-1), s.reshape(-1), err


def stage_outer_accumulate(qg: torch.Tensor, sg: torch.Tensor, n: int,
                           length: int, block: int) -> torch.Tensor:
    """The int8 outer leg's second stage: the ``n`` outer peers' codes
    and scales, gathered in peer order, dequantized and summed in that
    order (B13); the first ``length`` float32 values."""
    m = qg.numel() // n
    return qc.accum_rows(qg.reshape(n, m), sg.reshape(n, m // block),
                         block)[:length]


def _stash_shard_residual(like: torch.Tensor, shard_res: torch.Tensor,
                          shard_len: int) -> torch.Tensor:
    """The shard residual parked in the head of a float32 buffer of
    ``like``'s shape (``shard_len <= like.numel()``: the shard is
    ``ceil(L / block)`` long)."""
    buf = torch.zeros(max(like.numel(), 1), dtype=torch.float32,
                      device=like.device)
    buf[:shard_len] = shard_res.reshape(-1)[:shard_len]
    return buf[:like.numel()].reshape(like.shape)


def _check_wire(wire, residual) -> None:
    if residual is not None and (wire is None or wire.kind != "int8"):
        raise HorovodInternalError(
            "error-feedback residual requires an int8 wire")
    if wire is not None and wire.kind not in ("fp16", "bf16", "int8"):
        raise HorovodInternalError(f"unknown wire kind {wire.kind}")


# -- over torch.distributed ---------------------------------------------------

def _all_reduce(t: torch.Tensor, group=None):
    return dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group,
                           async_op=True)


def start_hierarchical_psum(x: torch.Tensor,
                            block: Union[int, Sequence[str]] = 0, wire=None,
                            residual: Optional[torch.Tensor] = None):
    """Enqueue :func:`hierarchical_psum` of ``x`` up to its outer
    exchange. Returns ``(finish, new_residual)``: ``finish()`` returns
    the sum in ``x``'s shape and dtype; ``new_residual`` (x-shaped
    float32, the shard residual at its head) is None without a
    residual. ``block`` 0 resolves as :func:`resolve_block` does; the
    mesh's axes as :func:`axes_block` does."""
    _check_wire(wire, residual)
    st = _require_init()
    world = st.size
    block, two = _resolve(world, block)
    if not two:
        return _start_flat(x, world, wire, residual)
    from ..core.process_sets import set_context

    if 1 < block < world:
        inner, outer = (set_context(ps).group for ps in block_sets(block))
    else:
        # the two-axis form with a domain of one rank, which exchanges
        # nothing, beside one of every rank: the world's group
        inner = outer = None
    n_outer = world // block
    flat = _pad_flat(x.detach().reshape(-1).contiguous(), block)
    from .collectives import _all_gather_tiled, _reduce_scatter_tiled

    if block > 1:
        rs, work = _reduce_scatter_tiled(flat, block, inner)
        work.wait()
    else:  # an inner domain of one rank
        rs = flat
    shard_len = rs.numel()

    def gather_outer(t):
        if n_outer == 1:
            return t, None
        return _all_gather_tiled(t, n_outer, outer)

    if wire is None or wire.kind in ("fp16", "bf16"):
        wire_rs = rs if wire is None else rs.to(wire.wire_dtype)
        if wire_rs.data_ptr() == flat.data_ptr():
            wire_rs = wire_rs.clone()  # the input is never written
        outer_work = (_all_reduce(wire_rs, outer) if n_outer > 1
                      else None)
        err = None

        def outer_sum() -> torch.Tensor:
            if outer_work is not None:
                outer_work.wait()
            return wire_rs.to(rs.dtype)
    else:
        shard = rs.to(torch.float32)
        res = None if residual is None else \
            residual.detach().reshape(-1)[:shard_len].to(
                torch.float32).contiguous()
        q, s, err = stage_outer_quantize(shard, res, wire.block)
        (qg, wq), (sg, ws) = gather_outer(q), gather_outer(s)

        def outer_sum() -> torch.Tensor:
            for w in (wq, ws):
                if w is not None:
                    w.wait()
            return stage_outer_accumulate(qg, sg, n_outer, shard_len,
                                          wire.block).to(rs.dtype)

    def finish() -> torch.Tensor:
        full = outer_sum()
        if block > 1:
            full, w = _all_gather_tiled(full, block, inner)
            w.wait()
        return full[:x.numel()].reshape(x.shape)

    new_res = None if err is None else \
        _stash_shard_residual(x, err, shard_len)
    return finish, new_res


def _start_flat(x, world, wire, residual):
    """The one-level route of :func:`start_hierarchical_psum`."""
    if wire is not None and wire.kind == "int8":
        from ..optim.compression import quantized_psum

        out = quantized_psum(x, world, wire.block, residual=residual)
        if residual is None:
            return (lambda: out), None
        y, err = out
        return (lambda: y), err
    buf = x.detach() if wire is None else x.detach().to(wire.wire_dtype)
    if buf.data_ptr() == x.data_ptr():  # the input is never written
        buf = buf.clone()
    work = _all_reduce(buf)

    def finish() -> torch.Tensor:
        work.wait()
        return buf.to(x.dtype)

    return finish, None


def hierarchical_psum(x: torch.Tensor, block: Union[int, Sequence[str]] = 0,
                      wire=None, residual: Optional[torch.Tensor] = None):
    """The SUM of ``x`` over the world in two levels, equal in value to
    a flat all-reduce (exactly where the sums' order does not matter,
    to the wire's quantization otherwise). ``block``: ranks per inner
    domain (0: ``local_size()``), or the axes of the world's mesh
    (``("dcn", "ici")``: the two-axis form, :func:`axes_block`). ``wire``: the outer leg's
    ``WireSpec`` (None: full precision). ``residual`` (int8 error
    feedback): float32 of ``x``'s shape, whose head holds this rank's
    shard residual; the call then returns ``(y, new_residual)``."""
    finish, err = start_hierarchical_psum(x, block, wire, residual)
    y = finish()
    return y if residual is None else (y, err)


def hierarchical_allgather(x: torch.Tensor,
                           block: Union[int, Sequence[str]] = 0
                           ) -> torch.Tensor:
    """Dim-0 concatenation of every rank's ``x`` in global rank order,
    in two levels: a gather within the inner domain, then one across
    the domains (dim 0 may differ between ranks). ``block`` as in
    :func:`hierarchical_psum`; a domain of one rank, or of every rank,
    gathers in one level."""
    from .collectives import _grouped_allgather_start

    def gather(t, process_set):
        return _grouped_allgather_start([t], process_set,
                                        "allgather")[1]()[0]

    st = _require_init()
    block, _ = _resolve(st.size, block)
    if block in (1, st.size):
        return gather(x, None)
    inner, outer = block_sets(block)
    g = gather(x, inner)
    # the outer gather concatenates the domains in order: global order
    return gather(g, outer)


# -- a world emulated in one process ------------------------------------------

def emulated_hierarchical_psum(xs: Sequence[torch.Tensor], block: int,
                               wire=None, residuals=None):
    """:func:`hierarchical_psum` of ``len(xs)`` ranks' tensors (one
    shape, one device) in one process: the same stages, the exchanges as
    slicing and concatenation. ``block`` must divide the world and be
    below it. Returns ``(ys, new_residuals)``: each rank's sum, and with
    ``residuals`` (one x-shaped float32 buffer a rank) each rank's new
    residual buffer (else None)."""
    _check_wire(wire, None if residuals is None else residuals[0])
    n = len(xs)
    if block <= 1 or block >= n or n % block:
        raise ValueError(f"emulated_hierarchical_psum: block {block} for a "
                         f"world of {n}")
    n_outer = n // block
    like = xs[0]
    flats = [_pad_flat(x.reshape(-1), block) for x in xs]
    k = flats[0].numel() // block
    # inner reduce-scatter: rank r (domain r // block, offset r % block)
    # receives chunk r % block summed over its domain, in rank order
    rs = []
    for r in range(n):
        d, i = divmod(r, block)
        rs.append(stage_inner_reduce([flats[d * block + t][i * k:(i + 1) * k]
                                      for t in range(block)]))
    peers = [[j * block + r % block for j in range(n_outer)]
             for r in range(n)]
    errs: List[Optional[torch.Tensor]] = [None] * n
    if wire is None or wire.kind in ("fp16", "bf16"):
        ar = []
        for r in range(n):
            parts = [rs[p] if wire is None else rs[p].to(wire.wire_dtype)
                     for p in peers[r]]
            ar.append(stage_inner_reduce(parts).to(rs[r].dtype))
    else:
        outs = []
        for r in range(n):
            res = None if residuals is None else \
                residuals[r].reshape(-1)[:k].to(torch.float32).contiguous()
            outs.append(stage_outer_quantize(rs[r].to(torch.float32), res,
                                             wire.block))
        ar = []
        for r in range(n):
            qg = torch.cat([outs[p][0] for p in peers[r]])
            sg = torch.cat([outs[p][1] for p in peers[r]])
            ar.append(stage_outer_accumulate(qg, sg, n_outer, k,
                                             wire.block).to(rs[r].dtype))
            if outs[r][2] is not None:
                errs[r] = _stash_shard_residual(like, outs[r][2], k)
    # inner all-gather: the domain's shards in rank order
    ys = [torch.cat([ar[(r // block) * block + t] for t in range(block)])
          [:like.numel()].reshape(like.shape) for r in range(n)]
    return ys, (errs if residuals is not None else None)
