"""The device mesh: named axes over the world's ranks.

The counterpart of the JAX package's ``parallel/mesh.py``, without
JAX. The JAX package hands XLA a ``Mesh`` of devices; the port's world
is processes, one card each, so its :class:`Mesh` is a row-major grid
over the ranks. Axis vocabulary (canonical order, :data:`AXIS_ORDER`):

  pp    pipeline parallel
  dp    pure data parallel (parameters replicated)
  fsdp  data parallel with parameter sharding (ZeRO-3 style)
  sp    sequence/context parallel (ring attention / Ulysses)
  ep    expert parallel (MoE all-to-all)
  tp    tensor parallel (attention heads / MLP width), innermost

:func:`make_mesh` lays the axes out in that order, tp innermost, as the
JAX package's device array is; a ``HOROVOD_MESH`` spec (``"dp=2,tp=2"``,
:func:`parse_mesh_spec`) keeps the order it names its axes in, as the
JAX package's ``init`` does. A rank's coordinate on each axis is its
position in that grid.

A mesh built over an initialized world is *bound* (:meth:`Mesh.bind`):
each live axis (size > 1) has a process set for every slice of it (the
ranks that differ only along that axis), registered on every rank in
the same order (``add_process_set`` is collective). :meth:`Mesh.comm`
is this rank's communicator over an axis (``parallel/comm.py``), and
:meth:`Mesh.process_set` its slice's process set, the world's group
when the slice is the whole world. A mesh may instead carry the
communicators of an in-process emulation of its ranks
(``comm.ThreadWorld``), for a world emulated on one card.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

AXIS_ORDER = ("pp", "dp", "fsdp", "sp", "ep", "tp")

#: the axes the batch's rows are split over
DATA_AXES = ("dp", "fsdp")


def parse_mesh_spec(spec: str, n: int) -> Tuple[Tuple[int, ...],
                                                 Tuple[str, ...]]:
    """``"dp=4,tp=2"`` -> ``(shape, axis_names)`` over ``n`` ranks; one
    dimension may be ``-1`` (the rest of the ranks). The JAX package's
    ``core/basics._parse_mesh_spec``, with its errors."""
    shape, names = [], []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, dim = part.partition("=")
        names.append(name.strip())
        shape.append(-1 if dim == "-1" else int(dim))
    if shape.count(-1) > 1:
        raise ValueError(f"at most one -1 dimension in mesh spec {spec!r}")
    known = math.prod(d for d in shape if d != -1) if shape else 1
    if -1 in shape:
        if n % known:
            raise ValueError(
                f"mesh spec {spec!r} does not divide {n} devices")
        shape[shape.index(-1)] = n // known
    elif math.prod(shape) != n:
        raise ValueError(
            f"mesh spec {spec!r} has {math.prod(shape)} devices, "
            f"but {n} are available")
    return tuple(shape), tuple(names)


class Mesh:
    """A row-major grid of ``math.prod(shape)`` ranks with named axes
    (the last axis varies fastest); ``rank`` is this process's rank in
    it. ``comms`` (axis -> communicator) stands in for the process
    groups of live axes in an emulated world."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int],
                 rank: int = 0, comms: Optional[Dict[str, object]] = None):
        self.axis_names = tuple(axis_names)
        self.shape = tuple(int(s) for s in shape)
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"axis names {self.axis_names} and shape "
                             f"{self.shape} differ in length")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated mesh axis in {self.axis_names}")
        if any(s < 1 for s in self.shape):
            raise ValueError(f"mesh shape {self.shape} has an empty axis")
        self.size = math.prod(self.shape)
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = int(rank)
        self.coords = self.coords_of(self.rank)
        self._comms = dict(comms or {})
        self._sets: Dict[Tuple[str, ...], object] = {}
        self.bound = bool(comms)

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={s}" for a, s in zip(self.axis_names,
                                                     self.shape))
        return f"Mesh({axes}; rank {self.rank})"

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    def axis_size(self, axis: str) -> int:
        """The size of ``axis`` (1 for an axis the mesh does not name)."""
        return self.sizes.get(axis, 1)

    def coord(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (0 for an absent axis)."""
        return self.coords.get(axis, 0)

    @property
    def emulated(self) -> bool:
        """Whether the live axes run over the communicators of an
        in-process emulation (no process groups behind them)."""
        return bool(self._comms)

    def live_axes(self) -> Tuple[str, ...]:
        """The axes of size > 1, in the mesh's order."""
        return tuple(a for a, s in zip(self.axis_names, self.shape) if s > 1)

    def coords_of(self, rank: int) -> Dict[str, int]:
        out, rest = {}, rank
        for name, s in reversed(list(zip(self.axis_names, self.shape))):
            out[name] = rest % s
            rest //= s
        return {a: out[a] for a in self.axis_names}

    def rank_of(self, coords: Dict[str, int]) -> int:
        r = 0
        for name, s in zip(self.axis_names, self.shape):
            r = r * s + coords.get(name, 0)
        return r

    def group_index(self, axes: Iterable[str],
                    rank: Optional[int] = None) -> int:
        """``rank``'s (default: this rank's) row-major position within
        its slice along ``axes`` (taken in the order given)."""
        coords = self.coords if rank is None else self.coords_of(rank)
        i = 0
        for a in axes:
            i = i * self.axis_size(a) + coords.get(a, 0)
        return i

    def slice_ranks(self, axes: Iterable[str],
                    rank: Optional[int] = None) -> List[int]:
        """The ranks that differ from ``rank`` only along ``axes``,
        ordered by their position along them (mesh order)."""
        axes = set(axes)
        base = self.coords if rank is None else self.coords_of(rank)
        return [r for r in range(self.size)
                if all(c == base[a] for a, c in self.coords_of(r).items()
                       if a not in axes)]

    def slices(self, axes: Iterable[str]) -> List[List[int]]:
        """Every slice along ``axes``, in order of its first rank."""
        axes = tuple(axes)
        seen, out = set(), []
        for r in range(self.size):
            if r not in seen:
                s = self.slice_ranks(axes, r)
                seen.update(s)
                out.append(s)
        return out

    # -- process groups --------------------------------------------------

    def bind(self) -> "Mesh":
        """Register a process set for every slice of every live axis, on
        every rank in the same order (collective: every rank of the
        world binds the same mesh). The mesh must span the initialized
        world."""
        if self.bound:
            return self
        from ..core.basics import _require_init

        st = _require_init()
        if self.size != st.size or self.rank != st.rank:
            raise ValueError(
                f"{self!r} does not match the world (rank {st.rank} of "
                f"{st.size}); build it over the initialized world")
        for axis in self.live_axes():
            self._register((axis,))
        self.bound = True
        return self

    def _register(self, axes: Tuple[str, ...]):
        from ..core.process_sets import add_or_get_process_set
        from ..core.state import global_state

        mine = None
        world = global_state().size
        for ranks in self.slices(axes):
            ps = (None if len(ranks) == world
                  else add_or_get_process_set(ranks))
            if self.rank in ranks:
                mine = ps
        self._sets[axes] = mine
        return mine

    def process_set(self, axes: Sequence[str]):
        """This rank's slice along ``axes`` as a registered process set
        (None: the slice is the whole world, the world's group). Axes
        other than one live axis register their slices now, which is
        collective."""
        axes = tuple(a for a in self.axis_names if a in set(axes))
        if not self.bound:
            raise ValueError(f"{self!r} is not bound to a world; "
                             "Mesh.bind() it first")
        if self._comms:
            if any(self.axis_size(a) > 1 for a in axes):
                raise ValueError(f"an emulated mesh has no process set "
                                 f"over {axes}")
            return None  # each emulated rank alone: the world of one
        if axes not in self._sets:
            self._register(axes)
        return self._sets[axes]

    def comm(self, axis: str):
        """This rank's communicator over ``axis`` (``parallel/comm.py``),
        None when the axis has size 1."""
        if self.axis_size(axis) == 1:
            return None
        if axis in self._comms:
            return self._comms[axis]
        from .comm import GroupComm

        return GroupComm(self.process_set((axis,)))


def make_mesh(dp: int = 0, fsdp: int = 1, tp: int = 1, sp: int = 1,
              ep: int = 1, pp: int = 1, world: Optional[int] = None,
              rank: Optional[int] = None) -> Mesh:
    """A :class:`Mesh` over the world with the requested axis sizes, in
    :data:`AXIS_ORDER` (tp innermost). ``dp=0`` (default) means what is
    left: dp absorbs the ranks the explicit axes leave. Without
    ``world`` the mesh spans the initialized world and is bound (every
    rank must build it); with ``world`` (and ``rank``, default 0) it is
    a layout only."""
    bind = world is None
    if bind:
        from ..core.basics import _require_init

        st = _require_init()
        world, rank = st.size, st.rank
    sizes = {"pp": pp, "dp": dp, "fsdp": fsdp, "sp": sp, "ep": ep, "tp": tp}
    explicit = math.prod(v for v in sizes.values() if v > 0)
    if dp == 0:
        if world % explicit:
            raise ValueError(
                f"explicit axes {sizes} (product {explicit}) do not divide "
                f"{world} devices")
        sizes["dp"] = world // explicit
    total = math.prod(sizes.values())
    if total != world:
        raise ValueError(f"mesh {sizes} needs {total} devices, have {world}")
    mesh = Mesh(AXIS_ORDER, [sizes[a] for a in AXIS_ORDER], rank or 0)
    return mesh.bind() if bind else mesh


def mesh_from_spec(spec: str, world: int, rank: int = 0) -> Mesh:
    """The unbound :class:`Mesh` a ``HOROVOD_MESH`` spec names over
    ``world`` ranks; an empty spec is one ``dp`` axis over them."""
    if not spec.strip():
        return Mesh(("dp",), (world,), rank)
    shape, names = parse_mesh_spec(spec, world)
    return Mesh(names, shape, rank)


def emulated_meshes(layout: Mesh, timeout: float = 600.0):
    """``layout``'s ranks emulated in one process: every slice of every
    live axis a ``comm.ThreadWorld``, and each rank's :class:`Mesh`
    carrying, on each live axis, a ``comm.ThreadComm`` of its slice.
    Returns ``(meshes, worlds)``, a mesh a rank; run the ranks with
    ``comm.run_ranks(worlds, fn, layout.size)``. An emulated mesh has no
    process sets."""
    from .comm import ThreadComm, ThreadWorld

    comms: List[Dict[str, object]] = [{} for _ in range(layout.size)]
    worlds = []
    for axis in layout.live_axes():
        for ranks in layout.slices((axis,)):
            world = ThreadWorld(len(ranks), timeout=timeout)
            worlds.append(world)
            for i, r in enumerate(ranks):
                comms[r][axis] = ThreadComm(world, i)
    meshes = [Mesh(layout.axis_names, layout.shape, r, comms=comms[r])
              for r in range(layout.size)]
    return meshes, worlds


def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Mesh axes of size > 1 over which the batch is sharded (the
    gradient-reduction world); empty if neither dp nor fsdp is present
    with extent."""
    return tuple(a for a in DATA_AXES if mesh.axis_size(a) > 1)
