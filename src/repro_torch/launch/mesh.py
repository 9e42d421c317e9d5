"""The process group and the mesh of a sharded run (counterpart of
``repro.launch.mesh``).

:func:`init_group` joins the default ``torch.distributed`` group and picks
the rank's device; :func:`init_mesh`, the counterpart of
``make_host_mesh``, lays the world's ranks out as a ``(data, model)``
:class:`Mesh` with the reference's choice of the model degree and builds
its subgroups. :func:`make_production_mesh` is the reference's production
mesh: 16 x 16 ``(data, model)`` a pod, 2 x 16 x 16 ``(pod, data, model)``
for two, over the default group where it holds that many ranks, else over
a ``"fake"`` group that this process joins as one rank (no peer exists:
its collectives move nothing, which is what a dry run of one rank's step
needs). Importing this module touches no device and no group.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels.config import resolve_device
from repro_torch.launch import collectives as coll

BACKENDS = ("nccl", "gloo")


def _env_int(name: str) -> int | None:
    value = os.environ.get(name)
    return None if value is None else int(value)


def init_group(rank: int | None = None, world_size: int | None = None, *,
               backend: str | None = None, init_method: str | None = None,
               device=None) -> tuple[int, int, torch.device]:
    """Join the default process group; returns ``(rank, world_size,
    device)``.

    ``rank`` and ``world_size`` default to ``torchrun``'s ``RANK`` and
    ``WORLD_SIZE``, ``init_method`` to ``env://`` (``torchrun``'s
    ``MASTER_ADDR`` / ``MASTER_PORT``; a ``file://`` store needs no port).
    ``device`` (None = ``cuda:(LOCAL_RANK or rank) % device_count``) is
    where the rank's entry points run; ``backend`` defaults to ``nccl`` on
    a card and ``gloo`` on the CPU. Raises for NCCL on the CPU, or for
    NCCL with more ranks on this host (``LOCAL_WORLD_SIZE``, else the
    world) than cards: NCCL refuses two ranks on one card, and nothing
    switches backend behind the caller.
    """
    rank = _env_int("RANK") if rank is None else int(rank)
    world_size = (_env_int("WORLD_SIZE") if world_size is None
                  else int(world_size))
    if rank is None or world_size is None:
        raise ValueError(
            "rank and world_size are needed: pass them, or run under "
            "torchrun (RANK, WORLD_SIZE)"
        )
    if not 0 <= rank < world_size:
        raise ValueError(f"rank must be in [0, {world_size}); got {rank}")
    if device is None:
        resolve_device("cuda")  # raises where there is no card
        local = _env_int("LOCAL_RANK")
        device = torch.device(
            "cuda", (rank if local is None else local)
            % torch.cuda.device_count())
    device = resolve_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}; got {backend!r}")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("NCCL needs a CUDA device a rank; use gloo on "
                             "the CPU")
        local_world = _env_int("LOCAL_WORLD_SIZE") or world_size
        cards = torch.cuda.device_count()
        if local_world > cards:
            raise ValueError(
                f"NCCL needs one card a rank: {local_world} ranks on this "
                f"host, {cards} card(s); run them under gloo"
            )
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size)
    return rank, world_size, device


AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")
PRODUCTION_SHAPE = {False: (16, 16), True: (2, 16, 16)}  # by multi_pod


def _axes(axes) -> tuple:
    """``axes`` (None, a name or a tuple of names) as a tuple."""
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


@dataclasses.dataclass(eq=False)
class Mesh:
    """One rank's view of a mesh over the first ``prod(shape)`` ranks of
    the default group, laid out as ``jax.make_mesh`` lays devices out: the
    rank is the row-major index of its coordinates, the last axis fastest
    (on ``(data, model)``, rank ``d * tp + m``).

    ``shape`` (axis -> size, in ``axis_names`` order) and ``axis_names``
    read as the reference's ``Mesh``; ``coords`` is this rank's coordinate
    on each axis, ``groups`` the subgroup of the ranks that differ from it
    on the named axes only: one for each axis (its "model" group shares
    every other coordinate) and, on a mesh of two data axes, one for the
    data axes together (``("pod", "data")``). ``world`` is the group of
    every rank of the mesh, ``device`` where the rank's tensors live.
    ``stats``, a dict or None, counts what the collectives of
    ``sharding.comm`` send from this rank (``bytes``, ``collectives``)
    and the bytes of their results by the reference's kind
    (``by_kind``).
    """

    shape: dict
    rank: int
    coords: dict
    groups: dict
    world: object
    device: torch.device
    stats: dict | None = None
    axis_names: tuple = AXES

    def size(self, axes) -> int:
        """The number of ranks along ``axes`` (a name, a tuple of names or
        None)."""
        out = 1
        for a in _axes(axes):
            out *= self.shape[a]
        return out

    def coord(self, axes) -> int:
        """This rank's index along ``axes``, the first axis most
        significant (as ``NamedSharding`` numbers the blocks)."""
        out = 0
        for a in _axes(axes):
            out = out * self.shape[a] + self.coords[a]
        return out

    def global_rank(self, **coords) -> int:
        """The default group's rank at ``coords`` (this rank's coordinate
        on every axis not given)."""
        at = dict(self.coords, **coords)
        out = 0
        for a in self.axis_names:
            out = out * self.shape[a] + at[a]
        return out

    def group(self, axes):
        """The subgroup along ``axes`` (None: the whole mesh)."""
        axes = _axes(axes)
        if not axes or set(axes) == set(self.axis_names):
            return self.world
        return self.groups[axes[0] if len(axes) == 1 else axes]


def host_tp(n: int, tp: int) -> int:
    """The reference's model degree on ``n`` ranks: ``min(tp, n)``, lowered
    until it divides n."""
    tp = min(tp, n)
    while n % tp:
        tp -= 1
    return tp


def _coords_of(rank: int, shape: tuple) -> tuple:
    out = []
    for n in reversed(shape):
        rank, c = divmod(rank, n)
        out.append(c)
    return tuple(reversed(out))


def _line_groups(shape: tuple, names: tuple, along: tuple, rank: int,
                 own_only: bool):
    """The group of ranks that differ from ``rank`` on the axes ``along``
    only. Every rank of the default group creates every such group (the
    ranks of a real world must all call ``new_group``); ``own_only`` (a
    fake world, which has no peer to agree with) creates only
    ``rank``'s."""
    idx = [names.index(a) for a in along]
    mine = None
    for r in range(int(np.prod(shape))):
        c = _coords_of(r, shape)
        if any(c[i] for i in idx):
            continue  # each line once, from its rank at 0 on ``along``
        line = []
        for offs in np.ndindex(*(shape[i] for i in idx)):
            cc = list(c)
            for i, o in zip(idx, offs):
                cc[i] = o
            line.append(int(np.ravel_multi_index(cc, shape)))
        if own_only and rank not in line:
            continue
        g = dist.new_group(sorted(line))
        if rank in line:
            mine = g
    return mine


def make_mesh_axes(shape: tuple, axis_names: tuple,
                   device=None) -> Mesh | None:
    """A mesh of ``shape`` over ``axis_names`` on ranks ``0 ..
    prod(shape) - 1`` of the default group, which must hold at least that
    many; every rank of a real default group must call it (``new_group``
    is collective), and the ranks past the mesh get None. ``device`` (None
    = the current CUDA device; raises where there is none) is where this
    rank's tensors live."""
    device = resolve_device(device)
    shape, axis_names = tuple(int(n) for n in shape), tuple(axis_names)
    world, rank = dist.get_world_size(), dist.get_rank()
    used = int(np.prod(shape))
    if len(shape) != len(axis_names) or used > world or min(shape) < 1:
        raise ValueError(f"a {shape} mesh over {axis_names} needs {used} "
                         f"ranks; the world has {world}")
    fake = coll.is_fake()  # no peer: create only our groups
    data = tuple(a for a in axis_names if a != "model")
    lines = [(a,) for a in axis_names] + ([data] if len(data) > 1 else [])
    groups = {}
    for along in lines:
        g = _line_groups(shape, axis_names, along, rank, own_only=fake)
        groups[along[0] if len(along) == 1 else along] = g
    whole = dist.new_group(list(range(used)))
    if rank >= used:
        return None
    return Mesh(shape=dict(zip(axis_names, shape)), rank=rank,
                coords=dict(zip(axis_names, _coords_of(rank, shape))),
                groups=groups, world=whole, device=device,
                axis_names=axis_names)


def make_mesh(dp: int, tp: int, device=None) -> Mesh | None:
    """A ``(dp, tp)`` ``(data, model)`` mesh (:func:`make_mesh_axes`); pass
    the device :func:`init_group` returned."""
    if dp < 1 or tp < 1:
        raise ValueError(f"a ({dp}, {tp}) mesh needs positive degrees")
    return make_mesh_axes((dp, tp), AXES, device)


def init_mesh(tp: int = 1, device=None) -> Mesh:
    """The counterpart of ``make_host_mesh``: every rank of the default
    group (:func:`init_group` first) in a ``(n // tp', tp')`` mesh, tp' =
    :func:`host_tp` (n, tp)."""
    n = dist.get_world_size()
    tp = host_tp(n, tp)
    return make_mesh(n // tp, tp, device)


def join_fake_world(world_size: int, rank: int = 0) -> None:
    """Make the default group a ``"fake"`` world of ``world_size`` ranks in
    which this process is ``rank`` (``torch.distributed``'s fake backend:
    every collective returns at once and moves nothing). A fake default
    group of another size or rank is replaced; a real one raises."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if not coll.is_fake():
            raise RuntimeError("a real process group is initialised; a fake "
                               "world would replace it")
        if (dist.get_world_size(), dist.get_rank()) == (world_size, rank):
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False, rank: int = 0,
                         device=None) -> Mesh:
    """The reference's production mesh: ``(16, 16)`` over ``("data",
    "model")``, or with ``multi_pod`` ``(2, 16, 16)`` over ``("pod",
    "data", "model")``. Over the default group when it is a real world of
    exactly that many ranks (every rank calls this; ``rank`` is then the
    group's own); with no group initialised, or a fake one, over a fake
    world that this process joins as ``rank`` (:func:`join_fake_world`).
    Raises where a real group holds another number of ranks: the mesh is
    never shrunk. ``device`` as :func:`make_mesh_axes` takes it."""
    shape = PRODUCTION_SHAPE[bool(multi_pod)]
    names = POD_AXES if multi_pod else AXES
    need = int(np.prod(shape))
    if dist.is_initialized() and not coll.is_fake():
        if dist.get_world_size() != need:
            raise ValueError(f"the production mesh {shape} needs {need} "
                             f"ranks; the default group holds "
                             f"{dist.get_world_size()}")
    else:
        join_fake_world(need, rank)
    return make_mesh_axes(shape, names, device)
