"""The process group and the mesh of a sharded run (counterpart of
``repro.launch.mesh``).

:func:`init_group` joins the default ``torch.distributed`` group and picks
the rank's device; :func:`init_mesh`, the counterpart of
``make_host_mesh``, lays the world's ranks out as a ``(data, model)``
:class:`Mesh` with the reference's choice of the model degree and builds
its subgroups. The reference's ``make_production_mesh`` (a 16 x 16 TPU pod)
has no counterpart. Importing this module touches no device and no group.
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from repro_torch.kernels.config import resolve_device

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


@dataclasses.dataclass(eq=False)
class Mesh:
    """One rank's view of a ``(data, model)`` mesh over the first
    ``dp * tp`` ranks of the default group, laid out as ``jax.make_mesh``
    lays devices out: rank ``d * tp + m`` sits at data coordinate d and
    model coordinate m.

    ``shape`` and ``axis_names`` read as the reference's ``Mesh``;
    ``coords`` is this rank's coordinate on each axis, ``groups`` the
    subgroup of the ranks that differ from it on that axis only (its
    "model" group shares its data coordinate), ``world`` the group of every
    rank of the mesh, ``device`` where the rank's tensors live. ``stats``,
    a dict or None, counts what the collectives of ``sharding.comm`` send
    from this rank: ``bytes`` and ``collectives``.
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
        if axes is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        out = 1
        for a in axes:
            out *= self.shape[a]
        return out

    def coord(self, axes) -> int:
        """This rank's index along ``axes``, the first axis most
        significant (as ``NamedSharding`` numbers the blocks)."""
        if axes is None:
            return 0
        if isinstance(axes, str):
            axes = (axes,)
        out = 0
        for a in axes:
            out = out * self.shape[a] + self.coords[a]
        return out

    def global_rank(self, **coords) -> int:
        """The default group's rank at ``coords`` (this rank's coordinate
        on every axis not given)."""
        at = dict(self.coords, **coords)
        return at["data"] * self.shape["model"] + at["model"]


def host_tp(n: int, tp: int) -> int:
    """The reference's model degree on ``n`` ranks: ``min(tp, n)``, lowered
    until it divides n."""
    tp = min(tp, n)
    while n % tp:
        tp -= 1
    return tp


def make_mesh(dp: int, tp: int, device=None) -> Mesh | None:
    """A ``(dp, tp)`` mesh over ranks ``0 .. dp*tp - 1`` of the default
    group, which must hold at least that many; every rank of the default
    group must call it (``new_group`` is collective), and the ranks past
    the mesh get None. ``device`` (None = the current CUDA device; raises
    where there is none) is where this rank's tensors live: pass the one
    :func:`init_group` returned."""
    device = resolve_device(device)
    world, rank = dist.get_world_size(), dist.get_rank()
    used = dp * tp
    if used > world or dp < 1 or tp < 1:
        raise ValueError(f"a ({dp}, {tp}) mesh needs {used} ranks; the "
                         f"world has {world}")
    data_groups = [dist.new_group([d * tp + m for d in range(dp)])
                   for m in range(tp)]
    model_groups = [dist.new_group([d * tp + m for m in range(tp)])
                    for d in range(dp)]
    whole = dist.new_group(list(range(used)))
    if rank >= used:
        return None
    d, m = divmod(rank, tp)
    return Mesh(shape={"data": dp, "model": tp}, rank=rank,
                coords={"data": d, "model": m},
                groups={"data": data_groups[m], "model": model_groups[d]},
                world=whole, device=device)


def init_mesh(tp: int = 1, device=None) -> Mesh:
    """The counterpart of ``make_host_mesh``: every rank of the default
    group (:func:`init_group` first) in a ``(n // tp', tp')`` mesh, tp' =
    :func:`host_tp` (n, tp)."""
    n = dist.get_world_size()
    tp = host_tp(n, tp)
    return make_mesh(n // tp, tp, device)
