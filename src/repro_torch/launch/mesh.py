"""The process group of a sharded run (counterpart of
``repro.launch.mesh``).

:func:`init_group` is the counterpart of ``make_host_mesh``: it joins the
default ``torch.distributed`` group and picks the rank's device. The
reference's ``make_production_mesh`` (a 16 x 16 TPU pod) has no
counterpart. Importing this module touches no device and no group.
"""
from __future__ import annotations

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
