"""The collectives of the port's sharded paths over ``torch.distributed``:
the SSSP stepper's (``core.distributed.Comm``) and the LM mesh's
(``sharding.comm``). Each runs over a group for tensors on the rank's
device and returns a new tensor there; its input is never written.

Gloo carries host tensors only. Where it meets a CUDA tensor the
collective is staged: it runs on pinned host buffers (the fast copy each
way) of at most :data:`STAGE_BYTES` each, one block of columns at a time,
so the host holds a few such buffers however large the tensor. Gloo's own
``all_gather`` and its sum-then-slice run well behind its
``all_to_all_single`` on the same bytes, so over gloo a gather sends its
rows as an all-to-all, and a reduce-scatter is an all-to-all and a local
sum (the rows in rank order). NCCL runs its own collectives on the card.
A ``"fake"`` group (``launch.mesh.join_fake_world``: one rank of a world
that does not exist) moves nothing: each collective returns at once, an
in-place one with the rank's own input, the others unwritten.

:data:`KINDS` are the reference's names of the collectives (its dry run's
``_COLLECTIVES``), under which the callers count what they ask for.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.obs.timer import now

STAGE_BYTES = 64 << 20  # the most one pinned staging buffer holds
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


def is_fake(group=None) -> bool:
    """Whether ``group`` (None: the default group) is the ``"fake"``
    backend's."""
    return dist.get_backend(group) == "fake"


def count(stats: dict | None, kind: str, nbytes: int) -> None:
    """Add one collective's result bytes to ``stats["by_kind"][kind]``
    (one of :data:`KINDS`); None counts nothing."""
    if stats is not None:
        by_kind = stats.setdefault("by_kind", dict.fromkeys(KINDS, 0))
        by_kind[kind] += int(nbytes)


def staged(group, device: torch.device) -> bool:
    """Whether a collective over ``group`` takes ``device``'s tensors
    through host memory: gloo with a CUDA device."""
    return device.type == "cuda" and dist.get_backend(group) == "gloo"


def _run(fn, src: torch.Tensor, rows: int, group, device: torch.device,
         inplace: bool = False) -> torch.Tensor:
    """``fn(send, recv)``, one collective over ``group``, on ``src``: a
    (k, L) tensor or view, -> its (rows, L) result on ``device``.
    ``inplace``: ``fn`` writes ``send`` itself (``recv`` is ``send`` and
    rows == k)."""
    src = src.detach()
    k, length = src.shape
    if is_fake(group):
        src = src.to(device)
        if inplace:
            return src.clone(memory_format=torch.contiguous_format)
        return torch.empty((rows, length), dtype=src.dtype, device=device)
    if not staged(group, device):
        src = src.to(device)
        if inplace:
            send = src.clone(memory_format=torch.contiguous_format)
            fn(send, send)
            return send
        recv = torch.empty((rows, length), dtype=src.dtype, device=device)
        fn(src.contiguous(), recv)
        return recv
    out = torch.empty((rows, length), dtype=src.dtype, device=device)
    step = max(1, STAGE_BYTES // (max(k, rows, 1) * src.element_size()))
    for lo in range(0, length, step):
        hi = min(lo + step, length)
        send = torch.empty((k, hi - lo), dtype=src.dtype, pin_memory=True)
        send.copy_(src[:, lo:hi])
        recv = send if inplace else torch.empty(
            (rows, hi - lo), dtype=src.dtype, pin_memory=True)
        fn(send, recv)
        out[:, lo:hi].copy_(recv)
    return out


def _gloo(group) -> bool:
    return dist.get_backend(group) == "gloo"


def all_reduce(group, device, x: torch.Tensor, op=dist.ReduceOp.SUM):
    """``op`` over ``group`` of every rank's ``x``."""
    out = _run(lambda s, r: dist.all_reduce(s, op=op, group=group),
               x.reshape(1, -1), 1, group, device, inplace=True)
    return out.view(x.shape)


def all_gather(group, device, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` in rank order: ``(n, *x.shape)``."""
    n = dist.get_world_size(group)
    flat = x.reshape(1, -1)
    if _gloo(group):
        out = _run(lambda s, r: dist.all_to_all_single(r, s, group=group),
                   flat.expand(n, -1), n, group, device)
    else:
        out = _run(lambda s, r: dist.all_gather_into_tensor(
            r, s, group=group), flat, n, group, device)
    return out.view((n,) + tuple(x.shape))


def all_to_all(group, device, x: torch.Tensor) -> torch.Tensor:
    """Row j of ``x`` (axis 0, one row a rank) goes to rank j; row j of
    the result came from it."""
    n = x.shape[0]
    out = _run(lambda s, r: dist.all_to_all_single(r, s, group=group),
               x.reshape(n, -1), n, group, device)
    return out.view(x.shape)


def all_to_all_v(group, device, x: torch.Tensor, send: list,
                 recv: list) -> torch.Tensor:
    """Rows of ``x`` (axis 0) to the ranks of ``group`` in rank order,
    ``send[j]`` rows to rank j; the result holds ``recv[j]`` rows from each
    rank j, in rank order (``all_to_all_single`` with split sizes; a rank
    may send or take none)."""
    rows = int(sum(recv))
    flat = x.reshape(x.shape[0], math.prod(x.shape[1:]))
    out = _run(lambda s, r: dist.all_to_all_single(
        r, s, output_split_sizes=list(recv), input_split_sizes=list(send),
        group=group), flat, rows, group, device)
    return out.view((rows,) + tuple(x.shape[1:]))


def reduce_scatter(group, device, x: torch.Tensor) -> torch.Tensor:
    """This rank's row of the sum over ``group`` of every rank's ``x``
    (axis 0, one row a rank)."""
    n = x.shape[0]
    if _gloo(group):
        return all_to_all(group, device, x).sum(dim=0)
    out = _run(lambda s, r: dist.reduce_scatter_tensor(r, s, group=group),
               x.reshape(n, -1), 1, group, device)
    return out.view(x.shape[1:])


def broadcast(group, device, x: torch.Tensor, src: int) -> torch.Tensor:
    """Global rank ``src``'s ``x`` on every rank (elsewhere ``x`` is any
    tensor of its shape and dtype)."""
    out = _run(lambda s, r: dist.broadcast(s, src=src, group=group),
               x.reshape(1, -1), 1, group, device, inplace=True)
    return out.view(x.shape)


def reduce(group, device, x: torch.Tensor, dst: int) -> torch.Tensor:
    """The sum of every rank's ``x`` on global rank ``dst`` (elsewhere a
    tensor of no meaning)."""
    out = _run(lambda s, r: dist.reduce(s, dst=dst, group=group),
               x.reshape(1, -1), 1, group, device, inplace=True)
    return out.view(x.shape)


def clocked(stats: dict | None, device: torch.device, fn, seconds: str,
            calls: str, group=None):
    """``fn()``, a collective over ``group``; where ``stats`` is a dict,
    the host seconds around it (the device synchronised on both sides, but
    on a fake group, whose tensors may have no storage) added to
    ``stats[seconds]`` and one to ``stats[calls]``. None times nothing and
    adds no sync."""
    if stats is None:
        return fn()
    cuda = device.type == "cuda" and not is_fake(group)
    if cuda:
        torch.cuda.synchronize(device)
    t0 = now()
    out = fn()
    if cuda:
        torch.cuda.synchronize(device)
    stats[seconds] = stats.get(seconds, 0.0) + now() - t0
    stats[calls] = stats.get(calls, 0) + 1
    return out
