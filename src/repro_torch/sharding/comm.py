"""The collectives of the LM substrate's mesh, and the gradient rule of
each (the port's own module: the reference leaves them to GSPMD and
``shard_map``).

A rank computes most of a unit on the whole of its batch block, the same
on every rank of its model group: those values are *replicated* over
"model", and each rank's autograd computes their whole gradient. So:

  * :func:`slice_block` (a replicated value -> this rank's block) has the
    backward all-gather;
  * :func:`gather_blocks` (every rank's block -> the replicated whole) has
    the backward take-my-block, not a sum (a sum would multiply by the
    axis's size);
  * :func:`copy_to` (a replicated value entering work that differs by
    rank, as the router does in the expert-parallel MoE) is the identity
    with the backward sum over the axis;
  * :func:`all_to_all` has the reverse all-to-all as its backward;
  * :func:`mean_over` (the loss: the mean over "data" of the blocks'
    means) divides the gradient by the axis's size;
  * :func:`gather_param` assembles a parameter from its blocks before use:
    the blocks over "model" are joined (backward: take my block), the
    blocks over "data" are joined (backward: the gradient summed over
    "data" and my block taken), a unit leaf that the reference's FSDP
    gives to one data rank is broadcast from it (backward: the gradient
    summed onto it), and a leaf whole on every data rank is copied
    (backward: the gradient summed over "data").

Without autograd: :func:`place` cuts a rank's block of a whole tensor and
:func:`gather_whole` joins the blocks again. Every collective runs over a
:class:`~repro_torch.launch.mesh.Mesh` axis group (``None``: every rank of
the mesh); one of a single rank is skipped. They run on
``launch.collectives`` (under gloo a CUDA tensor goes through pinned host
memory and back, the same staging as the SSSP stepper's ``Comm``);
``mesh.stats``, where set, counts the bytes
each collective takes from this rank (``bytes``, ``collectives``) and the
host seconds of the all-to-alls, the device synchronised on both sides
(``all_to_all_s``, ``all_to_alls``).
"""
from __future__ import annotations

import torch

from repro_torch.launch import collectives as coll
from repro_torch.launch.mesh import Mesh


def _group(mesh: Mesh, axis):
    return mesh.world if axis is None else mesh.groups[axis]


def _size(mesh: Mesh, axis) -> int:
    return mesh.size(tuple(mesh.axis_names) if axis is None else axis)


def _count(mesh: Mesh, t: torch.Tensor) -> None:
    if mesh.stats is not None:
        mesh.stats["bytes"] = mesh.stats.get("bytes", 0) + (
            t.numel() * t.element_size())
        mesh.stats["collectives"] = mesh.stats.get("collectives", 0) + 1


def _block(t: torch.Tensor, dim: int, parts: int, index: int) -> torch.Tensor:
    n = t.shape[dim] // parts
    return t.narrow(dim, index * n, n)


def _join(parts: torch.Tensor, dim: int) -> torch.Tensor:
    """(n, *shape) rows joined on ``dim`` of ``shape`` in row order."""
    n, shape = parts.shape[0], parts.shape[1:]
    out = shape[:dim] + (n * shape[dim],) + shape[dim + 1:]
    return parts.movedim(0, dim).reshape(out)


# ---------------------------------------------------------------------------
# collectives, no autograd
# ---------------------------------------------------------------------------


def all_gather(mesh: Mesh, axis, x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, joined on ``dim`` in coordinate
    order."""
    if _size(mesh, axis) == 1:
        return x
    _count(mesh, x)
    return _join(coll.all_gather(_group(mesh, axis), mesh.device, x), dim)


def all_reduce(mesh: Mesh, axis, x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over ``axis`` (a new tensor)."""
    if _size(mesh, axis) == 1:
        return x.clone()
    _count(mesh, x)
    return coll.all_reduce(_group(mesh, axis), mesh.device, x)


def reduce_scatter(mesh: Mesh, axis, x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's block on ``dim`` of the sum of ``x`` over ``axis``."""
    n = _size(mesh, axis)
    if n == 1:
        return x.clone()
    _count(mesh, x)
    rows = x.movedim(dim, 0).unflatten(0, (n, -1))
    out = coll.reduce_scatter(_group(mesh, axis), mesh.device, rows)
    return out.movedim(0, dim).contiguous()


def broadcast(mesh: Mesh, axis: str, x: torch.Tensor, src: int,
              shape, dtype) -> torch.Tensor:
    """The tensor of the rank at coordinate ``src`` on ``axis`` (``x`` there;
    any tensor elsewhere), of ``shape`` and ``dtype``, on every rank."""
    if mesh.size(axis) == 1:
        return x
    if mesh.coord(axis) == src:
        _count(mesh, x)
    else:
        x = torch.empty(shape, dtype=dtype, device=mesh.device)
    return coll.broadcast(_group(mesh, axis), mesh.device, x,
                          mesh.global_rank(**{axis: src}))


def reduce_to(mesh: Mesh, axis: str, x: torch.Tensor, dst: int):
    """The sum of ``x`` over ``axis`` on the rank at coordinate ``dst``;
    None elsewhere."""
    if mesh.size(axis) == 1:
        return x.clone()
    _count(mesh, x)
    out = coll.reduce(_group(mesh, axis), mesh.device, x,
                      mesh.global_rank(**{axis: dst}))
    return out if mesh.coord(axis) == dst else None


def all_to_all_blocks(mesh: Mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """Block j of ``x``'s axis 0 goes to the rank at coordinate j; block j
    of the result came from it (``all_to_all_single``, equal splits)."""
    n = mesh.size(axis)
    if n == 1:
        return x
    _count(mesh, x)
    rows = x.unflatten(0, (n, -1))
    out = coll.clocked(mesh.stats, mesh.device, lambda: coll.all_to_all(
        _group(mesh, axis), mesh.device, rows), "all_to_all_s", "all_to_alls")
    return out.flatten(0, 1)


# ---------------------------------------------------------------------------
# the gradient rules
# ---------------------------------------------------------------------------


class _SliceBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _block(x, dim, mesh.size(axis), mesh.coord(axis)).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(ctx.mesh, ctx.axis, g, ctx.dim), None, None, None


class _GatherBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, sum_grad):
        ctx.mesh, ctx.axis, ctx.dim, ctx.sum_grad = mesh, axis, dim, sum_grad
        return all_gather(mesh, axis, x, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.mesh, ctx.axis, ctx.dim
        if ctx.sum_grad:
            out = reduce_scatter(mesh, axis, g, dim)
        else:
            out = _block(g, dim, mesh.size(axis),
                         mesh.coord(axis)).contiguous()
        return out, None, None, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(ctx.mesh, ctx.axis, g), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_to_all_blocks(mesh, axis, x)

    @staticmethod
    def backward(ctx, g):
        return all_to_all_blocks(ctx.mesh, ctx.axis, g), None, None


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.n = mesh.size(axis)
        return all_reduce(mesh, axis, x) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


class _FromOwner(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, owner, shape):
        ctx.mesh, ctx.axis, ctx.owner = mesh, axis, owner
        ctx.empty = x.shape
        return broadcast(mesh, axis, x, owner, shape, x.dtype)

    @staticmethod
    def backward(ctx, g):
        out = reduce_to(ctx.mesh, ctx.axis, g, ctx.owner)
        if out is None:
            out = g.new_zeros(ctx.empty)
        return out, None, None, None, None


def slice_block(mesh: Mesh, axis: str, x: torch.Tensor, dim: int):
    """This rank's block on ``dim`` of a value replicated over ``axis``
    (backward: all-gather)."""
    if mesh.size(axis) == 1:
        return x
    return _SliceBlock.apply(x, mesh, axis, dim)


def gather_blocks(mesh: Mesh, axis: str, x: torch.Tensor, dim: int):
    """The whole of a value whose blocks on ``dim`` lie over ``axis``
    (backward: take my block)."""
    if mesh.size(axis) == 1:
        return x
    return _GatherBlocks.apply(x, mesh, axis, dim, False)


def copy_to(mesh: Mesh, axis: str, x: torch.Tensor):
    """``x`` as the input of work that differs along ``axis`` (backward:
    the gradient summed over it)."""
    if mesh.size(axis) == 1:
        return x
    return _CopyTo.apply(x, mesh, axis)


def all_to_all(mesh: Mesh, axis: str, x: torch.Tensor):
    """:func:`all_to_all_blocks` (backward: the reverse all-to-all)."""
    if mesh.size(axis) == 1:
        return x
    return _AllToAll.apply(x, mesh, axis)


def mean_over(mesh: Mesh, axis: str, x: torch.Tensor):
    """The mean over ``axis`` of each rank's ``x`` (backward: the gradient
    over the axis's size)."""
    if mesh.size(axis) == 1:
        return x
    return _MeanOver.apply(x, mesh, axis)


def gather_param(mesh: Mesh, x: torch.Tensor, dims: tuple, owner,
                 shape) -> torch.Tensor:
    """A parameter of ``shape`` whole, from this rank's block ``x``:
    ``dims`` names the axis of each dim (None, "data" or "model"),
    ``owner`` the data coordinate that holds the leaf where the reference
    gives a unit stack to "data" (None otherwise)."""
    if owner is not None:
        local = list(shape)
        for i, a in enumerate(dims):
            if a is not None:
                local[i] //= mesh.size(a)
        if mesh.size("data") > 1:
            x = _FromOwner.apply(x, mesh, "data", owner, tuple(local))
    elif "data" in dims:
        if mesh.size("data") > 1:
            x = _GatherBlocks.apply(x, mesh, "data", dims.index("data"), True)
    else:
        x = copy_to(mesh, "data", x)
    if "model" in dims:
        x = gather_blocks(mesh, "model", x, dims.index("model"))
    return x


# ---------------------------------------------------------------------------
# placement, no autograd
# ---------------------------------------------------------------------------


def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def place(mesh: Mesh, x: torch.Tensor, dims: tuple) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` under ``dims`` (one
    entry a dim: None, an axis name, or a tuple of names whose product
    numbers the blocks), as a copy on the mesh's device."""
    for i, entry in enumerate(dims):
        axes = _axes_of(entry)
        if axes:
            n = mesh.size(axes)
            if x.shape[i] % n:
                raise ValueError(f"dim {i} of {tuple(x.shape)} does not "
                                 f"divide over {axes} ({n} ranks)")
            x = _block(x, i, n, mesh.coord(axes))
    return x.to(mesh.device, copy=True).contiguous()


def gather_whole(mesh: Mesh, x: torch.Tensor, dims: tuple) -> torch.Tensor:
    """The whole tensor from every rank's block ``x`` under ``dims``
    (:func:`place`'s inverse), on every rank."""
    for i, entry in enumerate(dims):
        for a in reversed(_axes_of(entry)):
            x = all_gather(mesh, a, x, i)
    return x
