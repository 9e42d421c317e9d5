"""The collectives of the LM substrate's mesh, and the gradient rule of
each (the port's own module: the reference leaves them to GSPMD and
``shard_map``).

The mesh computes as the reference's partition rules say (Megatron-style
tensor parallelism, sequence parallelism, expert parallelism): a unit's
weights stay on their blocks over "model" and the activations move. Two
kinds of value meet there. A *replicated* value is the same on every rank
of the model group, and each rank's autograd computes its whole gradient;
a rank's *partial* work (its heads, its columns of the FFN, its block of
the vocabulary, its experts) gives each rank part of a gradient, which the
rule at the region's edge sums. So:

  * :func:`gather_seq` (every rank's block -> the whole, which each rank
    then uses for its own part of the work: the sequence-parallel carry at
    a unit's products, Mamba's B / C columns) has the backward
    reduce-scatter, a sum;
  * :func:`scatter_seq` (a row-parallel product's partial sums -> this
    rank's block of their sum over the sequence) has the backward
    all-gather;
  * :func:`sum_over` (partial sums -> their replicated sum, where the
    sequence does not split: decode) has the backward identity;
  * :func:`exchange` moves the columns of a weight's block that another
    rank's heads read (K / V heads that a block cuts, the half of a q head
    a block cuts) to that rank; the backward sends their gradients back
    and sums them onto the block;
  * :func:`slice_block` (a replicated value -> this rank's block) has the
    backward all-gather;
  * :func:`gather_blocks` (every rank's block -> the replicated whole, on
    which every rank does the same work) has the backward take-my-block,
    not a sum (a sum would multiply by the axis's size);
  * :func:`copy_to` (a replicated value entering partial work: a norm on
    the sequence-parallel carry, the router, a leaf that each rank reads
    for its own heads) is the identity with the backward sum over the
    axis;
  * :func:`all_to_all` has the reverse all-to-all as its backward;
  * :func:`mean_over` (the loss: the mean over "data" of the blocks'
    means) divides the gradient by the axis's size;
  * :func:`gather_param` assembles a parameter from its blocks before
    use: the blocks over "data" are joined (backward: the gradient summed
    over "data" and my block taken), a unit leaf that the reference's FSDP
    gives to one data rank is broadcast from it (backward: the gradient
    summed onto it), a leaf whole on every data rank is copied (backward:
    the gradient summed over "data"), and the blocks over "model" are
    joined where ``dims`` names that axis (backward: take my block). The
    mesh's layers name it for no weight: a unit's weights stay on their
    blocks over "model" (``partition.Gathered``).

Without autograd: :func:`place` cuts a rank's block of a whole tensor,
:func:`gather_whole` joins the blocks again, :func:`all_max` takes the
largest over an axis and :func:`all_to_all_rows` sends a different number
of rows to each rank. Every collective runs over a
:class:`~repro_torch.launch.mesh.Mesh` axis group (``None``: every rank of
the mesh); one of a single rank is skipped. They run on
``launch.collectives`` (under gloo a CUDA tensor goes through pinned host
memory and back, the same staging as the SSSP stepper's ``Comm``; no
sum's order changes from run to run, so a run's bits repeat); ``mesh.stats``, where
set, counts the bytes each collective takes from this rank (``bytes``,
``collectives``), the bytes of its result by the reference's kind
(``by_kind``: a broadcast from a unit leaf's owner counts as an all-gather
of the leaf, a reduce onto it as a reduce-scatter of it, the moves XLA
makes for them under the reference's FSDP; an exchange of columns as a
collective-permute), the bytes of each weight's columns an exchange
brought to this rank by the weight's name (``moved``) and the host seconds
of the all-to-alls, the device synchronised on both sides
(``all_to_all_s``, ``all_to_alls``; not on a fake group, whose tensors may
have no storage).
"""
from __future__ import annotations

import functools
import math

import torch
import torch.distributed as dist

from repro_torch.launch import collectives as coll
from repro_torch.launch.mesh import Mesh


def _group(mesh: Mesh, axis):
    return mesh.group(axis)


def _size(mesh: Mesh, axis) -> int:
    return mesh.size(tuple(mesh.axis_names) if axis is None else axis)


def _count(mesh: Mesh, t: torch.Tensor, kind: str, result_bytes: int) -> None:
    """Count one collective that takes ``t`` from this rank and gives it
    ``result_bytes``, under the reference's ``kind`` (its dry run's
    ``_COLLECTIVES``): the collective the program asks for, however the
    backend stages it."""
    if mesh.stats is not None:
        st = mesh.stats
        st["bytes"] = st.get("bytes", 0) + t.numel() * t.element_size()
        st["collectives"] = st.get("collectives", 0) + 1
    coll.count(mesh.stats, kind, result_bytes)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


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
    n = _size(mesh, axis)
    if n == 1:
        return x
    _count(mesh, x, "all-gather", n * _nbytes(x))
    return _join(coll.all_gather(_group(mesh, axis), mesh.device, x), dim)


def all_reduce(mesh: Mesh, axis, x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over ``axis`` (a new tensor)."""
    if _size(mesh, axis) == 1:
        return x.clone()
    _count(mesh, x, "all-reduce", _nbytes(x))
    return coll.all_reduce(_group(mesh, axis), mesh.device, x)


def reduce_scatter(mesh: Mesh, axis, x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's block on ``dim`` of the sum of ``x`` over ``axis``."""
    n = _size(mesh, axis)
    if n == 1:
        return x.clone()
    _count(mesh, x, "reduce-scatter", _nbytes(x) // n)
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
        _count(mesh, x, "all-gather", _nbytes(x))
    else:
        x = torch.empty(shape, dtype=dtype, device=mesh.device)
        _count(mesh, x[:0], "all-gather", _nbytes(x))
    return coll.broadcast(_group(mesh, axis), mesh.device, x,
                          mesh.global_rank(**{axis: src}))


def reduce_to(mesh: Mesh, axis: str, x: torch.Tensor, dst: int):
    """The sum of ``x`` over ``axis`` on the rank at coordinate ``dst``;
    None elsewhere."""
    if mesh.size(axis) == 1:
        return x.clone()
    _count(mesh, x, "reduce-scatter", _nbytes(x))
    out = coll.reduce(_group(mesh, axis), mesh.device, x,
                      mesh.global_rank(**{axis: dst}))
    return out if mesh.coord(axis) == dst else None


def all_to_all_blocks(mesh: Mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """Block j of ``x``'s axis 0 goes to the rank at coordinate j; block j
    of the result came from it (``all_to_all_single``, equal splits)."""
    n = mesh.size(axis)
    if n == 1:
        return x
    _count(mesh, x, "all-to-all", _nbytes(x))
    rows = x.unflatten(0, (n, -1))
    group = _group(mesh, axis)
    out = coll.clocked(mesh.stats, mesh.device,
                       lambda: coll.all_to_all(group, mesh.device, rows),
                       "all_to_all_s", "all_to_alls", group)
    return out.flatten(0, 1)


def all_max(mesh: Mesh, axis, x: torch.Tensor) -> torch.Tensor:
    """The largest of ``x`` over ``axis``, elementwise (no gradient)."""
    if _size(mesh, axis) == 1:
        return x
    _count(mesh, x, "all-reduce", _nbytes(x))
    return coll.all_reduce(_group(mesh, axis), mesh.device, x.detach(),
                           dist.ReduceOp.MAX)


def all_to_all_rows(mesh: Mesh, axis: str, x: torch.Tensor, send,
                    recv, kind: str = "all-to-all") -> torch.Tensor:
    """Rows of ``x`` (axis 0) to the ranks along ``axis`` in coordinate
    order, ``send[j]`` rows to coordinate j; the result holds ``recv[j]``
    rows from each, in coordinate order. Counted under ``kind``."""
    if mesh.size(axis) == 1:
        return x
    row_bytes = math.prod(x.shape[1:]) * x.element_size()
    _count(mesh, x, kind, int(sum(recv)) * row_bytes)
    return coll.all_to_all_v(_group(mesh, axis), mesh.device, x, send, recv)


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


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return reduce_scatter(mesh, axis, x, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(ctx.mesh, ctx.axis, g, ctx.dim), None, None, None


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(mesh, axis, x)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


@functools.lru_cache(maxsize=None)
def exchange_plan(n: int, coord: int, block: int, need: tuple) -> tuple:
    """What :func:`exchange` moves for the rank at ``coord`` of ``n``, each
    holding ``block`` consecutive indices of a dim (rank j: [j * block,
    (j + 1) * block)), where rank j needs the global indices ``need[j]``
    in that order: ``(own, send, recv, order)``, ``own`` the local indices
    of this rank's needs that it holds, ``send[j]`` the local indices rank
    j needs from it, ``recv[j]`` how many it takes from rank j, ``order``
    the row of ``[own; received in coordinate order]`` each position of
    the result takes."""
    lo = coord * block
    mine = need[coord]
    own = tuple(i - lo for i in mine if i // block == coord)
    send = tuple(tuple(i - lo for i in need[j] if i // block == coord)
                 if j != coord else () for j in range(n))
    recv = tuple(0 if j == coord else sum(1 for i in mine if i // block == j)
                 for j in range(n))
    # where each needed index lands in [own; from rank 0; from rank 1; ...]
    start, at = [len(own)], {}
    for j in range(n):
        start.append(start[-1] + recv[j])
    nxt = {j: start[j] for j in range(n)}
    k = 0
    for i in mine:
        j = i // block
        if j == coord:
            at[i] = k
            k += 1
        else:
            at[i] = nxt[j]
            nxt[j] += 1
    return own, send, recv, tuple(at[i] for i in mine)


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, plan, tag):
        own, send, recv, order = plan
        ctx.mesh, ctx.axis, ctx.dim, ctx.plan = mesh, axis, dim, plan
        ctx.shape = x.shape
        xm = x.movedim(dim, 0)
        dev = x.device
        idx = [torch.tensor(s, dtype=torch.int64, device=dev) for s in send]
        out = all_to_all_rows(mesh, axis, torch.cat(
            [xm.index_select(0, i) for i in idx]), [len(s) for s in send],
            recv, "collective-permute")
        if mesh.stats is not None and tag is not None:
            moved = mesh.stats.setdefault("moved", {})
            moved[tag] = moved.get(tag, 0) + _nbytes(out)
        src = torch.cat([xm.index_select(0, torch.tensor(
            own, dtype=torch.int64, device=dev)), out])
        return src.index_select(0, torch.tensor(
            order, dtype=torch.int64, device=dev)).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        own, send, recv, order = ctx.plan
        dev = g.device
        gm = g.movedim(ctx.dim, 0)
        inv = [0] * len(order)
        for pos, row in enumerate(order):
            inv[row] = pos
        gsrc = gm.index_select(0, torch.tensor(inv, dtype=torch.int64,
                                               device=dev))
        back = all_to_all_rows(ctx.mesh, ctx.axis, gsrc[len(own):], recv,
                               [len(s) for s in send], "collective-permute")
        shape = list(ctx.shape)
        shape[0], shape[ctx.dim] = shape[ctx.dim], shape[0]
        gx = g.new_zeros(shape)
        # the sums in a fixed order: this rank's own use, then each rank's
        gx.index_add_(0, torch.tensor(own, dtype=torch.int64, device=dev),
                      gsrc[:len(own)])
        at = 0
        for s in send:
            if s:
                gx.index_add_(0, torch.tensor(s, dtype=torch.int64,
                                              device=dev),
                              back[at:at + len(s)])
                at += len(s)
        return gx.movedim(0, ctx.dim), None, None, None, None, None


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


def copy_to(mesh: Mesh, axis, x: torch.Tensor):
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


def mean_over(mesh: Mesh, axis, x: torch.Tensor):
    """The mean over ``axis`` of each rank's ``x`` (backward: the gradient
    over the axis's size)."""
    if mesh.size(axis) == 1:
        return x
    return _MeanOver.apply(x, mesh, axis)


def gather_seq(mesh: Mesh, axis: str, x: torch.Tensor, dim: int):
    """The whole of a value whose blocks on ``dim`` lie over ``axis``, as
    the input of each rank's own part of the work (backward: the ranks'
    gradients summed, my block kept)."""
    if mesh.size(axis) == 1:
        return x
    return _GatherBlocks.apply(x, mesh, axis, dim, True)


def scatter_seq(mesh: Mesh, axis: str, x: torch.Tensor, dim: int):
    """This rank's block on ``dim`` of the sum over ``axis`` of each rank's
    partial ``x`` (backward: all-gather)."""
    if mesh.size(axis) == 1:
        return x
    return _ScatterSeq.apply(x, mesh, axis, dim)


def sum_over(mesh: Mesh, axis, x: torch.Tensor):
    """The sum over ``axis`` of each rank's partial ``x``, replicated
    (backward: the identity)."""
    if _size(mesh, axis) == 1:
        return x
    return _SumOver.apply(x, mesh, axis)


def exchange(mesh: Mesh, axis: str, x: torch.Tensor, dim: int, need: tuple,
             tag: str | None = None):
    """The indices ``need[c]`` of ``dim`` (global, in that order) for the
    rank at coordinate c of ``axis``, from ``x``, every rank's block of
    that dim (an all-to-all with split sizes: each rank sends only what
    another needs from it); ``tag`` names the weight in ``mesh.stats``'s
    ``moved``. Backward: the gradients sent back and summed onto the
    blocks, this rank's own use first, then each rank's in coordinate
    order."""
    n = mesh.size(axis)
    if n == 1:
        return x.index_select(dim, torch.tensor(need[0], dtype=torch.int64,
                                                device=x.device))
    plan = exchange_plan(n, mesh.coord(axis), x.shape[dim], need)
    return _Exchange.apply(x, mesh, axis, dim, plan, tag)


def gather_param(mesh: Mesh, x: torch.Tensor, dims: tuple, owner,
                 shape) -> torch.Tensor:
    """A parameter of ``shape`` whole, from this rank's block ``x``:
    ``dims`` names the axis of each dim (None, "data" or "model"),
    ``owner`` the data coordinate that holds the leaf where the reference
    gives a unit stack to "data" (None otherwise). A parameter is whole on
    every "pod" (the reference's FSDP shards over "data" alone), so its
    gradient is also summed over "pod"."""
    pods = tuple(a for a in mesh.axis_names if a not in ("data", "model"))
    if owner is not None or "data" in dims:
        x = copy_to(mesh, pods, x)
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
        x = copy_to(mesh, pods + ("data",), x)
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
