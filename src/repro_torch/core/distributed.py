"""Distributed phased SSSP over ``torch.distributed`` (counterpart of
``repro.core.distributed``).

Each rank of a process group holds one vertex block, as one device of the
reference's mesh does: rank r owns vertices ``[r * n_loc, (r + 1) *
n_loc)``. The reference's ``mesh, axes`` become ``group`` (None = the
default world) and ``num_shards`` is the group's size. Every entry point
is SPMD: each rank calls it with the same arguments, and the collectives
keep the ranks in lockstep.

  reference (P devices, shard_map)       | here (P ranks)
  ---------------------------------------+---------------------------------
  lax.pmin / lax.psum                    | dist.all_reduce (MIN / SUM)
  all_to_all of (P, B, n_loc) blocks     | dist.all_to_all_single
  shard-local jax.ops.segment_min        | the rectangular push (#1b,
                                         |   ``ell_push_rect_batch``) along
                                         |   the rank's outgoing view
  jnp.min / jnp.sum over the block       | #2 (``frontier_crit_lanes_batch``)
  lax.while_loop                         | a host loop, one sync a trip

Both exchange schedules are the reference's: ``allreduce`` reduces the
``(R, n_pad)`` candidates and every rank slices its block;
``reduce_scatter`` sends each rank its ``(R, n_loc)`` block of every
other rank's candidates and folds them locally. Neither gloo nor NCCL
promises which zero a float MIN keeps, so every MIN, the ``(L, B)``
thresholds included, runs on an order-preserving int32 image of the f32
bits (:func:`_ordered`) in which -0 < +0, the reference's rule; NaN never
reaches them (``from_coo`` rejects NaN weights and the stepper's minima
are of finite or +inf values). Counts are reduced as int64 SUM. Every
collective runs through ``launch.collectives``, which stages gloo's CUDA
tensors through pinned host memory explicitly.

Two generations of the engine, as in the reference:

  * the **legacy single-query program** (:func:`shard_graph` +
    :func:`make_distributed_sssp`), the B = 1 bit-exactness reference;
  * the **sharded batch stepper** (:class:`ShardedBatchState` +
    :func:`shard_graph_batch` / :func:`init_sharded_batch_state` /
    :func:`step_sharded_batch` / :func:`reset_sharded_lanes` /
    :func:`harvest_sharded`), the twin of ``core.static_engine``'s stepper,
    with every criterion plan. Dynamic keys are recomputed each phase from
    status: the in-side ones ride the forward partition (gate at the
    source's owner, key at the target's owner), the out-side ones the
    transpose partition; the dependent ``out_full`` takes its own pass
    after ``out_dyn`` is exchanged. A side's independent keys are stacked
    as lanes of one push, and both sides' share one exchange (the
    reference makes one exchange a key; a min is elementwise, so the bits
    are the same).

Each rank keeps only its own row of the reference's stacked ``(P, E_loc)``
edge arrays (the COO fields the plain path and the tests read), plus a
rank-local outgoing ELL: ``n_loc`` rows of owned vertices, out-edges
left-packed, global target ids in ``[0, n_pad)`` and the sentinel
``n_pad``. ``use_kernels=False`` runs the plain path: the shard-local
scans as the reference's ``segment_min`` over the COO row
(``ref.push_coo_batch_ref``) and #2's twin; the same bits.

What differs from the reference: counters are int64 (no limbs); the trip
loop runs on the host and every rank reads the same reduced ``go``;
entry points run on ``cuda:(rank % device_count)`` unless the caller
passes a device, and never fall back to the CPU or to another backend.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import criteria as C
from repro_torch.core.graph import Graph, _build_ell, graph_device
from repro_torch.core.static_engine import (
    DEFAULT_CRITERION,
    EMPTY_LANE,
    KEEP_LANE,
    BatchedResult,
    validate_sources,
)
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.config import resolve_device
from repro_torch.kernels.ell_relax import ell_push_rect_batch
from repro_torch.launch import collectives as coll

INF = float("inf")
SCHEDULES = ("allreduce", "reduce_scatter")
_SIGN_OFF = 0x7FFFFFFF  # flips an f32's magnitude bits


# ---------------------------------------------------------------------------
# The process group and its collectives
# ---------------------------------------------------------------------------


def group_rank_size(group=None) -> tuple[int, int]:
    """(this process's rank in ``group``, the group's size); raises when no
    process group is initialised (``repro_torch.launch.mesh.init_group``)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "the sharded stepper needs an initialised torch.distributed "
            "process group (repro_torch.launch.mesh.init_group)"
        )
    return dist.get_rank(group), dist.get_world_size(group)


def rank_device(group=None, device=None) -> torch.device:
    """The device a rank's entry points run on: ``device`` if given, else
    ``cuda:(global rank % device_count)`` (raises where there is no card:
    nothing falls back to the CPU)."""
    if device is not None:
        return resolve_device(device)
    group_rank_size(group)
    resolve_device("cuda")
    return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())


def _ordered(x: torch.Tensor) -> torch.Tensor:
    """The int32 image of f32 ``x`` that orders as the floats do, with
    -0 < +0 (a negative float's magnitude bits flipped)."""
    i = x.contiguous().view(torch.int32)
    return torch.where(i < 0, i ^ _SIGN_OFF, i)


def _from_ordered(i: torch.Tensor) -> torch.Tensor:
    """The f32 values of an :func:`_ordered` image (the map is its own
    inverse)."""
    return torch.where(i < 0, i ^ _SIGN_OFF, i).contiguous().view(
        torch.float32)


class Comm:
    """One rank's collectives over ``group`` for tensors on ``device``.

    ``stats``, a dict or None, gets ``exchange_s`` (host seconds around the
    collectives, the device synchronised on both sides) and
    ``collectives`` added, and under ``by_kind`` the bytes of each
    collective's result by the reference's kind (``launch.collectives.
    KINDS``: its MINs and SUMs are all-reduces, the ``reduce_scatter``
    schedule's exchange an all-to-all, as the reference writes them); None
    times nothing and adds no sync. Raises for NCCL with a CPU device:
    nothing switches backend behind the caller.
    """

    def __init__(self, group, device: torch.device, stats: dict | None = None):
        self.group = group
        self.rank, self.size = group_rank_size(group)
        self.backend = dist.get_backend(group)
        if self.backend == "nccl" and device.type != "cuda":
            raise ValueError(
                f"NCCL moves CUDA tensors only; the rank's device is {device} "
                "(use the gloo backend on the CPU)"
            )
        self.device = device
        # gloo reduces on the host: CUDA tensors go there and back
        self.staged = coll.staged(group, device)
        self.stats = stats
        self.src0 = 0 if group is None else dist.get_global_rank(group, 0)

    def _clocked(self, fn, kind: str, result_bytes: int):
        coll.count(self.stats, kind, result_bytes)
        return coll.clocked(self.stats, self.device, fn, "exchange_s",
                            "collectives", self.group)

    def all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        """``op`` over the group of ``t``."""
        return self._clocked(
            lambda: coll.all_reduce(self.group, self.device, t, op),
            "all-reduce", t.numel() * t.element_size())

    def min_(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise f32 MIN over the group, -0 over +0."""
        return _from_ordered(self.all_reduce(_ordered(x), dist.ReduceOp.MIN))

    def sum_(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise int64 SUM over the group."""
        return self.all_reduce(x.to(torch.int64), dist.ReduceOp.SUM)

    def exchange(self, contrib: torch.Tensor, schedule: str,
                 n_loc: int) -> torch.Tensor:
        """(R, n_pad) per-rank candidates -> this rank's (R, n_loc) block
        of their elementwise min, by ``schedule``."""
        img = _ordered(contrib)
        r = contrib.shape[0]
        if schedule == "allreduce":
            full = self.all_reduce(img, dist.ReduceOp.MIN)
            lo = self.rank * n_loc
            return _from_ordered(full[:, lo:lo + n_loc])
        # block j of axis 0 is our contribution to rank j; after the
        # all_to_all it holds rank j's contribution to OUR block
        blocks = img.reshape(r, self.size, n_loc).transpose(0, 1)
        got = self._clocked(
            lambda: coll.all_to_all(self.group, self.device, blocks),
            "all-to-all", img.numel() * img.element_size())
        return _from_ordered(torch.amin(got, dim=0))

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """(..., n_loc) blocks of every rank, joined in rank order on the
        last axis: (..., n_pad) on every rank."""
        parts = self._clocked(
            lambda: coll.all_gather(self.group, self.device, x),
            "all-gather", self.size * x.numel() * x.element_size())
        return torch.cat(parts.unbind(0), dim=-1)

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``t`` (a tensor of the same shape and dtype on every
        rank) on every rank."""
        return coll.broadcast(self.group, self.device, t, self.src0)


# ---------------------------------------------------------------------------
# The partition
# ---------------------------------------------------------------------------


def block_sizes(n: int, num_shards: int, pad_multiple: int) -> tuple[int, int]:
    """(n_loc, n_pad), the reference's: ``-(-n // P)`` rounded up to
    ``pad_multiple``, times P."""
    n_loc = -(-n // num_shards)
    n_loc = -(-n_loc // pad_multiple) * pad_multiple
    return n_loc, n_loc * num_shards


def _partition_edges(src, dst, w, n: int, num_shards: int, pad_multiple: int,
                     rank: int):
    """Rank ``rank``'s row of the reference's ``_partition_edges``.

    Returns ``(n_loc, n_pad, src_l, dst_l, w_l, k)``: the ``(E_loc,)``
    local source ids, global destinations and +inf-padded weights of the
    real edges whose source the rank owns, in COO order, ``E_loc`` the
    reference's (the largest block's count rounded up to
    ``pad_multiple``), and k the real ones among them.
    """
    if not 0 <= rank < num_shards:
        raise ValueError(f"rank must be in [0, {num_shards}); got {rank}")
    n_loc, n_pad = block_sizes(n, num_shards, pad_multiple)
    real = torch.isfinite(w)
    src, dst, w = src[real], dst[real], w[real]
    blk = src.long() // n_loc
    counts = torch.bincount(blk, minlength=num_shards)
    e_loc = max(int(counts.max()), 1)
    e_loc = -(-e_loc // pad_multiple) * pad_multiple
    mine = blk == rank
    k = int(counts[rank])
    dev = w.device
    src_l = torch.zeros(e_loc, dtype=torch.int32, device=dev)
    dst_l = torch.zeros(e_loc, dtype=torch.int32, device=dev)
    w_l = torch.full((e_loc,), INF, dtype=torch.float32, device=dev)
    src_l[:k] = src[mine] - rank * n_loc
    dst_l[:k] = dst[mine]
    w_l[:k] = w[mine]
    return n_loc, n_pad, src_l, dst_l, w_l, k


def local_out_view(src_l, dst_l, w_l, n_loc: int, n_pad: int,
                   pad_multiple: int = 8):
    """The rank-local outgoing ELL of a COO row: ``(cols, ws)``, (n_loc, D)
    rows of owned vertices, their out-edges left-packed, global target ids
    and the sentinel ``n_pad`` (padding edges, +inf weights, dropped)."""
    return _build_ell(dst_l, src_l, w_l, n_loc, pad_multiple, sentinel=n_pad)


def _block_of(vec: torch.Tensor, n: int, n_loc: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s (n_loc,) block of an (n,) f32 vector, +inf past n
    (the reference's ``_pad_min_vec``, then the rank's slice)."""
    out = torch.full((n_loc,), INF, dtype=torch.float32, device=vec.device)
    lo = rank * n_loc
    hi = min(lo + n_loc, n)
    if hi > lo:
        out[: hi - lo] = vec[lo:hi]
    return out


def _resolve_rank(rank, group) -> int:
    return group_rank_size(group)[0] if rank is None else int(rank)


@dataclasses.dataclass(frozen=True)
class ShardedGraph:
    """One rank's block of the legacy program's graph: rank r owns
    vertices ``[r * n_loc, (r + 1) * n_loc)``, one source baked in."""

    n: int
    n_pad: int
    n_loc: int
    num_shards: int
    rank: int
    src_local: torch.Tensor  # (E_loc,) int32 local source ids
    dst: torch.Tensor  # (E_loc,) int32 global destinations
    w: torch.Tensor  # (E_loc,) f32, +inf padding
    d_init: torch.Tensor  # (n_loc,) f32
    status_init: torch.Tensor  # (n_loc,) int32
    in_min: torch.Tensor  # (n_loc,) f32, +inf on padding vertices
    out_min: torch.Tensor  # (n_loc,) f32, +inf on padding vertices
    ell_out: tuple  # (cols, ws) (n_loc, D): the rank-local outgoing ELL

    @property
    def device(self) -> torch.device:
        return self.w.device


def shard_graph(g: Graph, num_shards: int, source: int = 0,
                pad_multiple: int = 8, *, rank: int | None = None,
                group=None) -> ShardedGraph:
    """This rank's block of the legacy single-query program, with the
    source baked in. ``source`` must be a real vertex id in ``[0, n)``
    (a padding id would silently answer all-inf). ``rank`` defaults to
    this process's rank in ``group``."""
    if not 0 <= int(source) < g.n:
        raise ValueError(f"source must be in [0, {g.n}); got {source}")
    rank = _resolve_rank(rank, group)
    n_loc, n_pad, src_l, dst_l, w_l, _ = _partition_edges(
        g.src, g.dst, g.w, g.n, num_shards, pad_multiple, rank)
    d0, st0 = _block_rows(torch.tensor([int(source)], device=g.device),
                          n_loc, rank)
    return ShardedGraph(
        n=g.n, n_pad=n_pad, n_loc=n_loc, num_shards=num_shards, rank=rank,
        src_local=src_l, dst=dst_l, w=w_l, d_init=d0[0], status_init=st0[0],
        in_min=_block_of(g.in_min_static, g.n, n_loc, rank),
        out_min=_block_of(g.out_min_static, g.n, n_loc, rank),
        ell_out=local_out_view(src_l, dst_l, w_l, n_loc, n_pad),
    )


@dataclasses.dataclass(frozen=True)
class ShardedBatchGraph:
    """One rank's block of the query-independent sharded graph.

    Carries the forward partition (edges grouped by the owner of their
    source: the relax and the in-side dynamic keys push along it) and,
    optionally, the transpose partition (edges grouped by the owner of
    their destination: the out-side keys reduce over a vertex's out-edges
    gated by the target's status, so the gate is read at the target's
    owner and the key pushed back to the source's owner). Each partition
    is the rank's COO row plus its rank-local outgoing ELL.
    """

    n: int
    n_pad: int
    n_loc: int
    num_shards: int
    rank: int
    src_local: torch.Tensor  # (E_loc,) int32 local source ids
    dst: torch.Tensor  # (E_loc,) int32 global destinations
    w: torch.Tensor  # (E_loc,) f32, +inf padding
    tsrc_local: torch.Tensor | None  # (E_loc_t,) int32 local id of the
    #   edge's DST (None when sharded with with_transpose=False)
    tdst: torch.Tensor | None  # (E_loc_t,) int32 global id of the edge's SRC
    tw: torch.Tensor | None  # (E_loc_t,) f32, +inf padding
    in_min: torch.Tensor  # (n_loc,) f32, +inf on padding vertices
    out_min: torch.Tensor  # (n_loc,) f32, +inf on padding vertices
    out_deg: torch.Tensor  # (n_loc,) int32 real out-degrees (0 on padding)
    ell_out: tuple  # (cols, ws) (n_loc, D) of the forward partition
    ell_t: tuple | None  # (cols, ws) of the transpose partition: rows are
    #   owned destinations, ids global sources

    @property
    def device(self) -> torch.device:
        return self.w.device


def shard_graph_batch(g: Graph, num_shards: int, pad_multiple: int = 8,
                      with_transpose: bool = True, *, rank: int | None = None,
                      group=None) -> ShardedBatchGraph:
    """This rank's block of the graph for the batch stepper (no baked-in
    source), on the graph's device. ``with_transpose`` also builds the
    transpose partition the out-side dynamic keys read; front-ends that
    know the criterion pass ``plan.needs_out_adjacency``. ``rank``
    defaults to this process's rank in ``group``."""
    rank = _resolve_rank(rank, group)
    n_loc, n_pad, src_l, dst_l, w_l, k = _partition_edges(
        g.src, g.dst, g.w, g.n, num_shards, pad_multiple, rank)
    t = (None,) * 3
    ell_t = None
    if with_transpose:
        _, _, *t, _ = _partition_edges(g.dst, g.src, g.w, g.n, num_shards,
                                       pad_multiple, rank)
        ell_t = local_out_view(*t, n_loc, n_pad)
    out_deg = torch.bincount(src_l[:k].long(), minlength=n_loc).to(torch.int32)
    return ShardedBatchGraph(
        n=g.n, n_pad=n_pad, n_loc=n_loc, num_shards=num_shards, rank=rank,
        src_local=src_l, dst=dst_l, w=w_l,
        tsrc_local=t[0], tdst=t[1], tw=t[2],
        in_min=_block_of(g.in_min_static, g.n, n_loc, rank),
        out_min=_block_of(g.out_min_static, g.n, n_loc, rank),
        out_deg=out_deg,
        ell_out=local_out_view(src_l, dst_l, w_l, n_loc, n_pad),
        ell_t=ell_t,
    )


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardedBatchState:
    """One rank's block of a sharded batched phase loop (one row per lane):
    the twin of the reference's ``ShardedBatchState``, whose ``(B, n_pad)``
    vertex arrays each rank holds as ``(B, n_loc)`` blocks. Counters,
    ``trips`` and the trace ring are replicated: every input to them is
    reduced over the group first, so every rank writes the same values."""

    n: int  # true vertex count; columns in [n, n_pad) are padding
    n_pad: int
    rank: int
    dist: torch.Tensor  # (B, n_loc) f32 tentative distances
    status: torch.Tensor  # (B, n_loc) int32 (0=U, 1=F, 2=S)
    trips: torch.Tensor  # 0-dim int32 loop trips since init
    phases: torch.Tensor  # (B,) int32 phases each lane's query was live
    sum_fringe: torch.Tensor  # (B,) int64 per-lane sum over phases of |F|
    relax_edges: torch.Tensor  # (B,) int64 per-lane out-edges relaxed
    dist_true: torch.Tensor | None  # (B, n_loc) f32 per-lane true distances
    #   (+inf on padding columns), only on oracle-plan states
    settled_trace: torch.Tensor  # (B, trace_len) int32 ring of per-phase
    #   settle counts (phase p of a lane's query in slot p % trace_len)
    criterion: str  # canonical criterion string

    @property
    def num_lanes(self) -> int:
        return self.dist.shape[0]

    @property
    def n_loc(self) -> int:
        return self.dist.shape[1]

    @property
    def device(self) -> torch.device:
        return self.dist.device

    @property
    def plan(self) -> C.CritPlan:
        return C.plan_for(self.criterion)


def _block_rows(sources: torch.Tensor, n_loc: int, rank: int):
    """(B, n_loc) dist/status rows of rank ``rank``'s block for fresh
    queries: 0 / fringe at a source the rank owns, +inf / 0 elsewhere (a
    source below 0 gives an empty row on every rank)."""
    b = sources.shape[0]
    dev = sources.device
    col = sources.long() - rank * n_loc
    mine = (sources >= 0) & (col >= 0) & (col < n_loc)
    lanes = torch.nonzero(mine).squeeze(1)
    d = torch.full((b, n_loc), INF, dtype=torch.float32, device=dev)
    status = torch.zeros((b, n_loc), dtype=torch.int32, device=dev)
    d[lanes, col[lanes]] = 0.0
    status[lanes, col[lanes]] = 1
    return d, status


def _pad_dist_true(dist_true, plan: C.CritPlan, b: int, n: int, n_loc: int,
                   rank: int, dev):
    """This rank's (B, n_loc) f32 block of the reference's padded
    ``dist_true`` (+inf on padding columns), or None."""
    if not plan.needs_oracle:
        return None
    if dist_true is None:
        raise ValueError(
            f"criterion {plan.criterion!r} includes 'oracle': per-lane "
            f"dist_true of shape ({b}, {n}) is required"
        )
    dt = np.asarray(dist_true.cpu() if torch.is_tensor(dist_true)
                    else dist_true, np.float32)
    if dt.shape != (b, n):
        raise ValueError(f"dist_true must have shape ({b}, {n}); got {dt.shape}")
    out = np.full((b, n_loc), np.inf, np.float32)
    lo = rank * n_loc
    hi = min(lo + n_loc, n)
    if hi > lo:
        out[:, : hi - lo] = dt[:, lo:hi]
    return torch.from_numpy(out).to(dev)


def init_sharded_batch_state(sg: ShardedBatchGraph, sources,
                             criterion: str = DEFAULT_CRITERION,
                             dist_true=None,
                             trace_len: int = 1) -> ShardedBatchState:
    """Fresh stepper state for B lanes over one sharded graph: this rank's
    ``(B, n_loc)`` block, on the graph's device.

    ``sources[i] == -1`` leaves lane i empty. Sources are validated against
    the true vertex count ``sg.n``, never ``n_pad``. An oracle plan takes
    per-lane ``dist_true`` rows ``(B, n)``; ``trace_len`` sizes the
    settled-per-phase ring (1 = off). Messages are the reference's.
    """
    plan = C.plan_for(criterion)
    src_np = validate_sources(
        sources, sg.n, EMPTY_LANE, f"in [0, {sg.n}) or -1 for an empty lane"
    )
    if trace_len < 1:
        raise ValueError(f"trace_len must be >= 1; got {trace_len}")
    dev = sg.device
    d0, st0 = _block_rows(torch.from_numpy(src_np).to(dev), sg.n_loc, sg.rank)
    b = src_np.shape[0]
    return ShardedBatchState(
        n=sg.n, n_pad=sg.n_pad, rank=sg.rank, dist=d0, status=st0,
        trips=torch.zeros((), dtype=torch.int32, device=dev),
        phases=torch.zeros((b,), dtype=torch.int32, device=dev),
        sum_fringe=torch.zeros((b,), dtype=torch.int64, device=dev),
        relax_edges=torch.zeros((b,), dtype=torch.int64, device=dev),
        dist_true=_pad_dist_true(dist_true, plan, b, sg.n, sg.n_loc, sg.rank,
                                 dev),
        settled_trace=torch.zeros((b, int(trace_len)), dtype=torch.int32,
                                  device=dev),
        criterion=plan.criterion,
    )


# ---------------------------------------------------------------------------
# The stepper
# ---------------------------------------------------------------------------


def _check_group(sg, comm: Comm) -> None:
    if comm.size != sg.num_shards:
        raise ValueError(
            f"graph was sharded for {sg.num_shards} ranks but the process "
            f"group spans {comm.size}"
        )
    if comm.rank != sg.rank:
        raise ValueError(
            f"this is rank {comm.rank} of the group, but the graph holds "
            f"rank {sg.rank}'s block"
        )


def _push(dmask, view, coo, n_pad: int, use_kernels: bool):
    """(R, n_loc) -> (R, n_pad): the rectangular push along the rank-local
    ``view``, or on the plain path the reference's segment-min over the
    ``coo`` row (``(rows, cols, ws)``)."""
    if use_kernels:
        return ell_push_rect_batch(dmask, view[0], view[1], n_pad)
    return kref.push_coo_batch_ref(dmask, *coo, n_pad)


def _threshold_keys(plan: C.CritPlan, out_min, keys: dict, b: int):
    """Key stack of #2: None, ``(K, n_loc)`` shared (every OUT key static),
    or ``(K, B, n_loc)`` per lane, the static key expanded where a plan
    mixes the two."""
    if not plan.out_terms:
        return None
    if all(t == "static" for t in plan.out_terms):
        return out_min[None]
    return torch.stack([
        out_min.expand(b, out_min.shape[0]) if t == "static" else keys[t]
        for t in plan.out_terms
    ])


def step_sharded_batch(
    sg: ShardedBatchGraph,
    state: ShardedBatchState,
    group,
    k_phases: int,
    schedule: str = "reduce_scatter",
    stop_on_lane_finish: bool = False,
    use_kernels: bool = True,
    stats: dict | None = None,
) -> ShardedBatchState:
    """Advance the sharded phase loop by up to ``k_phases`` more trips.

    The contract of ``static_engine.step_batch``: returns after
    ``k_phases`` trips, earlier when every lane's fringe is empty, or, with
    ``stop_on_lane_finish``, as soon as a lane live on entry terminates;
    ``trips`` advances only while some lane is live. SPMD over ``group``
    (None = the default world), whose size must be the graph's shard
    count; no state is written in place. ``use_kernels=False`` runs the
    plain path (the same bits); ``stats`` (a dict) gets the exchange's host
    seconds and collectives (:class:`Comm`) and the ``trips`` run.
    """
    comm = Comm(group, sg.device, stats)
    _check_group(sg, comm)
    plan = C.plan_for(state.criterion)
    if plan.needs_out_adjacency and sg.ell_t is None:
        raise ValueError(
            f"criterion {state.criterion!r} needs dynamic OUT keys but the "
            f"graph was sharded with with_transpose=False; re-shard with "
            f"shard_graph_batch(..., with_transpose=True)"
        )
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown exchange schedule: {schedule!r}")
    if state.device != sg.device or state.n_pad != sg.n_pad:
        raise ValueError(
            f"state ({state.device}, n_pad {state.n_pad}) does not match the "
            f"graph's block ({sg.device}, n_pad {sg.n_pad})"
        )
    n_loc, n_pad = sg.n_loc, sg.n_pad
    fwd = (sg.ell_out, (sg.src_local, sg.dst, sg.w))
    rev = (sg.ell_t, (sg.tsrc_local, sg.tdst, sg.tw))
    by_name = {s.name: s for s in plan.keys}
    b = state.num_lanes
    rows_b = torch.arange(b, device=sg.device)
    trace_len = state.settled_trace.shape[1]

    def push_gates(names, side, status, keys):
        """The named keys' (B, n_loc) gates pushed along one side as lanes
        of one push: (len(names) * B, n_pad) candidates."""
        gates = torch.stack([
            C.key_gate(by_name[nm], status, sg.in_min, sg.out_min, keys)
            for nm in names
        ])
        return _push(gates.reshape(-1, n_loc), *side, n_pad, use_kernels)

    def dyn_keys(status):
        keys: dict = {}
        # the independent keys of both sides: one push a side, one exchange
        names = plan.in_scan_keys + plan.out_scan_keys
        if names:
            contrib = torch.cat(
                [push_gates(nms, side, status, keys) for nms, side in (
                    (plan.in_scan_keys, fwd), (plan.out_scan_keys, rev))
                 if nms])
            got = comm.exchange(contrib, schedule, n_loc)
            keys.update(zip(names, got.reshape(len(names), b, n_loc)))
        if plan.out_scan_dep is not None:
            got = comm.exchange(
                push_gates((plan.out_scan_dep,), rev, status, keys),
                schedule, n_loc)
            keys[plan.out_scan_dep] = got
        return keys

    s = state
    live0 = comm.sum_((s.status == 1).sum(dim=1)) > 0  # entry-live lanes
    go = bool(live0.any()) and int(k_phases) > 0
    done = 0
    while go:
        d, status = s.dist, s.status
        fringe = status == 1
        keys = dyn_keys(status)
        mins_loc, n_f_loc = kops.crit_thresholds_batch(
            d, status, _threshold_keys(plan, sg.out_min, keys, b),
            use_kernels=use_kernels)
        mins = comm.min_(mins_loc)  # one (L, B) MIN for every lane
        settle = C.plan_union_mask(plan, d, fringe, mins, keys, sg.in_min,
                                   s.dist_true)
        if plan.needs_fallback:
            # the bare oracle's guard needs a global any: one (B,) SUM
            any_mask = comm.sum_(settle.sum(dim=1)) > 0
            dijk = fringe & (d <= mins[0][:, None])
            settle = torch.where(any_mask[:, None], settle, dijk)
        dmask = torch.where(settle, d, INF)
        upd = comm.exchange(_push(dmask, *fwd, n_pad, use_kernels), schedule,
                            n_loc)
        # d >= +0 and upd = d + w >= +0: no -0 reaches this min
        new_d = torch.minimum(d, upd)
        new_status = torch.where(
            settle, 2, torch.where((status == 0) & (upd < INF), 1, status)
        ).to(torch.int32)
        # one (4, B) SUM: |F| this phase, relaxed out-edges, the post-update
        # live counts the loop reads and the settle count the ring records
        counts = comm.sum_(torch.stack([
            n_f_loc.to(torch.int64),
            torch.where(settle, sg.out_deg[None], 0).sum(dim=1,
                                                         dtype=torch.int64),
            (new_status == 1).sum(dim=1, dtype=torch.int64),
            settle.sum(dim=1, dtype=torch.int64),
        ]))
        n_f, d_redges, live_cnt, n_settled = counts
        alive = n_f > 0  # finished lanes stop counting
        idx = (s.phases % trace_len).long()
        trace = s.settled_trace.clone()
        trace[rows_b, idx] = torch.where(alive, n_settled.to(torch.int32),
                                         trace[rows_b, idx])
        s = dataclasses.replace(
            s, dist=new_d, status=new_status, trips=s.trips + 1,
            phases=s.phases + alive.to(torch.int32),
            sum_fringe=s.sum_fringe + n_f, relax_edges=s.relax_edges + d_redges,
            settled_trace=trace,
        )
        done += 1
        new_live = live_cnt > 0
        go = bool(new_live.any()) and done < int(k_phases)
        if stop_on_lane_finish:
            go = go and bool(torch.equal(new_live, live0))
    if stats is not None:
        stats["trips"] = stats.get("trips", 0) + done
    return s


# ---------------------------------------------------------------------------
# Lanes and harvest
# ---------------------------------------------------------------------------


def reset_sharded_lanes(state: ShardedBatchState, sources,
                        dist_true=None) -> ShardedBatchState:
    """Re-initialise several lanes of this rank's block (the sharded twin
    of ``reset_lanes``; no collective). ``sources`` is ``(B,)``: -2 keeps a
    lane's bits, -1 parks it empty, a vertex id in ``[0, n)`` starts a
    fresh query there. On an oracle-plan state, refilling a lane requires
    fresh ``dist_true`` rows ``(B, n)``."""
    src_np = validate_sources(
        sources, state.n, KEEP_LANE,
        f"in [0, {state.n}), -1 (park) or -2 (keep)",
        expect_lanes=state.num_lanes,
    )
    dt = None
    if state.dist_true is not None:
        if dist_true is None and (src_np >= 0).any():
            raise ValueError(
                "criterion includes 'oracle': refilling lanes requires "
                "dist_true rows (B, n)"
            )
        if dist_true is not None:
            dt = _pad_dist_true(dist_true, state.plan, state.num_lanes,
                                state.n, state.n_loc, state.rank,
                                state.device)
    elif dist_true is not None:
        raise ValueError(
            f"criterion {state.criterion!r} does not read dist_true"
        )
    sources_t = torch.from_numpy(src_np).to(state.device)
    touch = sources_t >= EMPTY_LANE  # KEEP_LANE rows pass through unchanged
    fresh_d, fresh_s = _block_rows(sources_t, state.n_loc, state.rank)

    def ctr(old):
        return torch.where(touch, 0, old)

    state_dt = state.dist_true
    if state_dt is not None and dt is not None:
        state_dt = torch.where(touch[:, None], dt, state_dt)
    return dataclasses.replace(
        state,
        dist=torch.where(touch[:, None], fresh_d, state.dist),
        status=torch.where(touch[:, None], fresh_s, state.status),
        phases=ctr(state.phases),
        sum_fringe=ctr(state.sum_fringe),
        relax_edges=ctr(state.relax_edges),
        dist_true=state_dt,
        settled_trace=torch.where(touch[:, None], 0, state.settled_trace),
    )


def sharded_lanes_active(state: ShardedBatchState, group=None) -> np.ndarray:
    """(B,) bool host array: which lanes still have a non-empty fringe on
    some rank (one SUM over ``group``; SPMD)."""
    comm = Comm(group, state.device)
    return (comm.sum_((state.status == 1).sum(dim=1)) > 0).cpu().numpy()


def harvest_sharded(state: ShardedBatchState, group=None) -> BatchedResult:
    """Freeze a sharded state into a padding-free ``BatchedResult`` on
    every rank (the blocks gathered over ``group``; SPMD). A length-1 ring
    was never a trace, so it maps to None."""
    comm = Comm(group, state.device)
    d = comm.gather(state.dist)[:, : state.n]
    status = comm.gather(state.status)[:, : state.n]
    trace = state.settled_trace if state.settled_trace.shape[1] > 1 else None
    return BatchedResult(
        dist=d.contiguous(),
        status=status.to(torch.int8),
        phases=state.phases,
        sum_fringe=state.sum_fringe.cpu().numpy(),
        relax_edges=state.relax_edges.cpu().numpy(),
        total_phases=state.trips,
        settled_per_phase=trace,
    )


# ---------------------------------------------------------------------------
# Front-ends
# ---------------------------------------------------------------------------


def run_sharded_batch(g: Graph, group, sources,
                      schedule: str = "reduce_scatter",
                      max_phases: int | None = None,
                      criterion: str = DEFAULT_CRITERION,
                      dist_true=None, trace_len: int = 1, device=None,
                      use_kernels: bool = True,
                      stats: dict | None = None) -> BatchedResult:
    """One-shot batched distributed solve: shard, init, drain, harvest.
    ``device`` (None = ``cuda:(rank % device_count)``) must be the graph's
    device."""
    graph_device(g, rank_device(group, device))
    _, size = group_rank_size(group)
    sg = shard_graph_batch(
        g, size, with_transpose=C.plan_for(criterion).needs_out_adjacency,
        group=group,
    )
    state = init_sharded_batch_state(sg, sources, criterion=criterion,
                                     dist_true=dist_true, trace_len=trace_len)
    cap = int(max_phases) if max_phases is not None else g.n + 1
    state = step_sharded_batch(sg, state, group, cap, schedule=schedule,
                               use_kernels=use_kernels, stats=stats)
    return harvest_sharded(state, group)


def run_distributed(g: Graph, group, source: int = 0,
                    schedule: str = "reduce_scatter",
                    criterion: str = DEFAULT_CRITERION,
                    dist_true=None, device=None, use_kernels: bool = True):
    """Shard, run, return ``(dist (n,), phases)``: a B = 1 front-end over
    the stepper, bit-exact against the legacy program. ``dist_true`` is
    the (n,) true-distance row of an oracle plan."""
    if not 0 <= int(source) < g.n:
        raise ValueError(f"source must be in [0, {g.n}); got {source}")
    dt = None if dist_true is None else np.asarray(
        dist_true.cpu() if torch.is_tensor(dist_true) else dist_true,
        np.float32)[None]
    res = run_sharded_batch(g, group, [int(source)], schedule=schedule,
                            criterion=criterion, dist_true=dt, device=device,
                            use_kernels=use_kernels)
    return res.dist[0], res.phases[0]


def make_distributed_sssp(group=None, *, schedule: str = "reduce_scatter",
                          use_kernels: bool = True, stats: dict | None = None):
    """The legacy single-query program (criterion ``instatic|outstatic``,
    the paper's parallel implementation) over ``group``. Returns
    ``run(sg, cap) -> (dist (n_pad,), phases)``, SPMD, each rank passing
    its :class:`ShardedGraph` block; ``dist`` is gathered on every rank
    and ``cap`` bounds the phases. ``stats`` is :class:`Comm`'s."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown exchange schedule: {schedule!r}")

    def run(sg: ShardedGraph, cap):
        comm = Comm(group, sg.device, stats)
        _check_group(sg, comm)
        coo = (sg.src_local, sg.dst, sg.w)
        d, status = sg.d_init, sg.status_init
        phases = 0
        go = bool(comm.sum_((status == 1).sum())[()] > 0)
        while go and phases < int(cap):
            fringe = status == 1
            mins, _ = kops.crit_thresholds_batch(
                d[None], status[None], sg.out_min[None],
                use_kernels=use_kernels)
            mins = comm.min_(mins)
            min_fd, l_out = mins[0, 0], mins[1, 0]
            settle = fringe & ((d - sg.in_min <= min_fd) | (d <= l_out)
                               | (d <= min_fd))
            dmask = torch.where(settle, d, INF)[None]
            upd = comm.exchange(
                _push(dmask, sg.ell_out, coo, sg.n_pad, use_kernels),
                schedule, sg.n_loc)[0]
            d, status = torch.minimum(d, upd), torch.where(
                settle, 2, torch.where((status == 0) & (upd < INF), 1, status)
            ).to(torch.int32)
            phases += 1
            go = bool(comm.sum_((status == 1).sum())[()] > 0)
        return comm.gather(d), torch.tensor(phases, dtype=torch.int32)

    return run
