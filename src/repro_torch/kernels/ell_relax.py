"""Min-plus edge relaxation, pull and push (CUDA kernels).

    upd[b, v] = min over edges (u, v, w) of dmask[b, u] + w

where ``dmask[b, u]`` is ``d[b, u]`` if u was settled this phase in lane b
and +inf otherwise. Two kernels compute it:

  * :func:`ell_relax_batch`, the pull over the incoming ELL,
    ``min_j dmask[b, cols[v, j]] + ws[v, j]`` (the ops layer masks and pads
    dmask): the gather body of ``csrc/ell_gather.cu`` with one dmask row per
    lane and the skip of all-+inf columns on. The counterpart of the
    reference's ``ell_relax_batch``; no engine path runs it any more.
  * :func:`ell_push_relax_batch`, the push over the outgoing ELL: only the
    out-rows of the vertices settled in some lane are read, and candidates
    land in ``upd`` through an f32 atomic min (``csrc/ell_push.cu``). The
    relax of every plan without in-side dynamic keys. The same bits as the
    pull (every NaN taken as one value).

Each source's note says what bounds its kernel on the card and how the
design answers. A tensor on the CPU runs the plain twin in
``kernels/ref.py``; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.ell_relax_keys import check_inputs, gather_rows, launch

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
PUSH_SIGNATURES = {
    "ell_push_relax_launch": ([_P, _LL, _I, _P, _I, _P, _P, _P, _P], _I),
}
MAX_PUSH_LANES = 32 * 65535  # lane tiles ride the grid's second axis


def ell_relax_batch(dmask: torch.Tensor, cols: torch.Tensor,
                    ws: torch.Tensor) -> torch.Tensor:
    """Returns upd (B, n) f32 = per-lane row-min of dmask[b, cols] + ws.

    ``dmask`` is (B, n_pad) f32 with +inf at masked, padded and sentinel
    slots; ``cols`` (n, D) int32 ids into [0, n_pad); ``ws`` (n, D) f32.
    """
    if dmask.dim() != 2:
        raise ValueError(f"want dmask (B, n_pad); got {tuple(dmask.shape)}")
    check_inputs({"dmask": dmask}, cols, ws)
    if dmask.shape[1] < 1:
        raise ValueError("dmask rows need at least one slot")
    if dmask.device.type == "cpu":
        return ref.ell_relax_batch_ref(dmask, cols, ws)
    out = torch.empty((dmask.shape[0], cols.shape[0]), dtype=torch.float32,
                      device=dmask.device)
    if out.numel() == 0:
        return out
    gather_rows(dmask, dmask.shape[1], cols, ws, out, sparse=True)
    ell_relax_batch.launches += 1
    return out


ell_relax_batch.launches = 0  # kernel launches since the last reset


def ell_relax(dmask: torch.Tensor, cols: torch.Tensor,
              ws: torch.Tensor) -> torch.Tensor:
    """1-D form: returns upd (n,) f32 = row-min of dmask[cols] + ws.

    The B = 1 view of :func:`ell_relax_batch`, through the same kernel
    (its launches count there).
    """
    if dmask.dim() != 1:
        raise ValueError(f"want dmask (n_pad,); got {tuple(dmask.shape)}")
    return ell_relax_batch(dmask[None], cols, ws)[0]


def push_library():
    """The loaded ``ell_push`` library (built at first use)."""
    return _build.load("ell_push", PUSH_SIGNATURES)


def push_rows(dmask: torch.Tensor, out_view, stats=None,
              lib=None) -> torch.Tensor:
    """Launch the push (``csrc/ell_push.cu``) along ``out_view``, a padded
    ``(cols, ws)`` pair or a ``SlicedEll``, already checked; returns upd
    (B, n). ``stats``, a (2,) int64 tensor on the card or None, gets
    [candidates, atomics issued] added. ``lib`` is a build of the source
    with the same C interface (default :func:`push_library`)."""
    b, n = dmask.shape
    dev = dmask.device
    upd = torch.empty((b, n), dtype=torch.float32, device=dev)
    if upd.numel() == 0:
        return upd
    if b > MAX_PUSH_LANES:
        raise ValueError(f"{b} lanes; the push takes at most {MAX_PUSH_LANES}")
    if stats is not None and (stats.device != dev or stats.dtype != torch.int64
                              or stats.shape != (2,)):
        raise ValueError("want stats as a (2,) int64 tensor on the card")
    buckets = ([(s.rows, s.cols, s.ws) for s in out_view.slices]
               if hasattr(out_view, "slices") else [(None, *out_view)])
    entries = []
    for rows, cols, ws in buckets:
        entries += [cols.data_ptr(), ws.data_ptr(),
                    0 if rows is None else rows.data_ptr(), cols.shape[0],
                    cols.shape[1]]
    table = (ctypes.c_longlong * max(len(entries), 1))(*entries)
    mask = torch.empty((-(-b // 32), n), dtype=torch.int32, device=dev)
    launch("ell_push_relax_batch", "ell_push_relax_launch", dev,
           dmask.data_ptr(), n, b, ctypes.addressof(table), len(buckets),
           mask.data_ptr(), upd.data_ptr(),
           None if stats is None else stats.data_ptr(),
           lib=push_library() if lib is None else lib)
    return upd


def ell_push_relax_batch(dmask: torch.Tensor, cols: torch.Tensor,
                         ws: torch.Tensor, *, stats=None) -> torch.Tensor:
    """Returns upd (B, n) f32: the relax pushed along the padded outgoing
    ELL, ``min dmask[b, u] + ws[u, j]`` over the rows u and slots j with
    ``cols[u, j] = v``, +inf where v has no candidate.

    ``dmask`` is (B, n) f32, unpadded; ``cols`` (n, D) int32 ids in [0, n]
    and ``ws`` (n, D) f32 are ``to_ell_out``'s view: row u holds u's
    out-edges left-packed, and a row ends at its first id outside [0, n)
    (the sentinel n). Where ``dmask[b, u]`` is +inf, u pushes nothing in
    lane b. ``stats``: see :func:`push_rows` (the kernel only).
    """
    if dmask.dim() != 2:
        raise ValueError(f"want dmask (B, n); got {tuple(dmask.shape)}")
    check_inputs({"dmask": dmask}, cols, ws)
    if cols.shape[0] != dmask.shape[1]:
        raise ValueError(
            f"the padded out-view needs one row per vertex: cols has "
            f"{cols.shape[0]} rows for n = {dmask.shape[1]}"
        )
    if dmask.device.type == "cpu":
        return ref.ell_push_relax_batch_ref(dmask, (cols, ws))
    upd = push_rows(dmask, (cols, ws), stats)
    ell_push_relax_batch.launches += 1
    return upd


ell_push_relax_batch.launches = 0  # kernel launches since the last reset
