"""Multi-vector gather-min and the fused two-sweep scans (CUDA kernels).

Three kernels over one padded ELL adjacency, each with a ``.launches``
count (one per call that launched its kernel):

  * :func:`ell_gather_min_batch`: V vectors x B lanes,
    ``out[v, b, r] = min_j vecs[v, b, cols[r, j]] + ws[r, j]``; the out-scan
    of plans whose OUT keys are all independent.
  * :func:`ell_relax_keys_batch`: the fused in-scan. Sweep 0 is the relax
    update ``upd``; sweep 1 is the next phase's in-side keys, the
    gather-min of the post-phase gate ``min(ga, gb, gc + fin(upd))`` with
    ``fin = 0`` where ``upd`` is finite, else +inf
    (``criteria.in_scan_gate_parts``).
  * :func:`ell_keys_dep_batch`: the fused out-scan. Rows ``[:K0]`` are the
    independent keys; row ``K0`` is the gather-min of
    ``min(dga, dgb + keys[dep_idx])`` (``out_full`` from ``out_dyn``,
    paper Eq. 2).

Vectors come unpadded, ``(..., n)``: the sentinel id n reads +inf. All
three run on the pipelined scan body of ``csrc/ell_gather.cu`` (persistent
blocks, the adjacency through a ring of bulk copies into shared memory).
Its notes say what bounds them on the card and how the two sweeps are
ordered; the helpers below bind that library for every gather wrapper
(``ell_relax``, ``ell_key_min`` and ``ell_sliced`` too). A tensor on the
CPU runs the plain twin in ``kernels/ref.py``; a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.config import (
    RELAX_THREADS,
    lane_tile,
    relax_threads_per_row,
)

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "ell_gather_min_launch": (
        [_P, _LL, _LL, _I, _P, _P, _LL, _I, _I, _I, _P, _P, _P, _P], _I),
    # the dense sweep of an "unsettled" gate from status (ell_key_min.py)
    "ell_gather_min_status_launch": (
        [_P, _LL, _LL, _I, _P, _P, _LL, _I, _P, _P, _P], _I),
    # the fused scans (the pipelined body sets its own launch shape)
    "ell_relax_keys_launch": (
        [_P, _P, _P, _P, _LL, _I, _I, _P, _P, _I, _P, _P, _P, _P, _P], _I),
    "ell_keys_dep_launch": (
        [_P, _P, _P, _LL, _I, _I, _I, _P, _P, _I, _P, _P, _P], _I),
    # the sliced entry points (kernels/ell_sliced.py). The gather, after
    # the vectors and sizes: bucket table, bucket count, total rows,
    # merge_ptr, merge_pos, threads, then scratch and outputs; the fused
    # scans: (the in-scan: the relax sweep's bucket table, its count and
    # threads,) the unit tables of their two sweeps, bucket count, the
    # merge plan, then scratch and outputs
    "ell_sliced_gather_min_launch": (
        [_P, _LL, _I, _P, _I, _LL, _P, _P, _I, _P, _P, _P, _P, _P], _I),
    "ell_sliced_relax_keys_launch": (
        [_P, _P, _P, _P, _LL, _I, _I, _P, _I, _I, _P, _P, _I, _P, _P, _P, _P,
         _P, _P, _P, _P], _I),
    "ell_sliced_keys_dep_launch": (
        [_P, _P, _P, _LL, _I, _I, _I, _P, _P, _I, _P, _P, _P, _P, _P], _I),
}


def check_inputs(vecs: dict, cols, ws):
    """The checks every gather wrapper shares: f32 vectors, an int32 / f32
    ``(n_rows, D)`` adjacency with D >= 1, one device (CPU or CUDA) and
    contiguous memory. ``vecs`` maps argument names to tensors."""
    if cols.dim() != 2 or cols.shape != ws.shape:
        raise ValueError(
            f"want {', '.join(vecs)} with cols and ws (n, D); got cols "
            f"{tuple(cols.shape)}, ws {tuple(ws.shape)}"
        )
    if cols.dtype != torch.int32 or ws.dtype != torch.float32:
        raise TypeError(f"want int32 cols, f32 ws; got {cols.dtype}, {ws.dtype}")
    if cols.shape[1] < 1:
        raise ValueError("ELL rows need at least one slot")
    for name, v in vecs.items():
        if v.dtype != torch.float32:
            raise TypeError(f"want f32 {name}; got {v.dtype}")
    tensors = [*vecs.values(), cols, ws]
    dev = cols.device
    if any(t.device != dev for t in tensors):
        raise ValueError(
            f"inputs on different devices: {[str(t.device) for t in tensors]}"
        )
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{', '.join(vecs)}, cols and ws must be contiguous")


def library():
    """The loaded ``ell_gather`` library (built at first use)."""
    return _build.load("ell_gather", _SIGNATURES)


def packed_scratch(lanes: int, n_idx: int, dev) -> torch.Tensor:
    """The lane-interleaved scratch of one sweep over ``lanes`` lanes."""
    tile = lane_tile(lanes)
    return torch.empty((-(-lanes // tile) * tile * n_idx,),
                       dtype=torch.float32, device=dev)


def on_stream(dev, call, *args):
    """``call(*args, stream)`` with ``dev`` the current device and
    ``stream`` its current stream (as a raw handle): the launch goes where
    PyTorch would put a kernel of its own. The device is switched only when
    it is not current already (a host cost a launch need not pay); a device
    without an index is the current one."""
    current = torch.cuda.current_device()
    index = current if dev.index is None else dev.index
    if index == current:
        return call(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return call(*args, torch._C._cuda_getCurrentRawStream(index))


def launch(name: str, fn: str, dev, *args, lib=None):
    """Call the C entry point ``fn`` of ``lib`` (default the ``ell_gather``
    library) on the current stream of ``dev`` and raise if a launch was
    refused."""
    lib = library() if lib is None else lib
    rc = on_stream(dev, getattr(lib, fn), *args)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def live_bits_scratch(n_idx: int, dev) -> torch.Tensor:
    """The bitmap of the columns that are not +inf in every lane."""
    return torch.empty((-(-n_idx // 32),), dtype=torch.int32, device=dev)


def gather_rows(vecs: torch.Tensor, n_idx: int, cols: torch.Tensor,
                ws: torch.Tensor, out: torch.Tensor, *, sparse: bool = False):
    """One sweep of a gather body on the card: ``vecs`` (..., n_src) is
    one row per gather lane, ids in [0, n_idx), columns past n_src read
    +inf; ``out`` is (..., n_rows). A dense sweep runs on the pipelined scan
    body; ``sparse`` (``vecs`` is +inf almost everywhere: the pull relax)
    on the single-sweep body, which skips the gathers of all-+inf columns
    through a bitmap."""
    n_src = vecs.shape[-1]
    lanes = out.numel() // cols.shape[0]
    n_rows, d_pad = cols.shape
    packed = packed_scratch(lanes, n_idx, vecs.device)
    live_bits = live_bits_scratch(n_idx, vecs.device) if sparse else None
    # threads 0 asks the C entry point for the pipelined body
    tpr, threads = ((relax_threads_per_row(d_pad), RELAX_THREADS) if sparse
                    else (0, 0))
    launch("gather-min", "ell_gather_min_launch", vecs.device,
           vecs.data_ptr(), n_src, n_idx, lanes, cols.data_ptr(),
           ws.data_ptr(), n_rows, d_pad, tpr, threads, packed.data_ptr(),
           None if live_bits is None else live_bits.data_ptr(),
           out.data_ptr())


def ell_gather_min_batch(vecs: torch.Tensor, cols: torch.Tensor,
                         ws: torch.Tensor) -> torch.Tensor:
    """Returns (V, B, n_rows) f32: per-vector per-lane row-min of
    ``vecs[v, b, cols] + ws``.

    ``vecs`` is (V, B, n) f32, unpadded; ``cols`` (n_rows, D) int32 ids in
    [0, n] (n is the sentinel and reads +inf); ``ws`` (n_rows, D) f32.
    """
    if vecs.dim() != 3:
        raise ValueError(f"want vecs (V, B, n); got {tuple(vecs.shape)}")
    check_inputs({"vecs": vecs}, cols, ws)
    if vecs.device.type == "cpu":
        return ref.ell_gather_min_batch_ref(vecs, cols, ws)
    v, b, n = vecs.shape
    out = torch.empty((v, b, cols.shape[0]), dtype=torch.float32,
                      device=vecs.device)
    if out.numel() == 0:
        return out
    gather_rows(vecs, n + 1, cols, ws, out)
    ell_gather_min_batch.launches += 1
    return out


ell_gather_min_batch.launches = 0  # kernel launches since the last reset


def _check_square(n: int, cols):
    # sweep 1 gathers from sweep 0's output, so rows and ids share [0, n]
    if cols.shape[0] != n:
        raise ValueError(
            f"the fused scans need one ELL row per vertex: cols has "
            f"{cols.shape[0]} rows for n = {n}"
        )


def ell_relax_keys_batch(dmask, ga, gb, gc, cols, ws):
    """Fused in-scan: returns ``(upd (B, n), keys (K, B, n))``.

    ``upd`` is exactly ``ell_relax_batch``'s output for ``dmask`` (B, n),
    unpadded; ``keys[k]`` is the key-min of the post-phase gate
    ``min(ga[k], gb[k], gc[k] + fin(upd))`` over (K, B, n) gate parts.
    K must be >= 1.
    """
    if ga.dim() != 3 or ga.shape[0] < 1:
        raise ValueError(f"need a (K>=1, B, n) gate stack; got {tuple(ga.shape)}")
    if dmask.dim() != 2 or not (ga.shape == gb.shape == gc.shape) \
            or ga.shape[1:] != dmask.shape:
        raise ValueError(
            f"want dmask (B, n) and ga, gb, gc (K, B, n); got "
            f"{tuple(dmask.shape)}, {tuple(ga.shape)}, {tuple(gb.shape)}, "
            f"{tuple(gc.shape)}"
        )
    check_inputs({"dmask": dmask, "ga": ga, "gb": gb, "gc": gc}, cols, ws)
    b, n = dmask.shape
    _check_square(n, cols)
    if dmask.device.type == "cpu":
        return ref.ell_relax_keys_batch_ref(dmask, ga, gb, gc, cols, ws)
    k, dev = ga.shape[0], dmask.device
    upd = torch.empty((b, n), dtype=torch.float32, device=dev)
    keys = torch.empty((k, b, n), dtype=torch.float32, device=dev)
    if upd.numel() == 0:
        return upd, keys
    packed = packed_scratch(max(b, k * b), n + 1, dev)
    live_bits = live_bits_scratch(n + 1, dev)
    launch("ell_relax_keys_batch", "ell_relax_keys_launch", dev,
           dmask.data_ptr(), ga.data_ptr(), gb.data_ptr(), gc.data_ptr(), n,
           b, k, cols.data_ptr(), ws.data_ptr(), cols.shape[1],
           packed.data_ptr(), live_bits.data_ptr(), upd.data_ptr(),
           keys.data_ptr())
    ell_relax_keys_batch.launches += 1
    return upd, keys


ell_relax_keys_batch.launches = 0  # kernel launches since the last reset


def ell_relax_keys(dmask, ga, gb, gc, cols, ws):
    """1-D form: ``(n,)`` dmask, ``(K, n)`` gate parts ->
    ``(upd (n,), keys (K, n))``. The B = 1 view of
    :func:`ell_relax_keys_batch`, through the same kernel (its launches
    count there)."""
    if dmask.dim() != 1:
        raise ValueError(f"want dmask (n,); got {tuple(dmask.shape)}")
    upd, keys = ell_relax_keys_batch(
        dmask[None], ga[:, None].contiguous(), gb[:, None].contiguous(),
        gc[:, None].contiguous(), cols, ws,
    )
    return upd[0], keys[:, 0]


def ell_keys_dep_batch(gates, dga, dgb, cols, ws, *, dep_idx: int = 0):
    """Fused out-scan: returns keys ``(K0 + 1, B, n)``.

    Rows ``[:K0]`` are the gather-mins of the (K0, B, n) ``gates``; row
    ``K0`` is the gather-min of ``min(dga, dgb + keys[dep_idx])`` over the
    (B, n) dependent-gate parts. All unpadded.
    """
    if gates.dim() != 3:
        raise ValueError(f"want gates (K0, B, n); got {tuple(gates.shape)}")
    k0, b, n = gates.shape
    if not 0 <= dep_idx < k0:
        raise ValueError(f"dep_idx {dep_idx} out of range for K0={k0}")
    if dga.shape != (b, n) or dgb.shape != (b, n):
        raise ValueError(
            f"want dga and dgb ({b}, {n}); got {tuple(dga.shape)}, "
            f"{tuple(dgb.shape)}"
        )
    check_inputs({"gates": gates, "dga": dga, "dgb": dgb}, cols, ws)
    _check_square(n, cols)
    if gates.device.type == "cpu":
        return ref.ell_keys_dep_batch_ref(gates, dga, dgb, dep_idx, cols, ws)
    dev = gates.device
    out = torch.empty((k0 + 1, b, n), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    packed = packed_scratch(max(k0 * b, b), n + 1, dev)
    launch("ell_keys_dep_batch", "ell_keys_dep_launch", dev,
           gates.data_ptr(), dga.data_ptr(), dgb.data_ptr(), n, b, k0,
           int(dep_idx), cols.data_ptr(), ws.data_ptr(), cols.shape[1],
           packed.data_ptr(), out.data_ptr())
    ell_keys_dep_batch.launches += 1
    return out


ell_keys_dep_batch.launches = 0  # kernel launches since the last reset
