"""Pull-model min-plus edge relaxation over the incoming ELL (CUDA kernel).

    upd[b, v] = min_j dmask[b, cols[v, j]] + ws[v, j]

where ``dmask[b, w]`` is ``d[b, w]`` if w was settled this phase in lane b
and +inf otherwise (the ops layer masks and pads it). The kernel is
``csrc/ell_relax.cu``; its note says what bounds it on the card and how
the design answers. A tensor on the CPU runs the plain twin in
``kernels/ref.py``; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.config import RELAX_THREADS, relax_threads_per_row

_SIGNATURES = {
    "ell_relax_batch_launch": (
        [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p],
        ctypes.c_int,
    ),
    "ell_relax_lane_tile": ([ctypes.c_int], ctypes.c_int),
}


def _check(dmask, cols, ws):
    if dmask.dim() != 2 or cols.dim() != 2 or cols.shape != ws.shape:
        raise ValueError(
            f"want dmask (B, n_pad), cols and ws (n, D); got {tuple(dmask.shape)}, "
            f"{tuple(cols.shape)}, {tuple(ws.shape)}"
        )
    if (dmask.dtype, cols.dtype, ws.dtype) != (torch.float32, torch.int32,
                                                torch.float32):
        raise TypeError(
            f"want f32 dmask, int32 cols, f32 ws; got {dmask.dtype}, "
            f"{cols.dtype}, {ws.dtype}"
        )
    if cols.shape[1] < 1 or dmask.shape[1] < 1:
        raise ValueError("ELL rows and dmask rows need at least one slot")
    if not (dmask.device == cols.device == ws.device):
        raise ValueError(
            f"dmask, cols and ws on different devices: {dmask.device}, "
            f"{cols.device}, {ws.device}"
        )
    if dmask.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dmask.device}")
    if not (dmask.is_contiguous() and cols.is_contiguous()
            and ws.is_contiguous()):
        raise ValueError("dmask, cols and ws must be contiguous")


def ell_relax_batch(dmask: torch.Tensor, cols: torch.Tensor,
                    ws: torch.Tensor) -> torch.Tensor:
    """Returns upd (B, n) f32 = per-lane row-min of dmask[b, cols] + ws.

    ``dmask`` is (B, n_pad) f32 with +inf at masked, padded and sentinel
    slots; ``cols`` (n, D) int32 ids into [0, n_pad); ``ws`` (n, D) f32.
    """
    _check(dmask, cols, ws)
    if dmask.device.type == "cpu":
        return ref.ell_relax_batch_ref(dmask, cols, ws)
    b, n_pad = dmask.shape
    n, d_pad = cols.shape
    out = torch.empty((b, n), dtype=torch.float32, device=dmask.device)
    if b == 0 or n == 0:
        return out
    lib = _build.load("ell_relax", _SIGNATURES)
    # scratch: the lane-interleaved copy of dmask and the bitmap of its
    # columns that are not +inf in every lane (see csrc/ell_relax.cu)
    tile = lib.ell_relax_lane_tile(b)
    packed = None
    if b > 1:
        packed = torch.empty((-(-b // tile) * n_pad * tile,),
                             dtype=torch.float32, device=dmask.device)
    live_bits = torch.empty((-(-n_pad // 32),), dtype=torch.int32,
                            device=dmask.device)
    with torch.cuda.device(dmask.device):
        stream = torch.cuda.current_stream(dmask.device).cuda_stream
        rc = lib.ell_relax_batch_launch(
            dmask.data_ptr(), n_pad, cols.data_ptr(), ws.data_ptr(), n, d_pad,
            b, relax_threads_per_row(d_pad), RELAX_THREADS,
            None if packed is None else packed.data_ptr(),
            live_bits.data_ptr(), out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"ell_relax_batch launch failed: CUDA error {rc}")
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
