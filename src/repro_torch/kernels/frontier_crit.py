"""Fused frontier reduction over plan-defined lanes (CUDA kernel).

One pass over the vertex state produces every per-phase threshold a
criterion plan needs, plus the fringe size:

    lane 0     (f32): min_F d              (DIJK / IN-family threshold)
    lane 1+k   (f32): min_F (d + key_k)    (one lane per OUT-family member)
    count      (i32): |F|

Key stacks come as shared ``(K, n)`` (all OUT keys static: the default
plan), per-lane ``(K, B, n)`` (dynamic keys) or None (K = 0). The kernel is
``csrc/frontier_crit.cu`` (a two-pass reduction: per-block partials, then
one fold per lane); its note says what bounds it on the card. A tensor on
the CPU runs the plain twin in ``kernels/ref.py``; a CUDA tensor launches
the kernel or raises.

``frontier_crit_lanes``/``frontier_crit``/``frontier_crit_batch`` are the
reference's thin wrappers over the lane reduction.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.config import CRIT_ITEMS, CRIT_MAX_KEYS, CRIT_THREADS

_P = ctypes.c_void_p
_SIGNATURES = {
    "frontier_crit_lanes_launch": (
        [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
         ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, _P, _P, _P, _P, _P],
        ctypes.c_int,
    ),
}


def _check(d, status, keys):
    if d.dim() != 2 or status.shape != d.shape:
        raise ValueError(
            f"want d and status (B, n); got {tuple(d.shape)}, "
            f"{tuple(status.shape)}"
        )
    b, n = d.shape
    if n < 1:
        raise ValueError("the frontier reduction needs n >= 1 vertices")
    if (d.dtype, status.dtype) != (torch.float32, torch.int32):
        raise TypeError(f"want f32 d, int32 status; got {d.dtype}, {status.dtype}")
    tensors = [d, status]
    if keys is not None:
        if keys.dtype != torch.float32:
            raise TypeError(f"want f32 keys; got {keys.dtype}")
        if not (keys.dim() == 2 and keys.shape[1] == n
                or keys.dim() == 3 and keys.shape[1:] == (b, n)):
            raise ValueError(
                f"keys must be (K, {n}) or (K, {b}, {n}); got {tuple(keys.shape)}"
            )
        if keys.shape[0] > CRIT_MAX_KEYS:
            raise ValueError(
                f"too many OUT lanes: {keys.shape[0]} > {CRIT_MAX_KEYS}"
            )
        tensors.append(keys)
    if any(t.device != d.device for t in tensors):
        raise ValueError(
            f"inputs on different devices: {[str(t.device) for t in tensors]}"
        )
    if d.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {d.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("d, status and keys must be contiguous")


def frontier_crit_lanes_batch(d: torch.Tensor, status: torch.Tensor,
                              keys: torch.Tensor | None):
    """Returns (mins (1+K, B) f32, fringe_count (B,) i32).

    ``mins[0]`` is the per-lane min fringe distance; ``mins[1 + k]`` the
    OUT threshold ``min_F (d + keys[k])``.
    """
    _check(d, status, keys)
    if d.device.type == "cpu":
        return ref.frontier_crit_lanes_batch_ref(d, status, keys)
    b, n = d.shape
    k = 0 if keys is None else keys.shape[0]
    dev = d.device
    mins = torch.empty((1 + k, b), dtype=torch.float32, device=dev)
    cnt = torch.empty((b,), dtype=torch.int32, device=dev)
    if b == 0:
        return mins, cnt
    if b > 65535:
        raise ValueError(f"at most 65535 lanes per launch; got {b}")
    nblk = -(-n // (CRIT_THREADS * CRIT_ITEMS))
    part_min = torch.empty((1 + k, b, nblk), dtype=torch.float32, device=dev)
    part_cnt = torch.empty((b, nblk), dtype=torch.int32, device=dev)
    key_sk = key_sb = 0
    if keys is not None:
        key_sk, key_sb = (n, 0) if keys.dim() == 2 else (b * n, n)
    lib = _build.load("frontier_crit", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.frontier_crit_lanes_launch(
            d.data_ptr(), status.data_ptr(),
            None if keys is None else keys.data_ptr(), n, b, k, key_sk,
            key_sb, CRIT_THREADS, CRIT_ITEMS, nblk, part_min.data_ptr(),
            part_cnt.data_ptr(), mins.data_ptr(), cnt.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"frontier_crit_lanes_batch launch failed: CUDA error {rc}"
        )
    frontier_crit_lanes_batch.launches += 1
    return mins, cnt


frontier_crit_lanes_batch.launches = 0  # kernel launches since the last reset


def frontier_crit_lanes(d: torch.Tensor, status: torch.Tensor,
                        keys: torch.Tensor | None):
    """1-D entry point: returns (mins (1+K,) f32, fringe_count i32 scalar)."""
    mins, cnt = frontier_crit_lanes_batch(d[None], status[None], keys)
    return mins[:, 0], cnt[0]


def frontier_crit(d: torch.Tensor, status: torch.Tensor,
                  out_min: torch.Tensor):
    """Returns (min_fringe_d, l_out, fringe_count) scalars: the fixed
    INSTATIC|OUTSTATIC lane pair."""
    mins, cnt = frontier_crit_lanes(d, status, out_min[None])
    return mins[0], mins[1], cnt


def frontier_crit_batch(d: torch.Tensor, status: torch.Tensor,
                        out_min: torch.Tensor):
    """Returns (min_fringe_d (B,), l_out (B,), fringe_count (B,))."""
    mins, cnt = frontier_crit_lanes_batch(d, status, out_min[None])
    return mins[0], mins[1], cnt
