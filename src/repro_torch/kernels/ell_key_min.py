"""Dynamic criterion keys as masked ELL segment-mins (CUDA kernel).

    key[b, v] = min_j gate[b, cols[v, j]] + ws[v, j]

where ``gate`` is an elementwise function of the lane's status
(``core.criteria.key_gate``): 0 for a neighbour that contributes its edge
as-is, a slack for an unexplored one, +inf for a settled one. The stepper
uses it to re-prime the carried in-side keys after admission. The kernel
is the pipelined scan body of ``csrc/ell_gather.cu`` with one gate row per
lane, one dense sweep; its note says what bounds it on the card. For the
"unsettled" gate (+0 where status < 2, +inf elsewhere), which the ops layer
knows from the key's ``KeySpec``, :func:`ell_key_min_status_batch` reads
the lanes' status instead, as a table of one byte of lane bits a column.
A tensor on the CPU runs the plain twin in ``kernels/ref.py``; a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.config import lane_tile, runs_twin
from repro_torch.kernels.ell_relax_keys import (
    check_inputs,
    gather_rows,
    launch,
)


def ell_key_min_batch(gate: torch.Tensor, cols: torch.Tensor,
                      ws: torch.Tensor) -> torch.Tensor:
    """Returns key (B, n) f32 = per-lane row-min of gate[b, cols] + ws.

    ``gate`` is (B, n_pad) f32, padded by the ops layer (+inf at the
    sentinel slot n); ``cols`` (n, D) int32 ids into [0, n_pad); ``ws``
    (n, D) f32.
    """
    if gate.dim() != 2:
        raise ValueError(f"want gate (B, n_pad); got {tuple(gate.shape)}")
    check_inputs({"gate": gate}, cols, ws)
    if gate.shape[1] < 1:
        raise ValueError("gate rows need at least one slot")
    if runs_twin(gate):
        return ref.ell_key_min_batch_ref(gate, cols, ws)
    out = torch.empty((gate.shape[0], cols.shape[0]), dtype=torch.float32,
                      device=gate.device)
    if out.numel() == 0:
        return out
    gather_rows(gate, gate.shape[1], cols, ws, out)
    ell_key_min_batch.launches += 1
    return out


ell_key_min_batch.launches = 0  # kernel launches since the last reset


def ell_key_min(gate: torch.Tensor, cols: torch.Tensor,
                ws: torch.Tensor) -> torch.Tensor:
    """1-D form: returns key (n,) f32 = row-min of gate[cols] + ws.

    The B = 1 view of :func:`ell_key_min_batch`, through the same kernel
    (its launches count there).
    """
    if gate.dim() != 1:
        raise ValueError(f"want gate (n_pad,); got {tuple(gate.shape)}")
    return ell_key_min_batch(gate[None], cols, ws)[0]


def ell_key_min_status_batch(status: torch.Tensor, cols: torch.Tensor,
                             ws: torch.Tensor) -> torch.Tensor:
    """Returns key (B, n_rows) f32 = per-lane row-min of gate[b, cols] + ws
    for the "unsettled" key gate of ``status``: gate[b, u] = +0 where
    status[b, u] < 2 (unexplored or fringe), +inf where settled and at the
    sentinel id n.

    The function of :func:`ell_key_min_batch` on that gate, padded, and of
    ``ell_gather_min_batch`` on it at V = 1. The kernel packs the
    status-gate table (``ref.status_gate_table``: one byte of lane bits a
    column) in place of the f32 gates and gathers one byte a slot; the add
    and the fold are the f32 path's, so the bits are too. ``status`` is
    (B, n) int32; ``cols`` (n_rows, D) int32 ids in [0, n]; ``ws``
    (n_rows, D) f32.
    """
    if status.dim() != 2 or status.dtype != torch.int32:
        raise ValueError(f"want int32 status (B, n); got {tuple(status.shape)}"
                         f" {status.dtype}")
    check_inputs({}, cols, ws)
    if status.device != cols.device or not status.is_contiguous():
        raise ValueError("status must be contiguous, on the adjacency's "
                         "device")
    if runs_twin(status):
        return ref.ell_key_min_status_batch_ref(status, cols, ws)
    b, n = status.shape
    n_rows, d_pad = cols.shape
    out = torch.empty((b, n_rows), dtype=torch.float32, device=status.device)
    if out.numel() == 0:
        return out
    bits = torch.empty((-(-b // lane_tile(b)) * (n + 1),), dtype=torch.uint8,
                       device=status.device)
    launch("ell_key_min_status_batch", "ell_gather_min_status_launch",
           status.device, status.data_ptr(), n, n + 1, b, cols.data_ptr(),
           ws.data_ptr(), n_rows, d_pad, bits.data_ptr(), out.data_ptr())
    ell_key_min_status_batch.launches += 1
    return out


ell_key_min_status_batch.launches = 0  # kernel launches since the last reset


def register_kernels(reg):
    """Register this module's kernel contracts (``kernels/registry.py``)."""
    from repro_torch.kernels import registry as R

    scan = ((R.SRC_GATHER, "pack_kernel"), (R.SRC_GATHER, "scan_kernel"))
    status_scan = ((R.SRC_GATHER, "pack_status_kernel"),
                   (R.SRC_GATHER, "scan_kernel"))

    def cases_1d():
        return (R.SpecCase("one_row", (R.fixture_lane_batch(1)[0],
                                       *R.fixture_ell())),)

    def cases_batch():
        return (
            R.SpecCase("ref", (R.fixture_lane_batch(), *R.fixture_ell())),
            *R.wide(lambda b, n, seed, signed: R.SpecCase(
                f"b{b}_n{n}",
                (R.fixture_lane_batch(b, n, seed, nan=True, signed=signed),
                 *R.fixture_ell(n, 6, seed, signed)))),
        )

    def cases_status():
        return (
            R.SpecCase("ref", (R.fixture_status((R.FIXTURE_B, R.FIXTURE_N)),
                               *R.fixture_ell())),
            *R.wide(lambda b, n, seed, signed: R.SpecCase(
                f"b{b}_n{n}", (R.fixture_status((b, n), seed),
                               *R.fixture_ell(n, 6, seed, signed)))),
        )

    reg.register(R.KernelContract(
        name="ell_key_min", module=__name__, wrapper=ell_key_min,
        make_cases=cases_1d, kernels=scan,
        notes="#4: #5 at B = 1, through the same kernel"))
    reg.register(R.KernelContract(
        name="ell_key_min_batch", module=__name__, wrapper=ell_key_min_batch,
        make_cases=cases_batch, kernels=scan,
        notes="#5: a dense gate sweep on the pipelined scan body"))
    reg.register(R.KernelContract(
        name="ell_key_min_status_batch", module=__name__,
        wrapper=ell_key_min_status_batch, make_cases=cases_status,
        kernels=status_scan,
        notes="#5b: the 'unsettled' gate read from status (one byte of "
              "lane bits a column)"))
