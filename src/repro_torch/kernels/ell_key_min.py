"""Dynamic criterion keys as masked ELL segment-mins (CUDA kernel).

    key[b, v] = min_j gate[b, cols[v, j]] + ws[v, j]

where ``gate`` is an elementwise function of the lane's status
(``core.criteria.key_gate``): 0 for a neighbour that contributes its edge
as-is, a slack for an unexplored one, +inf for a settled one. The stepper
uses it to re-prime the carried in-side keys after admission. The kernel
is the gather body of ``csrc/ell_gather.cu`` with one gate row per lane;
its note says what bounds it on the card. A tensor on the CPU runs the
plain twin in ``kernels/ref.py``; a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.ell_relax_keys import check_inputs, gather_rows


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
    if gate.device.type == "cpu":
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
