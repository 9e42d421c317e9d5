"""Pull-model min-plus edge relaxation over the incoming ELL (CUDA kernel).

    upd[b, v] = min_j dmask[b, cols[v, j]] + ws[v, j]

where ``dmask[b, w]`` is ``d[b, w]`` if w was settled this phase in lane b
and +inf otherwise (the ops layer masks and pads it). The kernel is the
gather body of ``csrc/ell_gather.cu`` with one dmask row per lane and the
skip of all-+inf columns on, since dmask is sparse; its note says what
bounds it on the card and how the design answers. A tensor on the CPU runs
the plain twin in ``kernels/ref.py``; a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.ell_relax_keys import check_inputs, gather_rows


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
