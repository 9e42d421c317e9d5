"""Plain PyTorch twins of the CUDA kernels (the correctness contract).

Each ``*_ref`` computes the same function as its kernel with the same f32
operations: one add per candidate and an exact min, so a kernel and its
twin agree bit for bit. ``torch.amin`` / ``torch.minimum`` propagate NaN as
``jnp.min`` / ``jnp.minimum`` do. Gather indices are widened to int64 here
(``torch`` indexing needs them); the kernels read the int32 ``cols``.
"""
from __future__ import annotations

import torch

INF = float("inf")


def ell_relax_ref(dmask: torch.Tensor, cols: torch.Tensor,
                  ws: torch.Tensor) -> torch.Tensor:
    """upd[v] = min_j dmask[cols[v, j]] + ws[v, j]."""
    return torch.amin(dmask[cols.long()] + ws, dim=1)


def ell_relax_batch_ref(dmask: torch.Tensor, cols: torch.Tensor,
                        ws: torch.Tensor) -> torch.Tensor:
    """upd[b, v] = min_j dmask[b, cols[v, j]] + ws[v, j]."""
    return torch.amin(dmask[:, cols.long()] + ws[None], dim=-1)


def frontier_crit_ref(d: torch.Tensor, status: torch.Tensor,
                      out_min: torch.Tensor):
    """(min_F d, min_F (d + out_min), |F|) over one (n,) row."""
    fringe = status == 1
    min_fd = torch.amin(torch.where(fringe, d, INF))
    l_out = torch.amin(torch.where(fringe, d + out_min, INF))
    n_f = fringe.sum(dtype=torch.int32)
    return min_fd, l_out, n_f


def frontier_crit_batch_ref(d: torch.Tensor, status: torch.Tensor,
                            out_min: torch.Tensor):
    """Per-row (min_F d, L_out, |F|) over (B, n) state; out_min shared."""
    fringe = status == 1
    min_fd = torch.amin(torch.where(fringe, d, INF), dim=1)
    l_out = torch.amin(torch.where(fringe, d + out_min[None], INF), dim=1)
    n_f = fringe.sum(dim=1, dtype=torch.int32)
    return min_fd, l_out, n_f


def frontier_crit_lanes_batch_ref(d: torch.Tensor, status: torch.Tensor,
                                  keys: torch.Tensor | None):
    """Per-row plan-lane thresholds: (mins (1+K, B), |F| (B,)).

    ``keys`` is ``(K, n)`` (shared static keys), ``(K, B, n)`` (per-lane
    dynamic keys) or None (K = 0); mins[0] = min_F d, mins[1+k] =
    min_F (d + keys[k]).
    """
    fringe = status == 1
    rows = [torch.amin(torch.where(fringe, d, INF), dim=1)]
    if keys is not None:
        for k in range(keys.shape[0]):
            kk = keys[k]
            term = d + (kk if kk.dim() == 2 else kk[None, :])
            rows.append(torch.amin(torch.where(fringe, term, INF), dim=1))
    n_f = fringe.sum(dim=1, dtype=torch.int32)
    return torch.stack(rows), n_f
