"""Carry graphs, sliced adjacency views and stepper state in from the JAX
package, as numpy.

The port never imports the reference; a caller that holds a reference
``Graph``, ``SlicedEll`` or ``BatchState`` passes its arrays as a dict of
numpy arrays (``np.asarray`` of each field) and gets the port's
counterpart, with no recomputation. The tests use this to start both
packages from one mid-solve state, and to feed the reference's own sliced
view to the port's kernels.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph import EllSlice, Graph, SlicedEll, sliced_ell
from repro_torch.core.static_engine import BatchState
from repro_torch.kernels.config import resolve_device

_GRAPH_FIELDS = {
    "src": np.int32, "dst": np.int32, "w": np.float32,
    "in_min_static": np.float32, "out_min_static": np.float32,
}
# Fields a reference BatchState carries only for modes the port does not
# run yet; they must be absent or None.
_UNPORTED_STATE_FIELDS = (
    "dist_true", "fringe_trace", "relax_trace", "attr_trace", "delta",
    "target",
)


def _tensor(x, dtype, dev) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype != dtype:
        raise TypeError(f"want {np.dtype(dtype)}; got {arr.dtype}")
    return torch.from_numpy(np.array(arr, copy=True)).to(dev)


def graph_from_numpy(fields: dict, device=None) -> Graph:
    """The port's :class:`Graph` from a reference graph's fields
    (``src, dst, w, in_min_static, out_min_static, n, m``) on ``device``
    (None = the CUDA card). The static minima are taken as given."""
    dev = resolve_device(device)
    arrays = {k: _tensor(fields[k], t, dev) for k, t in _GRAPH_FIELDS.items()}
    return Graph(n=int(fields["n"]), m=int(fields["m"]), **arrays)


def sliced_from_numpy(fields: dict, device=None) -> SlicedEll:
    """The port's :class:`~repro_torch.core.graph.SlicedEll` from a
    reference view's arrays on ``device`` (None = the CUDA card):
    ``fields["slices"]`` holds one ``{"rows", "cols", "ws"}`` dict per
    bucket (int32, int32, f32) and ``fields["merge_idx"]`` the (n, C)
    int32 merge plan, taken as given; only its compact form is derived."""
    dev = resolve_device(device)
    slices = [
        EllSlice(rows=_tensor(s["rows"], np.int32, dev),
                 cols=_tensor(s["cols"], np.int32, dev),
                 ws=_tensor(s["ws"], np.float32, dev))
        for s in fields["slices"]
    ]
    return sliced_ell(slices, _tensor(fields["merge_idx"], np.int32, dev))


def combine_limbs(lo, hi) -> np.ndarray:
    """A two-limb (u32 low, i32 high) counter as int64, the way the
    reference's ``combine_limbs`` folds it."""
    lo64 = np.asarray(lo).astype(np.int64)
    hi64 = np.asarray(hi).astype(np.int64)
    return (hi64 << np.int64(32)) + lo64


def state_from_numpy(fields: dict, device=None) -> BatchState:
    """The port's :class:`BatchState` from a reference state's fields on
    ``device`` (None = the CUDA card).

    Two-limb counters (``sum_fringe``/``sum_fringe_hi``,
    ``relax_edges``/``relax_edges_hi``) fold into int64. The carried key
    stack ``crit_keys`` and its ``keys_valid`` flag (a host bool here) come
    over as they are, so both packages continue from one mid-solve state.
    Fields of modes the port does not run (oracle rows, telemetry rings,
    delta, targets) must be absent or None.
    """
    dev = resolve_device(device)
    extra = [k for k in _UNPORTED_STATE_FIELDS if fields.get(k) is not None]
    if extra:
        raise NotImplementedError(
            f"state carries fields of modes not ported yet: {extra} "
            "(ROADMAP Queue 1 item 5)"
        )

    def counter(name):
        folded = combine_limbs(fields[name], fields[name + "_hi"])
        return torch.from_numpy(folded).to(dev)

    return BatchState(
        dist=_tensor(fields["dist"], np.float32, dev),
        status=_tensor(fields["status"], np.int32, dev),
        trips=_tensor(np.asarray(fields["trips"]).reshape(()), np.int32, dev),
        phases=_tensor(fields["phases"], np.int32, dev),
        sum_fringe=counter("sum_fringe"),
        relax_edges=counter("relax_edges"),
        out_deg=_tensor(fields["out_deg"], np.int32, dev),
        crit_keys=(None if fields.get("crit_keys") is None
                   else _tensor(fields["crit_keys"], np.float32, dev)),
        keys_valid=(None if fields.get("keys_valid") is None
                    else bool(np.asarray(fields["keys_valid"]))),
        settled_trace=_tensor(fields["settled_trace"], np.int32, dev),
        criterion=str(fields["criterion"]),
    )
