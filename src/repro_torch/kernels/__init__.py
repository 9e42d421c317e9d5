"""Hand-written CUDA kernels for the phased-SSSP hot spots (``csrc/``),
their plain PyTorch twins (``ref.py``) and the padding wrappers the engines
call (``ops.py``). Kernels build with ``nvcc`` at first use
(``_build.py``)."""
from repro_torch.kernels.ops import (
    crit_thresholds_batch,
    gather_min_batch_sliced,
    in_scan_relax_keys_batch,
    key_min_batch,
    key_min_batch_any,
    key_min_batch_for,
    out_scan_keys_batch,
    pad_lane_batch,
    push_settled_batch,
    push_settled_batch_sliced,
    relax_settled,
    relax_settled_batch,
    relax_settled_batch_sliced,
    static_thresholds,
    static_thresholds_batch,
)

PUSH_IN_SCAN = "ell_sliced_relax_keys_batch[out_view]"  # #10b's count


def launch_counters() -> dict:
    """name -> (wrapper, attribute) of every SSSP kernel wrapper's launch
    count: one a call that launched its kernel on the card (the sliced
    in-scan counts its push form apart, under :data:`PUSH_IN_SCAN`). The
    stepper reads them around a graph capture, which launches nothing, and
    adds a capture's counts at each replay."""
    from repro_torch.kernels.ell_key_min import (
        ell_key_min_batch,
        ell_key_min_status_batch,
    )
    from repro_torch.kernels.ell_relax import (
        ell_delta_push_batch,
        ell_push_rect_batch,
        ell_push_relax_batch,
        ell_relax_batch,
    )
    from repro_torch.kernels.ell_relax_keys import (
        ell_gather_min_batch,
        ell_keys_dep_batch,
        ell_relax_keys_batch,
    )
    from repro_torch.kernels.ell_sliced import (
        ell_sliced_delta_push_batch,
        ell_sliced_gather_min_batch,
        ell_sliced_keys_dep_batch,
        ell_sliced_push_relax_batch,
        ell_sliced_relax_keys_batch,
    )
    from repro_torch.kernels.frontier_crit import (
        delta_thresholds_batch,
        frontier_crit_lanes_batch,
    )
    from repro_torch.kernels.settle_push import (
        ell_delta_settle_mark_batch,
        ell_delta_settle_push_batch,
        ell_delta_settle_tail_batch,
        ell_settle_mark_batch,
        ell_settle_push_batch,
        ell_settle_tail_batch,
        ell_sliced_delta_settle_push_batch,
        ell_sliced_settle_push_batch,
    )

    counted = {f.__name__: (f, "launches") for f in (
        ell_relax_batch, frontier_crit_lanes_batch, ell_key_min_batch,
        ell_key_min_status_batch, ell_gather_min_batch, ell_relax_keys_batch,
        ell_keys_dep_batch, ell_sliced_gather_min_batch,
        ell_sliced_relax_keys_batch, ell_sliced_keys_dep_batch,
        ell_push_relax_batch, ell_sliced_push_relax_batch,
        ell_push_rect_batch, ell_delta_push_batch,
        ell_sliced_delta_push_batch, ell_settle_mark_batch,
        ell_settle_push_batch, ell_sliced_settle_push_batch,
        ell_settle_tail_batch, delta_thresholds_batch,
        ell_delta_settle_mark_batch, ell_delta_settle_push_batch,
        ell_sliced_delta_settle_push_batch, ell_delta_settle_tail_batch)}
    counted[PUSH_IN_SCAN] = (ell_sliced_relax_keys_batch, "push_launches")
    return counted


__all__ = [
    "PUSH_IN_SCAN",
    "launch_counters",
    "crit_thresholds_batch",
    "gather_min_batch_sliced",
    "in_scan_relax_keys_batch",
    "key_min_batch",
    "key_min_batch_any",
    "key_min_batch_for",
    "out_scan_keys_batch",
    "pad_lane_batch",
    "push_settled_batch",
    "push_settled_batch_sliced",
    "relax_settled",
    "relax_settled_batch",
    "relax_settled_batch_sliced",
    "static_thresholds",
    "static_thresholds_batch",
]
