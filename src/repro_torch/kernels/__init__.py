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

__all__ = [
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
