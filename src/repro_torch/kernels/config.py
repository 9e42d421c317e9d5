"""Device resolution and launch geometry for the CUDA kernel layer.

The reference's execution config (interpret/compiled modes, VMEM budgets,
tuning ledger, scan fusion) has no meaning on a Hopper card yet; this
module keeps only what the port's kernels need: which device an entry
point runs on, and the fixed launch shapes of the two kernels.
"""
from __future__ import annotations

import torch

# The gather kernels (csrc/ell_gather.cu): threads per block (a multiple of
# 32).
RELAX_THREADS = 256

# The sliced kernels: the buckets with rows one launch of a pass takes (must
# match MAX_SLICES in csrc/ell_gather.cu and PUSH_MAX_BUCKETS in
# csrc/ell_push.cu). A view with more runs each pass once a group of this
# many, in order (the default boundaries give at most 4: one group).
SLICED_GROUP_BUCKETS = 16

# The pipelined scan body of the fused scans (csrc/ell_gather.cu; must match
# its SCAN_CAP, SCAN_WARPS and SCAN_SKIP_WARPS, which check every unit table
# the sliced wrappers build from these): slots of one array a shared-memory
# stage holds, and the consumer warps of a dense and of a sparse sweep's
# block.
SCAN_CAP = 5120
SCAN_WARPS = 8
SCAN_SKIP_WARPS = 16

# frontier_crit_lanes_batch: threads per block (must match CRIT_THREADS in
# csrc/frontier_crit.cu), blocks on each SM over all lanes (one wave; its
# CRIT_MIN_BLOCKS holds the registers to that many), and the most OUT lanes
# a plan can ask for (must match KMAX there; the registry's plans need at
# most 4).
CRIT_THREADS = 256
CRIT_BLOCKS_PER_SM = 4
CRIT_MAX_KEYS = 8


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the CUDA card.

    Raises when a CUDA device is asked for and none is present: the port
    never continues on the host unless the caller asked for the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch twins on the host"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu'; got {dev}")
    return dev


# The gather kernels' packed tables: the most gather lanes one packed slot
# holds (LANE_TILE in csrc/ell_gather.cu).
LANE_TILE = 8


def lane_tile(lanes: int) -> int:
    """The packed table's lane tile for ``lanes`` gather lanes: the next
    power of two, at most LANE_TILE (``ell_gather_lane_tile`` in
    ``csrc/ell_gather.cu``, which must agree)."""
    w = 1
    while w < lanes and w < LANE_TILE:
        w *= 2
    return w


def relax_threads_per_row(d_pad: int) -> int:
    """Threads that share one ELL row: the smallest power of two covering
    the row width, capped at a warp (wide rows loop over the warp)."""
    tpr = 1
    while tpr < min(d_pad, 32):
        tpr *= 2
    return tpr
