"""Result of a single-source phased solve (counterpart of
``repro.core.phased.PhasedResult``). The generic COO engine ``run_phased``
comes with the dense criterion semantics (ROADMAP Queue 1 item 3)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PhasedResult:
    dist: torch.Tensor  # (n,) f32 final distances (inf = unreachable)
    status: torch.Tensor  # (n,) int8
    phases: torch.Tensor  # scalar int32: number of phases executed
    sum_fringe: np.int64  # sum over phases of |F| (paper Table 2)
    settled_per_phase: torch.Tensor | None  # (trace_len,) int32 (0 beyond
    #   `phases`), or None when tracing was disabled (trace_len=1)
    relax_edges: np.int64  # total out-edges relaxed (work)
