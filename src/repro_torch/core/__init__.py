"""Core of the port: graph, criterion plans, the phase policy and the
resumable stepper (the main path of the phased-SSSP engine)."""
from repro_torch.core.criteria import CRITERIA, CritPlan, canonical, plan_for
from repro_torch.core.graph import (
    Graph,
    from_coo,
    out_degrees,
    to_ell_in,
    to_ell_out,
    to_numpy_csr,
    transpose,
)
from repro_torch.core.oracle import dijkstra_numpy
from repro_torch.core.phased import PhasedResult
from repro_torch.core.policies import (
    CriterionPolicy,
    PhasePolicy,
    canonical_spec,
    policy_for,
)
from repro_torch.core.static_engine import (
    DEFAULT_CRITERION,
    EMPTY_LANE,
    KEEP_LANE,
    BatchedResult,
    BatchState,
    harvest,
    init_batch_state,
    lanes_active,
    reset_lane,
    reset_lanes,
    run_phased_static,
    run_phased_static_batch,
    step_batch,
)

__all__ = [
    "CRITERIA",
    "CritPlan",
    "canonical",
    "plan_for",
    "Graph",
    "from_coo",
    "out_degrees",
    "to_ell_in",
    "to_ell_out",
    "to_numpy_csr",
    "transpose",
    "dijkstra_numpy",
    "PhasedResult",
    "CriterionPolicy",
    "PhasePolicy",
    "canonical_spec",
    "policy_for",
    "DEFAULT_CRITERION",
    "EMPTY_LANE",
    "KEEP_LANE",
    "BatchedResult",
    "BatchState",
    "harvest",
    "init_batch_state",
    "lanes_active",
    "reset_lane",
    "reset_lanes",
    "run_phased_static",
    "run_phased_static_batch",
    "step_batch",
]
