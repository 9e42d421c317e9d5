"""Phase policies: the settle-decision layer of the stepper (counterpart of
``repro.core.policies``).

A :class:`PhasePolicy` decides which fringe vertices a phase settles; the
stepper (``repro_torch.core.static_engine``) owns lane admission, the trip
loop, the work counters and the ring. This slice ports
:class:`CriterionPolicy` for plans with no dynamic keys and no oracle:
``dijk``, ``instatic``, ``outstatic`` and their disjunctions, the default
``instatic|outstatic`` among them. Each phase of such a plan runs the two
kernels of the main path, ``frontier_crit_lanes_batch`` (through
``crit_thresholds_batch``) and ``ell_relax_batch`` (through
``relax_settled_batch``); the rest is elementwise glue.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.core import criteria as C
from repro_torch.core.graph import Graph
from repro_torch.kernels import ops as kops

INF = float("inf")

DELTA_SPEC = "delta"  # the canonical spec string of delta-stepping


class PhaseOutcome(NamedTuple):
    """What one policy phase hands back to the stepper chassis."""

    dist: torch.Tensor  # (B, n) f32 post-phase tentative distances
    status: torch.Tensor  # (B, n) int32 post-phase status (0=U, 1=F, 2=S)
    n_fringe: torch.Tensor  # (B,) int32 |F| at phase entry (the live gauge)
    n_settled: torch.Tensor  # (B,) int32 vertices settled this phase
    relax_inc: torch.Tensor  # (B,) int64 out-edges relaxed this phase


class PhasePolicy:
    """Interface of a settle policy. Instances are cached per canonical
    spec by :func:`policy_for` and hold no state beyond their plan."""

    spec: str  # canonical spec string (== BatchState.criterion)

    def phase_cap(self, n: int) -> int:
        """Default safety cap on loop trips for a full solve over n vertices."""
        raise NotImplementedError

    def phase(self, g: Graph, ell_in, s, use_kernels: bool) -> PhaseOutcome:
        """Advance state ``s`` by one phase."""
        raise NotImplementedError


def _threshold_keys(plan: C.CritPlan, g: Graph):
    """Key stack for the fused lane reduction: None (no OUT members) or the
    shared ``(K, n)`` static stack (all OUT members static)."""
    if not plan.out_terms:
        return None
    return g.out_min_static[None]


class CriterionPolicy(PhasePolicy):
    """Settle policy executing a compiled :class:`~repro_torch.core.criteria.CritPlan`
    with no dynamic keys: the phase body is the reference's, op for op."""

    def __init__(self, plan: C.CritPlan):
        if plan.keys or plan.needs_oracle:
            raise NotImplementedError(
                f"criterion {plan.criterion!r} needs dynamic keys or the "
                "oracle; the port runs only dijk/instatic/outstatic plans so "
                "far (ROADMAP Queue 1 item 5)"
            )
        self.plan = plan
        self.spec = plan.criterion

    def phase_cap(self, n: int) -> int:
        # every live lane settles >= 1 vertex per phase under any criterion
        return n + 1

    def phase(self, g: Graph, ell_in, s, use_kernels: bool) -> PhaseOutcome:
        plan = self.plan
        d, status = s.dist, s.status
        fringe = status == 1
        mins, n_f = kops.crit_thresholds_batch(
            d, status, _threshold_keys(plan, g), use_kernels=use_kernels
        )
        settle = C.plan_union_mask(
            plan, d, fringe, mins, {}, g.in_min_static, None
        )
        upd = kops.relax_settled_batch(
            d, settle, ell_in[0], ell_in[1], use_kernels=use_kernels
        )
        new_d = torch.minimum(d, upd)
        new_status = torch.where(
            settle, 2, torch.where((status == 0) & (upd < INF), 1, status)
        ).to(torch.int32)
        n_settled = settle.sum(dim=1, dtype=torch.int32)
        relax_inc = torch.where(settle, s.out_deg[None], 0).sum(
            dim=1, dtype=torch.int64
        )
        return PhaseOutcome(
            dist=new_d, status=new_status, n_fringe=n_f,
            n_settled=n_settled, relax_inc=relax_inc,
        )


def canonical_spec(spec: str) -> str:
    """Canonicalise a policy spec: ``"delta"`` or any criterion string."""
    if isinstance(spec, str) and spec.strip().lower() == DELTA_SPEC:
        return DELTA_SPEC
    return C.canonical(spec)


@functools.lru_cache(maxsize=None)
def _policy_for_canonical(spec: str) -> PhasePolicy:
    if spec == DELTA_SPEC:
        raise NotImplementedError(
            "delta-stepping (DeltaPolicy) is not ported yet "
            "(ROADMAP Queue 1 item 6)"
        )
    return CriterionPolicy(C.plan_for(spec))


def policy_for(spec: str) -> PhasePolicy:
    """The (cached) :class:`PhasePolicy` a spec string selects."""
    return _policy_for_canonical(canonical_spec(spec))
