"""Phase policies: the settle-decision layer of the stepper (counterpart of
``repro.core.policies``).

A :class:`PhasePolicy` decides which fringe vertices a phase settles; the
stepper (``repro_torch.core.static_engine``) owns lane admission, the trip
loop, the work counters and the ring. :class:`CriterionPolicy` runs every
plan without the oracle. Per phase:

  * plans with out-side dynamic keys scan the outgoing ELL once
    (``out_scan_keys_batch``: ``ell_gather_min_batch``, or
    ``ell_keys_dep_batch`` when ``out_full`` depends on ``out_dyn``);
  * every plan reduces the fringe once (``frontier_crit_lanes_batch``,
    with shared static keys or per-lane dynamic ones);
  * plans with in-side keys relax through the fused in-scan
    (``ell_relax_keys_batch``), which also emits the next phase's in-side
    keys; the others, the default ``instatic|outstatic`` among them, relax
    by a push along the OUTGOING view (``ell_push_relax_batch``), which
    reads only the out-rows of the vertices settled this phase, so they
    read the outgoing view too (``needs_out_adjacency``).

On the degree-sliced layout each of these runs its sliced kernel instead
(``ell_sliced_keys_dep_batch``, ``ell_sliced_relax_keys_batch``,
``ell_sliced_push_relax_batch``); the ops layer picks it by the view's type.

Carried in-side keys are re-primed (``ell_key_min_batch``) once per
``step_batch`` call after admission touched a lane.
"""
from __future__ import annotations

import dataclasses
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
    crit_keys: torch.Tensor | None  # (K, B, n) f32 carried stack (or None)
    n_fringe: torch.Tensor  # (B,) int32 |F| at phase entry (the live gauge)
    n_settled: torch.Tensor  # (B,) int32 vertices settled this phase
    relax_inc: torch.Tensor  # (B,) int64 out-edges relaxed this phase


class PhasePolicy:
    """Interface of a settle policy. Instances are cached per canonical
    spec by :func:`policy_for` and hold no state beyond their plan."""

    spec: str  # canonical spec string (== BatchState.criterion)
    needs_out_adjacency: bool = False  # phase reads the outgoing ELL

    def num_key_slots(self) -> int:
        """Depth K of the carried ``crit_keys`` stack (0 = no stack)."""
        raise NotImplementedError

    def fresh_keys(self, b: int, n: int, device) -> torch.Tensor | None:
        """(K, B, n) carried-stack values of a freshly admitted lane."""
        raise NotImplementedError

    def init_keys_valid(self) -> bool | None:
        """Initial ``keys_valid`` flag (None when the policy never primes)."""
        return None

    def phase_cap(self, n: int) -> int:
        """Default safety cap on loop trips for a full solve over n vertices."""
        raise NotImplementedError

    def prime(self, g: Graph, ell_in, state, use_kernels: bool):
        """Once-per-chunk invariant repair before entering the loop."""
        return state

    def phase(self, g: Graph, ell_in, ell_out, s,
              use_kernels: bool) -> PhaseOutcome:
        """Advance state ``s`` by one phase."""
        raise NotImplementedError


def _spec_by_name(plan: C.CritPlan, name: str) -> C.KeySpec:
    return plan.keys[[k.name for k in plan.keys].index(name)]


def _compute_out_keys(plan: C.CritPlan, g: Graph, status, ell_out,
                      use_kernels: bool) -> dict:
    """The plan's out-side dynamic keys for the current status, from ONE
    fused scan over the outgoing adjacency: name -> (B, n) f32.

    Independent keys (elementwise gates) share the scan; the dependent
    ``out_full`` adds the second sweep, gated by the ``out_dyn`` the first
    sweep produced (paper Eq. 2's two-hop slack). Keys whose gates are all
    "unsettled" (``out_dyn`` alone: ``outsimple`` plans) go through
    :func:`_key_for`, which reads that gate from status.
    """
    if not (plan.out_scan_keys or plan.out_scan_dep):
        return {}
    specs = [_spec_by_name(plan, nm) for nm in plan.out_scan_keys]
    if plan.out_scan_dep is None and all(sp.gate == "unsettled"
                                         for sp in specs):
        return {sp.name: _key_for(sp, g, status, ell_out, use_kernels)
                for sp in specs}
    gates = torch.stack([
        C.key_gate(sp, status, g.in_min_static, g.out_min_static, {})
        for sp in specs
    ])
    dep_parts = None
    names = list(plan.out_scan_keys)
    if plan.out_scan_dep is not None:
        spec = _spec_by_name(plan, plan.out_scan_dep)
        dga, dgb = C.dep_gate_parts(spec, status)
        dep_parts = (dga, dgb, plan.out_scan_keys.index(spec.aux))
        names.append(plan.out_scan_dep)
    keys = kops.out_scan_keys_batch(gates, dep_parts, ell_out,
                                    use_kernels=use_kernels)
    return {nm: keys[i] for i, nm in enumerate(names)}


def _key_for(spec: C.KeySpec, g: Graph, status, ell,
             use_kernels: bool) -> torch.Tensor:
    """One status-elementwise dynamic key (B, n) over ``ell``: the ops
    layer picks the gather by the gate's kind (an "unsettled" gate is read
    from status on the padded layout)."""
    return kops.key_min_batch_for(
        spec.gate, status,
        lambda: C.key_gate(spec, status, g.in_min_static, g.out_min_static,
                           {}),
        ell, use_kernels=use_kernels)


def _recompute_in_keys(plan: C.CritPlan, g: Graph, status, ell_in,
                       use_kernels: bool) -> torch.Tensor:
    """(K_in, B, n) in-side keys for the *current* status via key-min
    passes: the priming path after admission; the steady state carries
    them out of the fused in-scan instead."""
    return torch.stack([
        _key_for(_spec_by_name(plan, nm), g, status, ell_in, use_kernels)
        for nm in plan.in_scan_keys
    ])


def _in_slot_indices(plan: C.CritPlan) -> list[int]:
    """Positions of the in-scan keys inside the ``plan.keys`` stack."""
    order = [k.name for k in plan.keys]
    return [order.index(nm) for nm in plan.in_scan_keys]


def _threshold_keys(plan: C.CritPlan, g: Graph, keys: dict, b: int):
    """Key stack for the fused lane reduction: None (no OUT members),
    ``(K, n)`` shared (all static: the default plan pays no per-lane key
    traffic), or ``(K, B, n)`` per-lane (any dynamic OUT key)."""
    if not plan.out_terms:
        return None
    if all(t == "static" for t in plan.out_terms):
        return g.out_min_static[None]
    return torch.stack([
        g.out_min_static.expand(b, g.n) if t == "static" else keys[t]
        for t in plan.out_terms
    ])


class CriterionPolicy(PhasePolicy):
    """Settle policy executing a compiled
    :class:`~repro_torch.core.criteria.CritPlan`; the phase body is the
    reference's, op for op.

    The carried ``crit_keys`` stack holds the plan's dynamic keys (ordered
    like ``plan.keys``); in-side slots come out of the fused in-scan and
    are re-primed once per chunk when admission invalidated them
    (``keys_valid``). Oracle plans are not ported and raise.
    """

    def __init__(self, plan: C.CritPlan):
        if plan.needs_oracle:
            raise NotImplementedError(
                f"criterion {plan.criterion!r} needs the oracle (dist_true "
                "rows); oracle plans are not ported to the PyTorch package "
                "yet (ROADMAP Queue 1 item 5)"
            )
        self.plan = plan
        self.spec = plan.criterion

    @property
    def needs_out_adjacency(self) -> bool:
        # out-side keys scan it; a plan without in-side keys pushes its
        # relax along it (one with them relaxes in the fused in-scan)
        return self.plan.needs_out_adjacency or not self.plan.in_scan_keys

    def num_key_slots(self) -> int:
        return len(self.plan.keys)

    def fresh_keys(self, b: int, n: int, device) -> torch.Tensor | None:
        k = self.num_key_slots()
        if not k:
            return None
        return torch.zeros((k, b, n), dtype=torch.float32, device=device)

    def init_keys_valid(self) -> bool | None:
        return False if self.plan.in_scan_keys else None

    def phase_cap(self, n: int) -> int:
        # every live lane settles >= 1 vertex per phase under any criterion
        return n + 1

    def prime(self, g: Graph, ell_in, state, use_kernels: bool):
        in_slots = _in_slot_indices(self.plan)
        if not in_slots:
            return state
        keys = state.crit_keys
        if not state.keys_valid:
            # admission (init / reset) touches status without scanning the
            # adjacency, so the carried slots may be stale. Recomputing
            # equals the carried values bitwise wherever they were valid
            # (exact min), so once per chunk restores the invariant the
            # phase relies on: in-side slots match the status.
            keys = keys.clone()
            keys[in_slots] = _recompute_in_keys(self.plan, g, state.status,
                                                ell_in, use_kernels)
        return dataclasses.replace(state, crit_keys=keys, keys_valid=True)

    def phase(self, g: Graph, ell_in, ell_out, s,
              use_kernels: bool) -> PhaseOutcome:
        plan = self.plan
        b = s.num_lanes
        in_slots = _in_slot_indices(plan)
        d, status = s.dist, s.status
        fringe = status == 1
        # --- out-scan: every out-side dynamic key from one kernel call
        keys = _compute_out_keys(plan, g, status, ell_out, use_kernels)
        # in-side keys ride in from the previous phase's in-scan (or the
        # pre-loop priming); by invariant they match the current status
        for i, nm in zip(in_slots, plan.in_scan_keys):
            keys[nm] = s.crit_keys[i]
        mins, n_f = kops.crit_thresholds_batch(
            d, status, _threshold_keys(plan, g, keys, b),
            use_kernels=use_kernels,
        )
        settle = C.plan_union_mask(
            plan, d, fringe, mins, keys, g.in_min_static, None
        )
        # --- relax this phase: plans with in-side keys in the in-scan, which
        # also emits the NEXT phase's keys from the same kernel call; the
        # others by the push along the outgoing view
        next_in = None
        if in_slots:
            # key gates encode the post-settle status
            parts = [
                C.in_scan_gate_parts(_spec_by_name(plan, nm), status, settle,
                                     g.in_min_static[None])
                for nm in plan.in_scan_keys
            ]
            # the sliced in-scan relaxes by the push along the out-view
            # where the plan holds one (its out-side keys read it)
            push_view = (ell_out if kops._is_sliced(ell_in)
                         and kops._is_sliced(ell_out) else None)
            upd, next_in = kops.in_scan_relax_keys_batch(
                d, settle, parts, ell_in, out_view=push_view,
                use_kernels=use_kernels
            )
        elif kops._is_sliced(ell_out):
            upd = kops.push_settled_batch_sliced(
                d, settle, ell_out, use_kernels=use_kernels
            )
        else:
            upd = kops.push_settled_batch(
                d, settle, ell_out[0], ell_out[1], use_kernels=use_kernels
            )
        # d >= +0 and upd = d + w >= +0 (+0 + -0 is +0): no -0 reaches this
        # min, so torch.minimum's choice between zeros never shows
        new_d = torch.minimum(d, upd)
        new_status = torch.where(
            settle, 2, torch.where((status == 0) & (upd < INF), 1, status)
        ).to(torch.int32)
        n_settled = settle.sum(dim=1, dtype=torch.int32)
        relax_inc = torch.where(settle, s.out_deg[None], 0).sum(
            dim=1, dtype=torch.int64
        )
        crit_keys = s.crit_keys
        if plan.keys:
            crit_keys = torch.stack([keys[k.name] for k in plan.keys])
            for j, i in enumerate(in_slots):
                crit_keys[i] = next_in[j]
        return PhaseOutcome(
            dist=new_d, status=new_status, crit_keys=crit_keys,
            n_fringe=n_f, n_settled=n_settled, relax_inc=relax_inc,
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
