"""Phase policies: the settle-decision layer of the stepper (counterpart of
``repro.core.policies``).

A :class:`PhasePolicy` decides which fringe vertices a phase settles; the
stepper (``repro_torch.core.static_engine``) owns lane admission, the trip
loop, the work counters and the rings. A policy's ``prepare`` builds the
loop-invariant operands once a ``step_batch`` call, and ``phase`` runs one
trip on them. :class:`CriterionPolicy` runs every criterion plan, oracle
plans (``dist_true`` rows, with the per-lane DIJK fallback of the bare
oracle) included. Per phase:

  * plans with out-side dynamic keys scan the outgoing ELL once
    (``out_scan_keys_batch``: ``ell_gather_min_batch``, or
    ``ell_keys_dep_batch`` when ``out_full`` depends on ``out_dyn``);
  * every plan reduces the fringe once (``frontier_crit_lanes_batch``,
    with shared static keys or per-lane dynamic ones);
  * on a target-enabled state, the relax sources are gated by the s->t
    bound (``relax_from = settle & (d < d[target])``), and ``relax_inc``
    counts the out-edges of ``relax_from``;
  * plans with in-side keys relax through the fused in-scan
    (``ell_relax_keys_batch``), which also emits the next phase's in-side
    keys; the others, the default ``instatic|outstatic`` among them, relax
    by a push along the OUTGOING view, which reads only the out-rows of
    the vertices settled this phase, so they read the outgoing view too
    (``needs_out_adjacency``);
  * those push plans, without the oracle (:attr:`CriterionPolicy.commits`),
    commit the phase through
    the settle mark and the worklist push (``kernels/settle_push.py``,
    ``ops.commit_phase``): after #2 the mark decides the settle set from
    #2's per-lane thresholds and the loop predicate, the push lowers
    ``dist`` and sets status in place, and a tail does the stepper's
    counters and rings (the attribution ring's first-true counts included),
    so the phase is #2 and three launches with no pass of PyTorch over
    (B, n) (plans with out-side dynamic keys keep their key scan and the
    carried stack's select). The oracle plans (the bare oracle's DIJK
    fallback needs a per-lane any of the settle mask) keep the phase body
    below, which relaxes by ``ell_push_relax_batch``.

On the degree-sliced layout each of these runs its sliced kernel instead
(``ell_sliced_keys_dep_batch``, ``ell_sliced_relax_keys_batch``,
``ell_sliced_push_relax_batch``, ``ell_sliced_settle_push_batch``); the
ops layer picks it by the view's type.

Carried in-side keys are re-primed (``ell_key_min_batch``) once per
``step_batch`` call after admission touched a lane. On a state with the
attribution ring, the settle mask is built member by member and each
settled vertex is credited to the first member that proved it.

:class:`DeltaPolicy` is delta-stepping (Meyer & Sanders) on the same
stepper, and commits its phase the same way (``ops.commit_delta_phase``):
delta's threshold launch (``ops.delta_thresholds``: the bucket id
``floor(d / delta)`` reduced over the fringe, the fringe size, and the
witness of a light round) and then delta's mark, the worklist push along
the OUTGOING view (the padded one, or on the sliced layout its buckets
alone, ``to_ell_out_buckets``) with the light sources pushing their arcs
of weight <= delta and the heavy ones the others, the weight gate formed as
each arc is read, and the tail: four launches that write ``dist``,
``status``, the carried stack, the counters and the rings in place, with no
pass of PyTorch over (B, n). The reference gathers twice over light and
heavy weight-gated copies of the incoming view (``ops.delta_relax_batch``);
the push gives the same bits and holds no such copy, and delta reads no
in-view at all (its ``in_view`` is None). The carried stack holds the
drain bookkeeping: slot 0 the ``last_processed`` tentative distance, slot 1
the removed-from-bucket flag. A lane is on a light round while a bucket
vertex has ``d < last_processed``; otherwise the phase is its heavy turn,
on which the removed vertices relax their heavy edges and settle. The
bucket is the per-vertex index compare, as in the reference (its docstring
says why the interval compare could livelock in f32).
:meth:`DeltaPolicy.gates` is the plain decision of one phase.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch

from repro_torch.core import criteria as C
from repro_torch.core.graph import (
    Graph,
    out_degrees,
    to_ell_in,
    to_ell_in_sliced,
    to_ell_out,
    to_ell_out_buckets,
    to_ell_out_sliced,
    vertex_row_table,
)
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
    go: torch.Tensor  # 0-dim bool: the loop predicate this phase ran under
    #   (false: the phase wrote nothing, ``dist``/``status``/``crit_keys``
    #   are the state's own bits and ``relax_inc`` / ``n_settled`` are 0)
    attr_counts: torch.Tensor | None = None  # (B, T) int32 attribution
    #   slots, only when the state carries an attribution ring
    committed: bool = False  # the phase wrote the state's buffers in place,
    #   the chassis' counters, rings and target demotion included, and
    #   spent the budget (the pair, ``CriterionPolicy.commits``, and
    #   delta): ``n_settled``, ``relax_inc`` and ``go`` are then None


class PhasePolicy:
    """Interface of a settle policy. Instances are cached per canonical
    spec by :func:`policy_for` and hold no state beyond their plan."""

    spec: str  # canonical spec string (== BatchState.criterion)
    uses_delta: bool = False  # reads BatchState.delta (the bucket width)
    needs_oracle: bool = False  # requires per-lane dist_true rows
    needs_out_adjacency: bool = False  # phase reads the outgoing ELL

    def attribution_terms(self) -> tuple[str, ...]:
        """Names of the per-phase attribution slots, in recorded order."""
        raise NotImplementedError

    def share_terms(self) -> tuple[str, ...]:
        """The attribution slots that are counts (summable into shares):
        what a portfolio record may aggregate. Defaults to all of them."""
        return self.attribution_terms()

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

    def in_view(self, g: Graph, sliced: bool):
        """The incoming view :meth:`prime` and :meth:`phase` read, padded
        or degree-sliced (``sliced``), memoised on the graph; None when
        they read none."""
        return to_ell_in_sliced(g) if sliced else to_ell_in(g)

    def out_view(self, g: Graph, sliced: bool):
        """The outgoing view :meth:`phase` reads, in the layout of the
        in-view (``sliced``), memoised on the graph; None when it reads
        none."""
        if not self.needs_out_adjacency:
            return None
        return to_ell_out_sliced(g) if sliced else to_ell_out(g)

    def prepare(self, g: Graph, ell_in, ell_out, state, use_kernels: bool):
        """Loop-invariant operands of :meth:`phase`, once a ``step_batch``
        call (``ell_in`` is None for a policy that reads no in-view)."""
        raise NotImplementedError

    def chunk_key(self, aux) -> tuple:
        """What a captured chunk of this policy's phases depends on in
        :meth:`prepare`'s ``aux``: views and tensors by identity, scalars
        by value (the stepper keys its memo of captures on it)."""
        return _operand_key(aux)

    def phase(self, g: Graph, aux, s, use_kernels: bool,
              go_of) -> PhaseOutcome:
        """Advance state ``s`` by one phase on :meth:`prepare`'s ``aux``,
        gated on the loop predicate ``go_of(n_fringe)`` (a 0-dim bool
        tensor from the (B,) fringe sizes at the phase's entry; ``go_of``
        also carries its operands ``budget``, ``live0`` and ``stop``): where
        it is false the phase settles and relaxes nothing, so ``dist``,
        ``status`` and ``crit_keys`` come back bit for bit."""
        raise NotImplementedError


def _operand_key(x):
    """A phase operand as a memo key: a scalar by value, a plain tuple
    element by element, anything else (a tensor, a sliced view) by
    identity, which the memo's entry keeps alive."""
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if type(x) is tuple:
        return tuple(_operand_key(e) for e in x)
    return id(x)


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
    (``keys_valid``). ``prepare`` hands the views through, so the plans'
    phase reads them as before.
    """

    def __init__(self, plan: C.CritPlan):
        self.plan = plan
        self.spec = plan.criterion

    @property
    def needs_oracle(self) -> bool:
        return self.plan.needs_oracle

    def attribution_terms(self) -> tuple[str, ...]:
        return C.attribution_terms(self.plan)

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

    @property
    def commits(self) -> bool:
        """Whether the plan's phase commits through the settle mark and the
        worklist push: it relaxes by the push (no in-side keys) and reads no
        oracle."""
        return not self.plan.in_scan_keys and not self.plan.needs_oracle

    def prepare(self, g: Graph, ell_in, ell_out, state, use_kernels: bool):
        """``(ell_in, ell_out, vrows)``: the views, and for the pair on a
        sliced out-view its vertex row table (memoised on the graph)."""
        vrows = (vertex_row_table(g, ell_out) if self.commits
                 and ell_out is not None and kops._is_sliced(ell_out)
                 else None)
        return ell_in, ell_out, vrows

    def phase(self, g: Graph, aux, s, use_kernels: bool,
              go_of) -> PhaseOutcome:
        if self.commits:
            return self._commit(g, aux, s, use_kernels, go_of)
        plan = self.plan
        ell_in, ell_out, _ = aux
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
        term_masks = None
        if s.attr_trace is not None:
            # the attribution ring credits each settled vertex to the first
            # member that proved it, so each member's mask is kept; their
            # union is plan_union_mask's
            term_masks = C.plan_term_masks(
                plan, d, fringe, mins, keys, g.in_min_static, s.dist_true)
            settle = term_masks[0]
            for m in term_masks[1:]:
                settle = settle | m
        else:
            settle = C.plan_union_mask(
                plan, d, fringe, mins, keys, g.in_min_static, s.dist_true)
        if plan.needs_fallback:
            # the bare oracle can leave a non-empty fringe with an empty
            # mask (its tolerance is for f64 truth): evaluate()'s DIJK guard,
            # lane by lane
            dijk = fringe & (d <= mins[0][:, None])
            settle = torch.where(torch.any(settle, dim=1, keepdim=True),
                                 settle, dijk)
        # the loop predicate gates the settle mask: a dead phase settles
        # and relaxes nothing, so dist and status stay its entry's bits
        go = go_of(n_f)
        settle = settle & go
        # --- the s->t bound (target lanes only): the target's current
        # tentative distance. A settled source at or beyond it can never
        # improve the target, so the gated relax drops it; the settle
        # decision is untouched. A target-free state runs none of this.
        relax_from = settle
        if s.target is not None:
            rows = torch.arange(b, device=d.device)
            tcol = s.target.clamp(0, s.n - 1).long()
            bound = torch.where(s.target >= 0, d[rows, tcol], INF)
            relax_from = kops._bound_gate(d, settle, bound)
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
            # key gates keep the FULL settle mask (the post-settle
            # status); only the relax sources are gated
            upd, next_in = kops.in_scan_relax_keys_batch(
                d, relax_from, parts, ell_in, out_view=push_view,
                use_kernels=use_kernels
            )
        elif kops._is_sliced(ell_out):
            upd = kops.push_settled_batch_sliced(
                d, relax_from, ell_out, use_kernels=use_kernels
            )
        else:
            upd = kops.push_settled_batch(
                d, relax_from, ell_out[0], ell_out[1],
                use_kernels=use_kernels
            )
        # d >= +0 and upd = d + w >= +0 (+0 + -0 is +0): no -0 reaches this
        # min, so torch.minimum's choice between zeros never shows
        new_d = torch.minimum(d, upd)
        new_status = torch.where(
            settle, 2, torch.where((status == 0) & (upd < INF), 1, status)
        ).to(torch.int32)
        n_settled = settle.sum(dim=1, dtype=torch.int32)
        relax_inc = torch.where(relax_from, s.out_deg[None], 0).sum(
            dim=1, dtype=torch.int64
        )
        attr_counts = None
        if term_masks is not None:
            # first-true claiming partitions the settled set over the
            # members in canonical order, so the counts sum to n_settled
            claimed = torch.zeros_like(settle)
            counts = []
            for m in term_masks:
                take = m & settle & ~claimed
                counts.append(take.sum(dim=1, dtype=torch.int32))
                claimed = claimed | take
            if plan.needs_fallback:
                # the residual slot: vertices the DIJK guard settled
                counts.append(n_settled - sum(counts))
            attr_counts = torch.stack(counts, dim=1)
        crit_keys = s.crit_keys
        if plan.keys:
            # a dead phase keeps the carried stack: its out-side slots were
            # scanned from an earlier status, and its in-side slots need not
            # be what the in-scan re-emits from the unchanged status (a
            # target lane's demoted fringe, the sign of a zero gate)
            slots = [keys[k.name] for k in plan.keys]
            for j, i in enumerate(in_slots):
                slots[i] = next_in[j]
            crit_keys = torch.where(go, torch.stack(slots), s.crit_keys)
        return PhaseOutcome(
            dist=new_d, status=new_status, crit_keys=crit_keys,
            n_fringe=n_f, n_settled=n_settled, relax_inc=relax_inc, go=go,
            attr_counts=attr_counts,
        )

    def _commit(self, g: Graph, aux, s, use_kernels: bool,
                go_of) -> PhaseOutcome:
        """The phase through the pair: #2, then the mark, the push and the
        tail (``ops.commit_phase``), which write ``s``'s buffers, the
        chassis' counters and rings included, and ``go_of.budget`` in
        place."""
        plan = self.plan
        _, ell_out, vrows = aux
        d, status = s.dist, s.status
        keys = _compute_out_keys(plan, g, status, ell_out, use_kernels)
        mins, n_f = kops.crit_thresholds_batch(
            d, status, _threshold_keys(plan, g, keys, s.num_lanes),
            use_kernels=use_kernels,
        )
        crit_keys = s.crit_keys
        if plan.keys:
            # out-side keys only (the plan has no in-side ones); a dead
            # phase keeps the carried stack. The predicate is read before
            # the tail spends the budget
            crit_keys = torch.where(go_of(n_f), torch.stack(
                [keys[k.name] for k in plan.keys]), s.crit_keys)
        kops.commit_phase(
            kops.CommitBuffers(
                dist=d, status=status, trips=s.trips, phases=s.phases,
                sum_fringe=s.sum_fringe, relax_edges=s.relax_edges,
                settled_trace=s.settled_trace, budget=go_of.budget,
                live0=go_of.live0, out_deg=s.out_deg, target=s.target,
                fringe_trace=s.fringe_trace, relax_trace=s.relax_trace,
                attr_trace=s.attr_trace),
            mins, n_f,
            kops.SettleRule(
                zero="zero" in plan.in_terms,
                in_key=g.in_min_static if "static" in plan.in_terms
                else None,
                stop=go_of.stop),
            ell_out, vrows, use_kernels=use_kernels)
        return PhaseOutcome(
            dist=d, status=status, crit_keys=crit_keys, n_fringe=n_f,
            n_settled=None, relax_inc=None, go=None, committed=True)


def delta_degrees(g: Graph, delta) -> tuple[torch.Tensor, torch.Tensor]:
    """(n,) int32 ``(deg_light, deg_heavy)``: each vertex's out-arcs of
    weight ``<= delta`` (f32) and the others (the COO padding carries w =
    +inf, which ``isfinite`` drops)."""
    if not torch.is_tensor(delta):
        delta = torch.tensor(delta, dtype=torch.float32, device=g.device)
    light = torch.isfinite(g.w) & (g.w <= delta)
    deg_light = torch.zeros((g.n,), dtype=torch.int32,
                            device=g.device).index_add_(
        0, g.src.long(), light.to(torch.int32))
    return deg_light, out_degrees(g) - deg_light


class DeltaGates(NamedTuple):
    """One delta phase's settle decision (:meth:`DeltaPolicy.gates`)."""

    bidx: torch.Tensor  # (B, n) f32 bucket ids on the fringe, +inf off it
    bucket: torch.Tensor  # (B,) the lane's bucket id, +inf on an idle lane
    n_fringe: torch.Tensor  # (B,) int32 |F|
    cur: torch.Tensor  # (B, n) the light round's work set
    heavy_turn: torch.Tensor  # (B,) the lane's drain is done
    heavy_from: torch.Tensor  # (B, n) the removed set on the heavy turn


class DeltaPolicy(PhasePolicy):
    """Delta-stepping (Meyer & Sanders) as a stepper phase policy (see the
    module docstring).

    Attribution slots: ``light`` (bucket vertices processed on a light
    round), ``heavy`` (vertices settled on the heavy turn: it equals the
    settled ring) and ``bucket`` (the lane's bucket id that phase, an id,
    not a count).
    """

    spec = DELTA_SPEC
    uses_delta = True
    needs_out_adjacency = True  # the relax pushes along it

    def attribution_terms(self) -> tuple[str, ...]:
        return ("light", "heavy", "bucket")

    def in_view(self, g: Graph, sliced: bool):
        """None: nothing reads the incoming view, the relax pushes."""
        return None

    def out_view(self, g: Graph, sliced: bool):
        """``to_ell_out(g)``, or on the sliced layout the out-view's
        buckets without its merge plan (``to_ell_out_buckets``): the push
        reads nothing else."""
        return to_ell_out_buckets(g) if sliced else to_ell_out(g)

    def share_terms(self) -> tuple[str, ...]:
        return ("light", "heavy")  # the bucket id is not a count

    def num_key_slots(self) -> int:
        return 2

    def fresh_keys(self, b: int, n: int, device) -> torch.Tensor:
        return torch.stack([
            torch.full((b, n), INF, dtype=torch.float32, device=device),
            torch.zeros((b, n), dtype=torch.float32, device=device),
        ])  # last_processed, removed

    def phase_cap(self, n: int) -> int:
        # light rounds are label-correcting: a bucket may reprocess its
        # vertices several times before its heavy turn (the legacy loop's
        # bound)
        return 4 * n + 16

    def prepare(self, g: Graph, ell_in, ell_out, state, use_kernels: bool):
        """``(ell_out, delta, deg_light, deg_heavy, vrows)``: the out-view
        the push reads, the state's f32 delta as a Python float (read back
        once here, handed to the kernels by value every phase), the light
        and heavy out-degrees of the relax counters and, on a sliced
        out-view, its vertex row table (memoised on the graph), memoised on
        the graph for one (out-view, delta) pair at a time: a server
        stepping in chunks counts them once."""
        delta = float(state.delta)
        hit = g.__dict__.get("_delta_prepare_cache")
        if (hit is not None and hit[1] == delta
                and len(hit[0]) == len(ell_out)
                and all(a is b for a, b in zip(hit[0], ell_out))):
            return hit[2]
        vrows = (vertex_row_table(g, ell_out) if kops._is_sliced(ell_out)
                 else None)
        aux = (ell_out, delta, *delta_degrees(g, state.delta), vrows)
        g.__dict__["_delta_prepare_cache"] = (ell_out, delta, aux)
        return aux

    def chunk_key(self, aux) -> tuple:
        """The out-view by identity and delta by value: the degree counts
        follow from them (``prepare`` may remake them for the same pair)."""
        return _operand_key(aux[:2])

    @staticmethod
    def gates(s, use_kernels: bool = True) -> DeltaGates:
        """The settle decision of one phase on state ``s``: the bucket ids
        over the fringe, reduced to each lane's bucket by
        ``frontier_crit_lanes_batch``, and the light and heavy relax
        gates."""
        d, status = s.dist, s.status
        fringe = status == 1
        # the bucket id of each fringe vertex, an f32 divide by the f32
        # delta; the fused threshold kernel reduces it to the lane's bucket
        # and counts the fringe in one pass
        bidx = torch.where(fringe, torch.floor(d / s.delta), INF)
        mins, n_f = kops.crit_thresholds_batch(bidx, status, None,
                                               use_kernels=use_kernels)
        b_lane = mins[0]  # (B,) current bucket id (+inf on empty lanes)
        cur = fringe & (bidx == b_lane[:, None]) & (d < s.crit_keys[0])
        heavy_turn = ~torch.any(cur, dim=1)  # drain done (or lane idle)
        # light edges from this round's work set, heavy edges from the
        # removed set on the heavy turn
        heavy_from = heavy_turn[:, None] & (s.crit_keys[1] > 0.5)
        return DeltaGates(bidx, b_lane, n_f, cur, heavy_turn, heavy_from)

    def phase(self, g: Graph, aux, s, use_kernels: bool,
              go_of) -> PhaseOutcome:
        """The phase through delta's threshold and its committing pair
        (``ops.commit_delta_phase``), which write ``s``'s buffers, the
        carried stack, the chassis' counters and rings included, and
        ``go_of.budget`` in place."""
        ell_out, delta, deg_light, deg_heavy, vrows = aux
        d, status, keys = s.dist, s.status, s.crit_keys
        mins, counts = kops.delta_thresholds(d, status, keys[0], delta,
                                             use_kernels=use_kernels)
        kops.commit_delta_phase(
            kops.CommitBuffers(
                dist=d, status=status, trips=s.trips, phases=s.phases,
                sum_fringe=s.sum_fringe, relax_edges=s.relax_edges,
                settled_trace=s.settled_trace, budget=go_of.budget,
                live0=go_of.live0, out_deg=s.out_deg, target=s.target,
                fringe_trace=s.fringe_trace, relax_trace=s.relax_trace,
                attr_trace=s.attr_trace, crit_keys=keys),
            mins, counts,
            kops.DeltaRule(delta, deg_light, deg_heavy, go_of.stop),
            ell_out, vrows, use_kernels=use_kernels)
        return PhaseOutcome(
            dist=d, status=status, crit_keys=keys, n_fringe=counts[0],
            n_settled=None, relax_inc=None, go=None, committed=True)


def canonical_spec(spec: str) -> str:
    """Canonicalise a policy spec: ``"delta"`` or any criterion string."""
    if isinstance(spec, str) and spec.strip().lower() == DELTA_SPEC:
        return DELTA_SPEC
    return C.canonical(spec)


@functools.lru_cache(maxsize=None)
def _policy_for_canonical(spec: str) -> PhasePolicy:
    if spec == DELTA_SPEC:
        return DeltaPolicy()
    return CriterionPolicy(C.plan_for(spec))


def policy_for(spec: str) -> PhasePolicy:
    """The (cached) :class:`PhasePolicy` a spec string selects:
    ``"delta"`` selects :class:`DeltaPolicy`, any criterion disjunction its
    :class:`CriterionPolicy`."""
    return _policy_for_canonical(canonical_spec(spec))
