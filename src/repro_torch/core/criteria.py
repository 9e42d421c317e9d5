"""Criterion plans for the port (counterpart of ``repro.core.criteria``).

Criterion names, their canonical order and the :class:`CritPlan` lowering
are pure metadata and are copied as they are, so both packages lower every
criterion string to the same plan. The settle masks are the reference's
float ops on torch tensors. The dense reference semantics (``evaluate``
and the ``crit_*`` functions over COO edges) come with ``run_phased``
(ROADMAP Queue 1 item 3).

Status encoding: 0 = U (unexplored), 1 = F (fringe), 2 = S (settled).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

INF = float("inf")
U, F, S = 0, 1, 2

# Every registered criterion, in the fixed canonical order (IN family, OUT
# family, oracle): ``parse`` sorts by it so every spelling of one
# disjunction lowers to one canonical string and one plan.
CRITERIA = (
    "dijk", "instatic", "insimple", "in",
    "outstatic", "outsimple", "outweak", "out",
    "oracle",
)


def parse(criterion: str) -> tuple[str, ...]:
    """Parse a '|'-joined criterion string into canonical name order
    (deduplicated; disjunction is commutative and idempotent)."""
    names = {s.strip().lower() for s in criterion.split("|")}
    for nm in names:
        if nm not in CRITERIA:
            raise ValueError(f"unknown criterion {nm!r}; have {sorted(CRITERIA)}")
    return tuple(nm for nm in CRITERIA if nm in names)


def canonical(criterion: str) -> str:
    """The canonical spelling of a criterion string (parse then re-join)."""
    return "|".join(parse(criterion))


class KeySpec(NamedTuple):
    """One dynamic per-vertex key: ``key[v] = min_u gate[u] + c`` over the
    ``side`` adjacency of v, where ``gate`` is elementwise in status.

    gate == "unsettled":  gate[u] = 0 if status[u] < S else +inf
    gate == "twohop":     gate[u] = 0 if F, ``aux``[u] if U, +inf if S
    """

    name: str
    side: str  # "in" | "out"
    gate: str  # "unsettled" | "twohop"
    aux: str | None


_KEY_SPECS = {
    "in_dyn": KeySpec("in_dyn", "in", "unsettled", None),  # INSIMPLE, Eq. 6
    "in_full": KeySpec("in_full", "in", "twohop", "in_static"),  # IN, Eq. 1
    "out_dyn": KeySpec("out_dyn", "out", "unsettled", None),  # OUTSIMPLE, Eq. 7
    "out_weak": KeySpec("out_weak", "out", "twohop", "out_static"),  # Eq. 3
    "out_full": KeySpec("out_full", "out", "twohop", "out_dyn"),  # OUT, Eq. 2
}

# per criterion name: the IN-family comparison term ("zero" = DIJK's d,
# "static" = in_min_static, else a dynamic key name) or the OUT-family lane
# key ("static" = out_min_static, else a dynamic key name)
_IN_TERM = {"dijk": "zero", "instatic": "static", "insimple": "in_dyn",
            "in": "in_full"}
_OUT_TERM = {"outstatic": "static", "outsimple": "out_dyn",
             "outweak": "out_weak", "out": "out_full"}


class CritPlan(NamedTuple):
    """Static lowering of a criterion disjunction (see the reference's
    ``CritPlan`` for the scan-fusion fields)."""

    criterion: str  # canonical '|'-joined spelling
    names: tuple[str, ...]  # canonical parsed names
    keys: tuple[KeySpec, ...]  # dynamic keys, deduped, dependencies first
    in_terms: tuple[str, ...]  # IN-family terms ("zero"/"static"/key name)
    out_terms: tuple[str, ...]  # OUT-family lane keys ("static"/key name)
    needs_oracle: bool  # plan reads per-lane dist_true
    needs_fallback: bool  # engine must materialise evaluate()'s DIJK guard
    in_scan_keys: tuple[str, ...]  # keys fused into the relax (in-ELL) scan
    out_scan_keys: tuple[str, ...]  # independent keys of the out-ELL scan
    out_scan_dep: str | None  # dependent out key (gate reads another key)

    @property
    def num_lanes(self) -> int:
        """Threshold lanes the fused frontier reduction produces."""
        return 1 + len(self.out_terms)

    @property
    def needs_out_adjacency(self) -> bool:
        return any(k.side == "out" for k in self.keys)

    @property
    def dynamic(self) -> bool:
        return bool(self.keys)


def plan_for(criterion: str) -> CritPlan:
    """Lower a criterion string into the :class:`CritPlan` the engines run,
    memoised on the canonical spelling."""
    return _plan_for_canonical(canonical(criterion))


@functools.lru_cache(maxsize=None)
def _plan_for_canonical(criterion: str) -> CritPlan:
    names = parse(criterion)
    keys: list[KeySpec] = []

    def _need(key_name: str):
        spec = _KEY_SPECS[key_name]
        if spec.aux in _KEY_SPECS:  # dependency key must be computed first
            _need(spec.aux)
        if spec not in keys:
            keys.append(spec)

    in_terms: list[str] = []
    out_terms: list[str] = []
    for nm in names:
        if nm in _IN_TERM:
            t = _IN_TERM[nm]
            if t not in ("zero", "static"):
                _need(t)
            in_terms.append(t)
        elif nm in _OUT_TERM:
            t = _OUT_TERM[nm]
            if t != "static":
                _need(t)
            out_terms.append(t)
    # scan-fusion marking, with the reference's plan-time guards
    in_scan: list[str] = []
    out_scan: list[str] = []
    out_dep: str | None = None
    for spec in keys:
        if spec.side == "in":
            if spec.aux in _KEY_SPECS:
                raise NotImplementedError(
                    f"in-side key {spec.name!r} depends on key {spec.aux!r}; "
                    f"the fused in-scan only lowers status-elementwise gates"
                )
            in_scan.append(spec.name)
        elif spec.aux in _KEY_SPECS:
            if out_dep is not None:
                raise NotImplementedError(
                    f"two dependent out-side keys ({out_dep!r}, "
                    f"{spec.name!r}); the fused out-scan lowers at most one"
                )
            if _KEY_SPECS[spec.aux].side != "out":
                raise NotImplementedError(
                    f"out-side key {spec.name!r} depends on the in-side key "
                    f"{spec.aux!r}; no fused lowering"
                )
            out_dep = spec.name
        else:
            out_scan.append(spec.name)
    return CritPlan(
        criterion="|".join(names),
        names=names,
        keys=tuple(keys),
        in_terms=tuple(in_terms),
        out_terms=tuple(out_terms),
        needs_oracle="oracle" in names,
        needs_fallback=names == ("oracle",),
        in_scan_keys=tuple(in_scan),
        out_scan_keys=tuple(out_scan),
        out_scan_dep=out_dep,
    )


def key_gate(spec: KeySpec, status: torch.Tensor, in_min_static: torch.Tensor,
             out_min_static: torch.Tensor, keys: dict) -> torch.Tensor:
    """The elementwise gate vector of a dynamic key, shaped like ``status``
    (``(n,)`` static minima broadcast over ``(B, n)`` status). ``keys`` maps
    already-computed key names to tensors (the ``out_full`` dependency)."""
    if spec.gate == "unsettled":
        return torch.where(status < S, 0.0, INF).to(torch.float32)
    if spec.aux == "in_static":
        aux = in_min_static
    elif spec.aux == "out_static":
        aux = out_min_static
    else:
        aux = keys[spec.aux]
    return torch.where(
        status == F, 0.0, torch.where(status == U, aux, INF)
    ).to(torch.float32)


def in_scan_gate_parts(spec: KeySpec, status: torch.Tensor,
                       settle: torch.Tensor, in_min_static: torch.Tensor):
    """Gate parts ``(ga, gb, gc)`` of the fused in-scan's sweep-1 keys.

    The fused scan evaluates the key gate on the *post-phase* status as
    ``min(ga, gb, gc + fin)``, ``fin[u] = 0`` iff the relax update of u is
    finite (u joins the fringe) else +inf:

      unsettled gate: ga = +inf on settle | S, 0 elsewhere; gb = gc = +inf.
      twohop gate (aux static): ga = 0 on F & ~settle; gb = aux on U;
        gc = 0 on U.

    Every branch value is exact and min does not round, so the result is
    bit-identical to :func:`key_gate` on the materialised new status.
    """
    if spec.gate == "unsettled":
        ga = torch.where(settle | (status == S), INF, 0.0).to(torch.float32)
        gb = torch.full_like(ga, INF)
        return ga, gb, gb
    assert spec.aux == "in_static", spec  # guarded at plan time
    ga = torch.where((status == F) & ~settle, 0.0, INF).to(torch.float32)
    gb = torch.where(status == U, in_min_static, INF).to(torch.float32)
    gc = torch.where(status == U, 0.0, INF).to(torch.float32)
    return ga, gb, gc


def dep_gate_parts(spec: KeySpec, status: torch.Tensor):
    """Gate parts ``(dga, dgb)`` of the fused out-scan's dependent key:
    ``key_gate(spec, status) == min(dga, dgb + aux_key)`` elementwise (0 on
    F, ``aux_key`` on U, +inf on S; exact for ``aux_key >= 0`` incl. +inf)."""
    assert spec.gate == "twohop" and spec.aux in _KEY_SPECS, spec
    dga = torch.where(status == F, 0.0, INF).to(torch.float32)
    dgb = torch.where(status == U, 0.0, INF).to(torch.float32)
    return dga, dgb


def attribution_terms(plan: CritPlan) -> tuple[str, ...]:
    """Names of the plan's settle-attribution slots, in recorded order:
    one per member (IN family, OUT family, oracle), plus
    ``"dijk_fallback"`` for bare-oracle plans."""
    terms = [nm for nm in plan.names if nm in _IN_TERM]
    terms += [nm for nm in plan.names if nm in _OUT_TERM]
    if plan.needs_oracle:
        terms.append("oracle")
    if plan.needs_fallback:
        terms.append("dijk_fallback")
    return tuple(terms)


def plan_term_masks(plan: CritPlan, d: torch.Tensor, fringe: torch.Tensor,
                    mins: torch.Tensor, keys: dict,
                    in_min_static: torch.Tensor,
                    dist_true: torch.Tensor | None) -> list[torch.Tensor]:
    """Per-member settle masks (each restricted to the fringe), in
    :func:`attribution_terms` order minus the fallback slot.

    The expressions are the reference's, op for op: at the source
    ``d - in_min_static`` is ``0 - inf = -inf`` (it settles) and off the
    fringe it may be ``inf - inf = NaN``, which the ``fringe &`` masks.
    """
    min_fd = mins[0][:, None]
    masks: list[torch.Tensor] = []
    for t in plan.in_terms:
        if t == "zero":  # DIJK: d <= min_F d
            masks.append(fringe & (d <= min_fd))
        elif t == "static":  # INSTATIC, Eq. 4
            masks.append(fringe & (d - in_min_static <= min_fd))
        else:  # INSIMPLE / IN via the dynamic key
            masks.append(fringe & (d - keys[t] <= min_fd))
    for i in range(len(plan.out_terms)):  # OUT family: d <= L_k
        masks.append(fringe & (d <= mins[1 + i][:, None]))
    if plan.needs_oracle:
        tol = 1e-6 + 1e-6 * torch.abs(dist_true)
        masks.append(fringe & (d <= dist_true + tol))
    return masks


def plan_union_mask(plan: CritPlan, d: torch.Tensor, fringe: torch.Tensor,
                    mins: torch.Tensor, keys: dict,
                    in_min_static: torch.Tensor,
                    dist_true: torch.Tensor | None) -> torch.Tensor:
    """The plan's settle mask over batched state (the union of
    :func:`plan_term_masks`), before any DIJK fallback."""
    settle = torch.zeros_like(fringe)
    for m in plan_term_masks(plan, d, fringe, mins, keys, in_min_static,
                             dist_true):
        settle = settle | m
    return settle
