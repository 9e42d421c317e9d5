"""Correctness criteria and criterion plans for the port (counterpart of
``repro.core.criteria``).

Every criterion is a sound predicate over fringe vertices: ``crit(v)`` true
implies ``d[v] == dist(s, v)``, so a phase settles every matching vertex
at once. The dense semantics (:class:`CritContext`, the ``crit_*``
functions and :func:`evaluate`) are masked reductions over the COO edge
arrays, the reference's float ops on torch tensors; ``run_phased`` runs on
them and the stepper's plans are held against them. Criterion names, their
canonical order and the :class:`CritPlan` lowering are pure metadata and
are copied as they are, so both packages lower every criterion string to
the same plan.

Status encoding: 0 = U (unexplored), 1 = F (fringe), 2 = S (settled).
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch

from repro_torch.kernels import ref as kref

INF = float("inf")
U, F, S = 0, 1, 2
_EPS_F32 = float(torch.tensor(1e-6, dtype=torch.float32))  # 1e-6 in f32

# Every registered criterion, in the fixed canonical order (IN family, OUT
# family, oracle): ``parse`` sorts by it so every spelling of one
# disjunction lowers to one canonical string and one plan.
CRITERIA = (
    "dijk", "instatic", "insimple", "in",
    "outstatic", "outsimple", "outweak", "out",
    "oracle",
)



class CritContext(NamedTuple):
    """Everything a criterion may read, as tensors on one device."""

    src: torch.Tensor  # (m,) int32
    dst: torch.Tensor  # (m,) int32
    w: torch.Tensor  # (m,) f32, +inf padding
    in_min_static: torch.Tensor  # (n,) f32
    out_min_static: torch.Tensor  # (n,) f32
    d: torch.Tensor  # (n,) f32 tentative distances
    status: torch.Tensor  # (n,) int8
    fringe: torch.Tensor  # (n,) bool == (status == F)
    min_fringe_d: torch.Tensor  # 0-dim f32: min_{u in F} d[u]
    dist_true: torch.Tensor  # (n,) f32; only ORACLE reads it


def _segmin(vals, idx, n):
    return kref.segment_min(vals, idx, n)


def _out_min_dynamic(ctx: CritContext) -> torch.Tensor:
    """min over outgoing edges with an unsettled target (F + U)."""
    unsettled_dst = ctx.status[ctx.dst.long()] < S
    vals = torch.where(unsettled_dst, ctx.w, INF)
    return _segmin(vals, ctx.src, ctx.d.shape[0])


def oracle_tolerance(dist_true: torch.Tensor) -> torch.Tensor:
    """``1e-6 + 1e-6 * |dist_true|`` in f32 as the reference's compiled
    engines give it: XLA fuses the multiply and the add into one FMA (one
    rounding; an eager two-step f32 form differs in about a quarter of the
    values). The product of two f32 is exact in f64; the f64 sum is made
    round-to-odd from its exact error, so rounding it to f32 once gives the
    FMA's bits on any device. ``eps`` rides as a Python float (the f32
    value of 1e-6, exact in f64), so nothing is copied to the device: the
    stepper captures this in a CUDA graph."""
    eps = _EPS_F32
    p = eps * torch.abs(dist_true).double()  # exact
    s = p + eps
    bv = s - p
    err = (p - (s - bv)) + (eps - bv)  # s + err == p + eps exactly
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, INF, -INF).double()
    odd = (err != 0) & torch.isfinite(err) & even
    s = torch.where(odd, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


# --- IN family: d[v] - (best incoming slack) <= min_F d --------------------

def crit_dijk(ctx: CritContext) -> torch.Tensor:
    return ctx.fringe & (ctx.d <= ctx.min_fringe_d)


def crit_instatic(ctx: CritContext) -> torch.Tensor:
    """Eq. 4 (Crauser): static min over ALL incoming edges."""
    return ctx.fringe & (ctx.d - ctx.in_min_static <= ctx.min_fringe_d)


def crit_insimple(ctx: CritContext) -> torch.Tensor:
    """Eq. 6: min over incoming edges whose source is unsettled (F + U)."""
    n = ctx.d.shape[0]
    vals = torch.where(ctx.status[ctx.src.long()] < S, ctx.w, INF)
    in_dyn = _segmin(vals, ctx.dst, n)
    return ctx.fringe & (ctx.d - in_dyn <= ctx.min_fringe_d)


def crit_in(ctx: CritContext) -> torch.Tensor:
    """Eq. 1 (full IN): sources in F contribute c(w,v); sources in U the
    two-hop slack c(w,v) + min-in-edge(w)."""
    n = ctx.d.shape[0]
    src = ctx.src.long()
    st = ctx.status[src]
    vals = torch.where(
        st == F, ctx.w,
        torch.where(st == U, ctx.w + ctx.in_min_static[src], INF),
    )
    in_key = _segmin(vals, ctx.dst, n)
    return ctx.fringe & (ctx.d - in_key <= ctx.min_fringe_d)


# --- OUT family: d[v] <= L where L = min_{u in F} (d[u] + best out slack) ---

def _out_mask(ctx: CritContext, out_key: torch.Tensor) -> torch.Tensor:
    lhs = torch.where(ctx.fringe, ctx.d + out_key, INF)
    return ctx.fringe & (ctx.d <= kref.amin(lhs))


def crit_outstatic(ctx: CritContext) -> torch.Tensor:
    """Eq. 5 (Crauser): static min over ALL outgoing edges."""
    return _out_mask(ctx, ctx.out_min_static)


def crit_outsimple(ctx: CritContext) -> torch.Tensor:
    """Eq. 7: min over outgoing edges with an unsettled target (F + U)."""
    return _out_mask(ctx, _out_min_dynamic(ctx))


def crit_outweak(ctx: CritContext) -> torch.Tensor:
    """Eq. 3: full OUT with the two-hop term made static."""
    n = ctx.d.shape[0]
    dst = ctx.dst.long()
    st = ctx.status[dst]
    vals = torch.where(
        st == F, ctx.w,
        torch.where(st == U, ctx.w + ctx.out_min_static[dst], INF),
    )
    return _out_mask(ctx, _segmin(vals, ctx.src, n))


def crit_out(ctx: CritContext) -> torch.Tensor:
    """Eq. 2 (full OUT): targets in F contribute c(u,w); targets in U
    c(u,w) + min over w's out-edges that stay in F + U (recomputed by one
    segment-min a phase)."""
    n = ctx.d.shape[0]
    out_dyn = _out_min_dynamic(ctx)
    dst = ctx.dst.long()
    st = ctx.status[dst]
    vals = torch.where(
        st == F, ctx.w,
        torch.where(st == U, ctx.w + out_dyn[dst], INF),
    )
    return _out_mask(ctx, _segmin(vals, ctx.src, n))


def crit_oracle(ctx: CritContext) -> torch.Tensor:
    """Clairvoyant bound: settle v once d[v] == dist(s, v), within
    :func:`oracle_tolerance`."""
    return ctx.fringe & (ctx.d <= ctx.dist_true
                         + oracle_tolerance(ctx.dist_true))


REGISTRY: dict[str, Callable[[CritContext], torch.Tensor]] = {
    "dijk": crit_dijk,
    "instatic": crit_instatic,
    "outstatic": crit_outstatic,
    "insimple": crit_insimple,
    "outsimple": crit_outsimple,
    "in": crit_in,
    "out": crit_out,
    "outweak": crit_outweak,
    "oracle": crit_oracle,
}
# a REGISTRY name missing from the canonical order would pass parse's
# validation yet never be applied: fail at import instead
assert set(CRITERIA) == set(REGISTRY), set(CRITERIA) ^ set(REGISTRY)


def evaluate(names: tuple[str, ...], ctx: CritContext) -> torch.Tensor:
    """Disjunction of criteria, with a DIJK fallback guard: every criterion
    is complete, so the fallback fires only where float rounding leaves
    the mask empty (the bare oracle's tolerance)."""
    mask = torch.zeros_like(ctx.fringe)
    for nm in names:
        mask = mask | REGISTRY[nm](ctx)
    return torch.where(torch.any(mask), mask, crit_dijk(ctx))


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
        masks.append(fringe & (d <= dist_true + oracle_tolerance(dist_true)))
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
