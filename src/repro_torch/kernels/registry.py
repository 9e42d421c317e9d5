"""Kernel contract registry: the checkable inventory of the port's kernels
(counterpart of ``repro.kernels.registry``).

Every kernel wrapper in ``repro_torch.kernels`` registers a
:class:`KernelContract`: its callable, its plain twin as the oracle (bound
by ``ref.py``, the one oracle authority), small representative calls
(:class:`SpecCase`, built from numpy seeds on the CPU) and the
``__global__`` kernels of ``csrc/`` it launches on the card. The audit
(``repro_torch.analysis.kernel_audit``) runs every contract: on the CPU
the dtype discipline and the oracle's output tree; on the card each
kernel's ``ptxas`` resources and the write coverage of every case. A new
kernel is born audited: the lint rule ``unregistered-kernel-module``
refuses a kernel module without a ``register_kernels`` hook, and
:func:`collect` refuses a contract without an oracle.

Registration is pull-based: :func:`collect` imports each module in
:data:`KERNEL_MODULES` and calls its ``register_kernels(registry)``. The
modules import this one inside their hooks only, so the kernel package
stays importable without it.

The contract names are the reference's, plus the port's own kernels: the
pushes ``ell_push_relax_batch`` (#1b) and ``ell_sliced_push_relax_batch``
(#9b), the sliced in-scan in its push form
``ell_sliced_relax_keys_batch_push`` (#10b), the status-gate sweep
``ell_key_min_status_batch`` (#5b), the rectangular push of the sharded
stepper ``ell_push_rect_batch`` (#1b), delta's pushes
``ell_delta_push_batch`` (#5c) and ``ell_sliced_delta_push_batch`` (#9c),
the ops layer's push relaxes, the phase-committing pair that redesigns #1b
and #9b on the push plans' path (``ell_settle_commit_batch``,
``ell_sliced_settle_commit_batch``: the settle mark, the worklist push and
the tail), its delta form that redesigns #5c and #9c on delta's path
(``ell_delta_commit_batch``, ``ell_sliced_delta_commit_batch``: delta's
threshold ``delta_thresholds_batch``, its mark, the worklist push with
delta's weight gate and the tail), and the LM's fixed-order embedding
gradient ``embed_grad``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable

import numpy as np
import torch

# The kernel modules, in dependency order. ``ref`` goes last: it binds the
# oracles onto the contracts the earlier hooks registered.
KERNEL_MODULES = (
    "repro_torch.kernels.ell_relax",
    "repro_torch.kernels.ell_key_min",
    "repro_torch.kernels.ell_relax_keys",
    "repro_torch.kernels.ell_sliced",
    "repro_torch.kernels.frontier_crit",
    "repro_torch.kernels.settle_push",
    "repro_torch.kernels.embed_grad",
    "repro_torch.kernels.ops",
    "repro_torch.kernels.ref",
)


@dataclasses.dataclass(frozen=True)
class SpecCase:
    """One representative call of a kernel wrapper: CPU tensors (the card
    checks move them), Python values and tuples of them."""

    label: str
    args: tuple
    kwargs: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class KernelContract:
    """The auditable contract of one kernel wrapper.

    ``counter_outputs`` marks the output positions that are integer work
    counters (an f32 counter loses counts past 2^24). ``kernels`` names the
    ``__global__`` kernels the wrapper launches on the card (``(source,
    kernel)``; empty for an ops wrapper, which delegates), and
    ``spills_ok`` maps a template instance of one of them
    (``"crit_kernel<7,0>"``, its template values as ptxas names them) to
    the reason a register spill there is accepted; a spill anywhere else
    is a finding.
    """

    name: str
    module: str
    wrapper: Callable
    make_cases: Callable[[], tuple[SpecCase, ...]]
    oracle: Callable | None = None
    counter_outputs: tuple[int, ...] = ()
    kernels: tuple[tuple[str, str], ...] = ()
    spills_ok: dict[str, str] = dataclasses.field(default_factory=dict)
    notes: str = ""


class KernelRegistry:
    """Name -> :class:`KernelContract` map with one-shot oracle binding."""

    def __init__(self):
        self._contracts: dict[str, KernelContract] = {}

    def register(self, contract: KernelContract) -> None:
        if contract.name in self._contracts:
            raise ValueError(f"kernel {contract.name!r} registered twice")
        self._contracts[contract.name] = contract

    def bind_oracle(self, name: str, oracle: Callable) -> None:
        """Attach the plain twin to an already-registered contract."""
        hit = self._contracts.get(name)
        if hit is None:
            raise KeyError(
                f"cannot bind oracle for unregistered kernel {name!r}")
        if hit.oracle is not None:
            raise ValueError(f"kernel {name!r} already has an oracle")
        self._contracts[name] = dataclasses.replace(hit, oracle=oracle)

    def get(self, name: str) -> KernelContract:
        return self._contracts[name]

    def names(self) -> tuple[str, ...]:
        return tuple(sorted(self._contracts))

    def contracts(self) -> tuple[KernelContract, ...]:
        return tuple(self._contracts[k] for k in self.names())

    def modules(self) -> tuple[str, ...]:
        return tuple(sorted({c.module for c in self._contracts.values()}))


def collect() -> KernelRegistry:
    """The full registry, from every module's registration hook. Raises if
    a :data:`KERNEL_MODULES` entry has no ``register_kernels`` hook or a
    contract ends up without an oracle."""
    reg = KernelRegistry()
    for modname in KERNEL_MODULES:
        mod = importlib.import_module(modname)
        hook = getattr(mod, "register_kernels", None)
        if hook is None:
            raise RuntimeError(
                f"kernel module {modname} defines no register_kernels hook")
        hook(reg)
    missing = [c.name for c in reg.contracts() if c.oracle is None]
    if missing:
        raise RuntimeError(f"kernels registered without oracles: {missing}")
    return reg


# ---------------------------------------------------------------------------
# Spec-case fixtures: small, seeded with numpy, CPU tensors
# ---------------------------------------------------------------------------

FIXTURE_N = 10  # the reference's fixture: vertices
FIXTURE_D = 3  # padded degree
FIXTURE_B = 3  # lanes
FIXTURE_K = 2  # key stack depth
# The port's wider cases: (lanes, vertices) with B in {1, 8, 13, 40} and
# n % 4 in {1, 3} (the frontier kernel's head and tail forms).
WIDE_SHAPES = ((1, 13), (8, 11), (13, 13), (40, 11))
SIGNED = (0.0, -0.0, 0.5, 1.0)  # values of the -0 / +0 tie cases
SRC_GATHER = "ell_gather"
SRC_PUSH = "ell_push"
SRC_CRIT = "frontier_crit"
SRC_EMBED = "embed_grad"
# the delta form of the push: its mark and push passes
DELTA_PUSH = ((SRC_PUSH, "delta_mark_kernel"), (SRC_PUSH, "delta_push_kernel"))
FIXTURE_DELTA = 0.5  # a bucket width the signed cases' weights tie with


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _values(rng, shape, signed: bool) -> np.ndarray:
    if signed:
        return np.array(SIGNED, np.float32)[rng.integers(0, 4, shape)]
    return rng.random(shape).astype(np.float32)


def fixture_ell(n: int = FIXTURE_N, d: int = FIXTURE_D, seed: int = 0,
                signed: bool = False):
    """(cols, ws) padded-ELL fixture with n rows; the sentinel id n appears
    in cols; ``signed`` draws the weights from {+0, -0, 0.5, 1}."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, n + 1, size=(n, d)).astype(np.int32)
    ws = _values(rng, (n, d), signed)
    ws = np.where(rng.random((n, d)) < 0.85, ws, np.inf).astype(np.float32)
    return _t(cols), _t(ws)


def fixture_rows(shape, seed: int = 3, inf_frac: float = 0.2,
                 nan: bool = False, signed: bool = False) -> torch.Tensor:
    """f32 rows of ``shape`` with +inf on ``inf_frac`` of the slots;
    ``nan`` puts a NaN at two slots of the last lane (the second axis from
    the end, or the only axis), ``signed`` draws from {+0, -0, 0.5, 1}."""
    rng = np.random.default_rng(seed)
    v = _values(rng, shape, signed)
    v = np.where(rng.random(shape) < inf_frac, np.inf, v).astype(np.float32)
    if nan:
        lane = (slice(None),) * (len(shape) - 2) + (-1,) if len(shape) > 1 \
            else ()
        v[lane + (rng.integers(0, shape[-1], 2),)] = np.nan
    return _t(v)


def fixture_lane_batch(b: int = FIXTURE_B, n: int = FIXTURE_N,
                       seed: int = 2, **kw) -> torch.Tensor:
    """(B, n + 1) gather rows, +inf in the sentinel column n (the ops
    layer's padding, ``ops.pad_lane_batch``)."""
    v = fixture_rows((b, n), seed=seed, **kw)
    return torch.cat([v, torch.full((b, 1), float("inf"))], dim=1)


def fixture_delta_gates(b: int = FIXTURE_B, n: int = FIXTURE_N,
                        seed: int = 12, signed: bool = False):
    """``(d, light_from, heavy_from)`` of the delta push: d (B, n) with
    +inf on a fifth of the slots, a NaN and a -inf in the last lane; the
    gates on about a third of the slots each, overlapping in places."""
    rng = np.random.default_rng(seed)
    d = fixture_rows((b, n), seed=seed, nan=True, signed=signed).numpy()
    d[-1, rng.integers(0, n)] = -np.inf
    light = rng.random((b, n)) < 0.35
    heavy = rng.random((b, n)) < 0.35
    return _t(d), _t(light), _t(heavy)


def fixture_status(shape, seed: int = 4) -> torch.Tensor:
    """int32 status over {0 = U, 1 = F, 2 = S}."""
    rng = np.random.default_rng(seed)
    return _t(rng.integers(0, 3, size=shape).astype(np.int32))


def fixture_graph(n: int = FIXTURE_N, seed: int = 5, signed: bool = False):
    """A small CPU graph with one hub (3n arcs, half into vertex 0)."""
    from repro_torch.core.graph import from_coo

    rng = np.random.default_rng(seed)
    m = 3 * n
    src = rng.integers(0, n, size=m).astype(np.int32)
    dst = rng.integers(0, n, size=m).astype(np.int32)
    dst[: n // 2] = 0  # a hub, so the widest bucket and row splits show
    w = np.abs(_values(rng, m, signed))
    if signed:  # from_coo keeps -0 weights
        w = np.where((w == 0) & (rng.random(m) < 0.5), np.float32(-0.0), w)
    return from_coo(src, dst, w, n, device="cpu")


def fixture_sliced(n: int = FIXTURE_N, seed: int = 5, side: str = "in"):
    """The reference's small multi-bucket sliced view (boundaries (2, 4),
    rows split at 4, pad multiple 2)."""
    from repro_torch.core.graph import to_ell_in_sliced, to_ell_out_sliced

    g = fixture_graph(n, seed)
    build = to_ell_in_sliced if side == "in" else to_ell_out_sliced
    return build(g, pad_multiple=2, boundaries=(2, 4), split=4)


def fixture_groups_graph(n: int = 60, seed: int = 9):
    """A graph whose in- and out-degrees take more than 16 values: vertex
    v > 0 gets ``1 + v % 24`` arcs from the hub 0 and as many to it."""
    from repro_torch.core.graph import from_coo

    rng = np.random.default_rng(seed)
    deg = 1 + np.arange(1, n) % 24
    own = np.repeat(np.arange(1, n), deg).astype(np.int32)
    hub = np.zeros_like(own)
    src = np.concatenate([hub, own])
    dst = np.concatenate([own, hub])
    w = rng.random(src.shape[0]).astype(np.float32)
    return from_coo(src, dst, w, n, device="cpu")


def fixture_sliced_groups(side: str = "in", n: int = 60, seed: int = 9):
    """A sliced view with more than 16 buckets with rows (each pass of a
    sliced kernel runs in two launch groups): one bucket a width 1..24,
    pad multiple 1."""
    from repro_torch.core.graph import to_ell_in_sliced, to_ell_out_sliced

    g = fixture_groups_graph(n, seed)
    build = to_ell_in_sliced if side == "in" else to_ell_out_sliced
    return build(g, pad_multiple=1, boundaries=tuple(range(1, 25)))


def fixture_out_ell(n: int = FIXTURE_N, seed: int = 5, signed: bool = False):
    """The padded outgoing view of :func:`fixture_graph` (the push's
    input)."""
    from repro_torch.core.graph import to_ell_out

    return to_ell_out(fixture_graph(n, seed, signed), pad_multiple=2)


def fixture_rect(b: int = FIXTURE_B, n: int = FIXTURE_N, seed: int = 6,
                 signed: bool = False):
    """``(dmask, cols, ws, n_targets)`` of the rectangular push: ``n // 2 +
    1`` owner rows, left-packed out-rows of 0 to 4 global ids in
    [0, n_targets) with ``n_targets = n + 3``, then the sentinel
    n_targets; dmask +inf on half the slots, NaN in the last lane;
    ``signed`` draws weights and dmask from {+0, -0, 0.5, 1}."""
    rng = np.random.default_rng(seed)
    rows, m, d = n // 2 + 1, n + 3, 4
    cols = rng.integers(0, m, size=(rows, d)).astype(np.int32)
    cols[np.arange(d)[None] >= rng.integers(0, d + 1, rows)[:, None]] = m
    ws = np.where(cols < m, _values(rng, (rows, d), signed),
                  np.inf).astype(np.float32)
    dmask = fixture_rows((b, rows), seed=seed + 1, inf_frac=0.5, nan=True,
                         signed=signed)
    return dmask, _t(cols), _t(ws), m


def fixture_settle(b: int = FIXTURE_B, n: int = FIXTURE_N, seed: int = 200,
                   *, sliced: bool = False, signed: bool = False,
                   target: bool = False, stop: bool = False,
                   telemetry: bool = False):
    """``(args, kwargs)`` of one committed phase (``settle_phase_batch``)
    on :func:`fixture_graph`: a seeded U/F/S state with +inf holes and a
    NaN in the last lane, #2's thresholds for the default plan (the shared
    ``out_min_static``) from the twin, ``live0`` the live lanes, the padded
    out-view or a sliced one (boundaries (2, 4), split 4) with its vertex
    row table, (``target``) s->t targets on every other lane, and
    (``telemetry``) the fringe, relax and attribution rings."""
    from repro_torch.core.graph import (
        out_degrees,
        to_ell_out,
        to_ell_out_sliced,
        vertex_row_table,
    )
    from repro_torch.kernels import ref

    g = fixture_graph(n, seed, signed)
    d = fixture_rows((b, n), seed=seed + 1, nan=True, signed=signed)
    status = fixture_status((b, n), seed + 2)
    mins, n_f = ref.frontier_crit_lanes_batch_ref(d, status,
                                                  g.out_min_static[None])
    kwargs = {"zero": False, "stop": stop, "telemetry": telemetry}
    if sliced:
        view = to_ell_out_sliced(g, pad_multiple=2, boundaries=(2, 4),
                                 split=4)
        kwargs["vrows"] = vertex_row_table(g, view)
    else:
        view = to_ell_out(g, pad_multiple=2)
    if target:
        rng = np.random.default_rng(seed + 3)
        tg = rng.integers(0, n, b).astype(np.int32)
        tg[1::2] = -1
        kwargs["target"] = _t(tg)
    args = (d, status, mins, n_f, n_f > 0, view, out_degrees(g),
            g.in_min_static)
    return args, kwargs


def fixture_delta(b: int = FIXTURE_B, n: int = FIXTURE_N, seed: int = 300,
                  *, sliced: bool = False, signed: bool = False,
                  target: bool = False, stop: bool = False,
                  telemetry: bool = False):
    """``(args, kwargs)`` of one committed delta phase
    (``settle_push.delta_phase_batch``) on :func:`fixture_graph` at
    :data:`FIXTURE_DELTA`: a seeded U/F/S state with +inf holes, the
    carried ``(last_proc, removed)`` stack as the stepper keeps it (removed
    vertices are fringe vertices of the lane's bucket, ``last_proc`` is
    +inf off them and their ``d`` on the odd lanes, a heavy turn where the
    whole bucket is removed, or up to 0.25 above it on the even ones, a
    light round), NaNs in the last lane at a vertex of status 0 and at a
    fringe vertex that is not removed (the lane's bucket is then NaN), the
    light and heavy out-degrees, ``live0`` the live lanes, the padded
    out-view or a sliced one (boundaries (2, 4), split 4) with its vertex
    row table, (``target``) s->t targets on every other lane, and
    (``telemetry``) the rings."""
    from repro_torch.core.graph import (
        out_degrees,
        to_ell_out,
        to_ell_out_sliced,
        vertex_row_table,
    )
    from repro_torch.core.policies import delta_degrees
    from repro_torch.kernels import ref

    g = fixture_graph(n, seed, signed)
    rng = np.random.default_rng(seed + 3)
    d = fixture_rows((b, n), seed=seed + 1, signed=signed).numpy().copy()
    status = fixture_status((b, n), seed + 2).numpy()
    x = ref.delta_bucket_ids(_t(d), FIXTURE_DELTA).numpy()
    fringe = status == 1
    bucket = np.where(fringe, x, np.inf).min(axis=1, keepdims=True)
    in_b = fringe & (x == bucket) & np.isfinite(d)
    heavy = (np.arange(b) % 2 == 1)[:, None]
    removed = in_b & (heavy | (rng.random((b, n)) < 0.5))
    lift = np.where(heavy, 0.0, rng.choice([0.0, 0.25], (b, n)))
    last = np.where(removed, d + lift.astype(np.float32), np.inf)
    zero = np.flatnonzero(status[-1] == 0)
    free = np.flatnonzero(fringe[-1] & ~removed[-1])
    for pool in (zero, free):
        if pool.size:
            d[-1, rng.choice(pool)] = np.nan
    keys = np.stack([last, removed]).astype(np.float32)
    deg_light, deg_heavy = delta_degrees(g, FIXTURE_DELTA)
    kwargs = {"stop": stop, "telemetry": telemetry}
    if sliced:
        view = to_ell_out_sliced(g, pad_multiple=2, boundaries=(2, 4),
                                 split=4)
        kwargs["vrows"] = vertex_row_table(g, view)
    else:
        view = to_ell_out(g, pad_multiple=2)
    if target:
        tg = rng.integers(0, n, b).astype(np.int32)
        tg[1::2] = -1
        kwargs["target"] = _t(tg)
    live0 = _t((status == 1).any(axis=1))
    args = (_t(d), _t(status), _t(keys), live0, view, out_degrees(g),
            deg_light, deg_heavy, FIXTURE_DELTA)
    return args, kwargs


def wide(make: Callable[[int, int, int, bool], SpecCase]):
    """The port's wide cases of one wrapper: ``make(b, n, seed, signed)``
    for each of :data:`WIDE_SHAPES` (NaN lanes in every case, signed zeros
    in the odd ones)."""
    return tuple(make(b, n, 100 + i, bool(i % 2))
                 for i, (b, n) in enumerate(WIDE_SHAPES))
