"""The execution config of the CUDA kernel layer (counterpart of
``repro.kernels.config``): the one module that reads ``REPRO_TORCH_*``.

  * **device** — :func:`resolve_device`: which device an entry point runs
    on (``None`` is the CUDA card).
  * **kernel mode** — :func:`kernel_mode` (``REPRO_TORCH_KERNEL_MODE``:
    ``auto`` or ``kernels``). ``auto`` launches the kernels on CUDA tensors
    and runs the plain twins on CPU tensors; ``kernels`` raises where a
    wrapper is handed a CPU tensor (:func:`runs_twin`). No mode runs a twin
    on CUDA tensors: a differential run passes ``use_kernels=False``.
  * **launch geometry** — the compile-time launch shapes the CUDA sources
    fix in ``#define`` s, mirrored here (:data:`GEOMETRY_MIRRORS`, which the
    audit holds against the sources), and the card's limits the audit holds
    each kernel's ``ptxas`` record to. Variants of a shape or a launch are
    the job of ``tools/*_variants.py``.
  * **tuning ledger** — :class:`TuningLedger`, a persistable JSON map from
    a key to a measured decision: the degree-sliced views' tuned bucket
    boundaries (:func:`autotune_slicing`, read by
    ``repro_torch.core.graph.to_ell_in_sliced`` / ``to_ell_out_sliced``
    when built without boundaries) and the engine portfolio's measured
    walls (:func:`record_portfolio`, read by
    ``repro_torch.serving.backends.pick_engine``).
  * **launch timing** — :func:`measure_launch`, the one timed-call
    primitive: on the card each repetition is timed by CUDA events, on the
    CPU by the host clock, and every repetition lands in the default
    registry's ``kernel.launch.<kind>`` histogram.

Decisions of the port:

  * Keys of kernel shapes (:func:`ledger_key`, :func:`slicing_ledger_key`)
    carry the device, not a kernel mode: their first segment is ``cpu`` or
    the card's ``sm_XY`` (``torch.cuda.get_device_capability``), so CPU and
    H100 records never mix.
  * Portfolio keys keep the reference's form,
    ``portfolio:{family}:b{b}:{policy}:{layout}``: they record end-to-end
    walls, and :func:`portfolio_entries`, ``family_fallbacks`` and the
    dashboard parse either package's file. An entry the port probed carries
    a ``"device"`` field (:func:`device_tag`), and the router skips entries
    of another device, so CPU walls never route the card; an entry with no
    such field (the reference writes none) routes on any device.
  * The process ledger (:func:`global_ledger`) auto-loads the file named
    by ``REPRO_TORCH_TUNING_LEDGER``, never ``REPRO_TUNING_LEDGER``: a
    ledger of CPU-interpret or TPU walls must not route the card's
    traffic.
  * The JSON layout is the reference's (``indent=1, sort_keys=True``), so
    a file saved by one package loads in the other.

The reference's VMEM budget and block rows have no counterpart: a CUDA
block's limits are threads, registers and shared memory, which the audit
(``repro_torch.analysis.kernel_audit``) checks against each build's
``ptxas`` record. Tuning changes only how a view is laid out, never a
value: f32 min-plus is exact in any order.
"""
from __future__ import annotations

import json
import os
from typing import Callable

import torch

from repro_torch.obs import timer as obs_timer
from repro_torch.obs.registry import default_registry

_LEDGER_ENV = "REPRO_TORCH_TUNING_LEDGER"
_MODE_ENV = "REPRO_TORCH_KERNEL_MODE"

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

# The push relax (csrc/ell_push.cu): threads per block (must match
# PUSH_THREADS there).
PUSH_THREADS = 256

# The embedding gradient (csrc/embed_grad.cu): threads per block, one a
# column (must match EMBED_THREADS there).
EMBED_THREADS = 256


def kernel_mode() -> str:
    """The kernel mode: ``auto`` or ``kernels`` (``REPRO_TORCH_KERNEL_MODE``,
    default ``auto``); raises on another value."""
    mode = os.environ.get(_MODE_ENV, "auto").strip().lower()
    if mode not in ("auto", "kernels"):
        raise ValueError(f"{_MODE_ENV} must be 'auto' or 'kernels'; got "
                         f"{mode!r}")
    return mode


def runs_twin(t: torch.Tensor) -> bool:
    """Whether a kernel wrapper handed ``t`` runs its plain twin: ``t`` lies
    on the CPU. In the ``kernels`` mode a CPU tensor raises instead."""
    if t.device.type != "cpu":
        return False
    if kernel_mode() == "kernels":
        raise RuntimeError(
            f"{_MODE_ENV}=kernels: a kernel wrapper was handed a CPU tensor; "
            "put the inputs on the card"
        )
    return True


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


# config.py's mirrors of compile-time constants of the CUDA sources:
# (source under csrc/, #define) -> the value here that must equal it. The
# audit parses each source and holds every pair equal
# (``analysis.kernel_audit.audit_geometry_mirrors``); a variant of a body
# with other values is the job of ``tools/*_variants.py``, never of a
# launch.
GEOMETRY_MIRRORS = {
    ("ell_gather.cu", "SCAN_CAP"): SCAN_CAP,
    ("ell_gather.cu", "SCAN_WARPS"): SCAN_WARPS,
    ("ell_gather.cu", "SCAN_SKIP_WARPS"): SCAN_SKIP_WARPS,
    ("ell_gather.cu", "MAX_SLICES"): SLICED_GROUP_BUCKETS,
    ("ell_gather.cu", "LANE_TILE"): LANE_TILE,
    ("ell_push.cu", "PUSH_MAX_BUCKETS"): SLICED_GROUP_BUCKETS,
    ("ell_push.cu", "PUSH_THREADS"): PUSH_THREADS,
    ("frontier_crit.cu", "CRIT_THREADS"): CRIT_THREADS,
    ("frontier_crit.cu", "CRIT_MIN_BLOCKS"): CRIT_BLOCKS_PER_SM,
    ("frontier_crit.cu", "KMAX"): CRIT_MAX_KEYS,
    ("embed_grad.cu", "EMBED_THREADS"): EMBED_THREADS,
}

# The card's limits a launch must keep (H100, sm_90): threads a block,
# 32-bit registers an SM and a thread, shared memory a block (opt-in).
MAX_THREADS_PER_BLOCK = 1024
REGISTERS_PER_SM = 65536
MAX_REGISTERS_PER_THREAD = 255
MAX_SMEM_PER_BLOCK = 232448


def relax_threads_per_row(d_pad: int) -> int:
    """Threads that share one ELL row: the smallest power of two covering
    the row width, capped at a warp (wide rows loop over the warp)."""
    tpr = 1
    while tpr < min(d_pad, 32):
        tpr *= 2
    return tpr


def device_tag(device=None) -> str:
    """The device segment of a kernel-shape ledger key: ``cpu``, or the
    card's compute capability as ``sm_XY`` (``None`` = the CUDA card)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "cpu"
    major, minor = torch.cuda.get_device_capability(dev)
    return f"sm_{major}{minor}"


# ---------------------------------------------------------------------------
# Tuning ledger
# ---------------------------------------------------------------------------


def ledger_key(kind: str, n: int, d_pad: int, b: int, lanes: int = 1,
               device=None) -> str:
    """Canonical ledger key for a kernel-call shape on ``device``."""
    return f"{device_tag(device)}:{kind}:n{n}:d{d_pad}:b{b}:l{lanes}"


def slicing_ledger_key(side: str, n: int, device=None) -> str:
    """Ledger key for a graph's tuned slice boundaries on ``device``, per
    adjacency side and vertex count (the builders know no batch size)."""
    return f"{device_tag(device)}:slicing:{side}:n{n}"


def portfolio_ledger_key(family: str, b: int, policy: str, layout: str) -> str:
    """Ledger key for one measured serving engine configuration: graph
    family, lane count, policy spec and layout (the reference's form; no
    device segment, these are end-to-end walls)."""
    return f"portfolio:{family}:b{int(b)}:{policy}:{layout}"


def record_portfolio(ledger: "TuningLedger", family: str, b: int, policy: str,
                     layout: str, *, wall_s: float, phases: int, queries: int,
                     delta: float | None = None,
                     attribution: dict[str, int] | None = None,
                     device=None) -> dict:
    """Write one measured portfolio entry and return it: the raw
    measurement (``wall_s`` for ``queries`` solves over ``phases`` phases),
    the rates the router ranks by, the bucket width a Δ candidate ran with,
    the policy's ``settle_attribution`` totals when the probe ran with
    telemetry (what the dashboard explains a win with) and, given the
    ``device`` it was measured on, that device's :func:`device_tag`."""
    entry: dict = {
        "wall_s": float(wall_s),
        "phases": int(phases),
        "queries": int(queries),
        "per_phase_s": float(wall_s) / max(int(phases), 1),
        "qps": float(queries) / max(float(wall_s), 1e-12),
    }
    if delta is not None:
        entry["delta"] = float(delta)
    if attribution is not None:
        entry["settle_attribution"] = {
            str(k): int(v) for k, v in attribution.items()
        }
    if device is not None:
        entry["device"] = device_tag(device)
    ledger.put(portfolio_ledger_key(family, b, policy, layout), entry)
    return entry


def portfolio_entries(ledger: "TuningLedger", family: str, b: int,
                      device=None) -> dict[tuple[str, str], dict]:
    """All recorded engine configs for one (family, lanes): (policy, layout)
    -> entry. Policy specs hold no ``:``, so the last ``:`` splits policy
    from layout. Given a ``device``, entries tagged with another device are
    left out (untagged ones stay)."""
    prefix = f"portfolio:{family}:b{int(b)}:"
    tag = None if device is None else device_tag(device)
    out: dict[tuple[str, str], dict] = {}
    for key, entry in ledger.entries.items():
        if key.startswith(prefix):
            if tag is not None and entry.get("device", tag) != tag:
                continue
            policy, layout = key[len(prefix):].rsplit(":", 1)
            out[(policy, layout)] = entry
    return out


class TuningLedger:
    """Persistable map from a ledger key to a measured decision. Entries
    are plain dicts, so the JSON file is diffable and survives schema
    growth."""

    def __init__(self, path: str | None = None):
        self.path = path
        self.entries: dict[str, dict] = {}
        if path and os.path.exists(path):
            self.load(path)

    def get(self, key: str) -> dict | None:
        return self.entries.get(key)

    def put(self, key: str, entry: dict) -> None:
        self.entries[key] = dict(entry)

    def load(self, path: str) -> int:
        """Merge entries from ``path``; returns how many were accepted.

        Tolerant of a torn or foreign file: unparseable JSON or a non-dict
        top level loads nothing, values that are not dicts are skipped, and
        the entries already in memory are never dropped. A tuning record is
        a measurement memo: losing one re-measures, while failing an engine
        build over it would stop serving.
        """
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return 0
        if not isinstance(data, dict):
            return 0
        good = {k: v for k, v in data.items()
                if isinstance(k, str) and isinstance(v, dict)}
        self.entries.update(good)
        self.path = path
        return len(good)

    def save(self, path: str | None = None) -> str:
        """Persist atomically (temp file, ``fsync``, ``os.replace``): a
        crash mid-save leaves the previous file whole, and a reader sees the
        old ledger or the new one, never a truncated prefix."""
        path = path or self.path
        if path is None:
            raise ValueError("no ledger path given and none remembered")
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(self.entries, f, indent=1, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self.path = path
        return path


_GLOBAL_LEDGER: TuningLedger | None = None


def global_ledger() -> TuningLedger:
    """The process-wide ledger (auto-loads ``REPRO_TORCH_TUNING_LEDGER``
    if set)."""
    global _GLOBAL_LEDGER
    if _GLOBAL_LEDGER is None:
        path = os.environ.get(_LEDGER_ENV)
        _GLOBAL_LEDGER = TuningLedger(path if path else None)
    return _GLOBAL_LEDGER


def reset_global_ledger() -> None:
    """Drop the cached process ledger (tests, environment changes)."""
    global _GLOBAL_LEDGER
    _GLOBAL_LEDGER = None


# ---------------------------------------------------------------------------
# Measured tuning
# ---------------------------------------------------------------------------


def _card_of(out):
    """The CUDA device of the first tensor in ``out`` (a tensor, or a
    tuple or list of them), or None when none lives on a card."""
    if isinstance(out, (tuple, list)):
        for x in out:
            dev = _card_of(x)
            if dev is not None:
                return dev
        return None
    if torch.is_tensor(out) and out.is_cuda:
        return out.device
    return None


def _host_seconds(fn, card) -> float:
    t0 = obs_timer.now()
    fn()
    if card is not None:
        torch.cuda.synchronize(card)
    return obs_timer.now() - t0


def _event_seconds(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def measure_launch(kind: str, fn: Callable[[], object], reps: int = 3, *,
                   clock: str | None = None) -> float:
    """Median seconds of ``reps`` calls of ``fn`` after one untimed warm-up
    call (the first call on the card builds the kernels). When ``fn``
    returns tensors on the card each repetition is timed by CUDA events
    around the call on the current stream (``clock="host"`` takes the host
    clock to a ``torch.cuda.synchronize()`` instead, to read the two side
    by side); on the CPU by the host clock. Every repetition is observed
    into the default registry's ``kernel.launch.<kind>`` histogram."""
    if clock not in (None, "host"):
        raise ValueError(f"clock must be None or 'host'; got {clock!r}")
    card = _card_of(fn())
    if card is not None:
        torch.cuda.synchronize(card)
    hist = default_registry().histogram(
        f"kernel.launch.{kind}", f"seconds per {kind!r} kernel launch"
    )
    walls = []
    for _ in range(reps):
        if card is None or clock == "host":
            wall = _host_seconds(fn, card)
        else:
            with torch.cuda.device(card):
                wall = _event_seconds(fn)
        walls.append(wall)
        hist.observe(wall)
    walls.sort()
    return walls[len(walls) // 2]


def autotune_slicing(
    make_call: Callable[[tuple[int, ...] | None], Callable[[], object]],
    n: int,
    *,
    side: str = "in",
    boundary_sets: tuple[tuple[int, ...] | None, ...] = (None,),
    reps: int = 3,
    ledger: TuningLedger | None = None,
    device=None,
) -> tuple[int, ...] | None:
    """Time a call per candidate bucket-boundary set (``None`` = the padded
    layout) and ledger the winner under :func:`slicing_ledger_key`, which
    the sliced builders read when given no boundaries. Returns the winning
    boundary tuple (None for padded)."""
    ledger = global_ledger() if ledger is None else ledger
    best: tuple[float, tuple[int, ...] | None] | None = None
    measured = {}
    for bset in boundary_sets:
        wall = measure_launch(f"slicing.{side}", make_call(bset), reps)
        measured["padded" if bset is None else str(list(bset))] = wall
        if best is None or wall < best[0]:
            best = (wall, bset)
    if best is None:
        raise ValueError("boundary_sets must be non-empty")
    ledger.put(
        slicing_ledger_key(side, n, device),
        {
            "boundaries": None if best[1] is None else list(best[1]),
            "wall_s": best[0],
            "measured": measured,
        },
    )
    return best[1]


def resolve_slice_boundaries(side: str, n: int,
                             device=None) -> tuple[int, ...] | None:
    """The tuned bucket boundaries of a sliced view on ``device``, or None
    when nothing was tuned or the padded layout won (the builder then uses
    its degree-distribution default: a caller asking for a sliced view gets
    one)."""
    hit = global_ledger().get(slicing_ledger_key(side, n, device))
    if hit and hit.get("boundaries"):
        return tuple(int(x) for x in hit["boundaries"])
    return None
