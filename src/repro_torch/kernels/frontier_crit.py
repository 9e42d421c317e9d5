"""Fused frontier reduction over plan-defined lanes (CUDA kernel).

One pass over the vertex state produces every per-phase threshold a
criterion plan needs, plus the fringe size:

    lane 0     (f32): min_F d              (DIJK / IN-family threshold)
    lane 1+k   (f32): min_F (d + key_k)    (one lane per OUT-family member)
    count      (i32): |F|

Key stacks come as shared ``(K, n)`` (all OUT keys static: the default
plan), per-lane ``(K, B, n)`` (dynamic keys) or None (K = 0). The kernel is
``csrc/frontier_crit.cu``: one launch a call, whose blocks fold their
partials into the result through a ticket (the last block to finish folds
them all); its note says what bounds it on the card. The partials and the
ticket are scratch this module allocates once per device and stream and
reuses; a CUDA graph capture takes its own (:func:`capture_scratch`). A
tensor on the CPU runs the plain twin in ``kernels/ref.py``; a CUDA tensor
launches the kernel or raises.

``frontier_crit_lanes``/``frontier_crit``/``frontier_crit_batch`` are the
reference's thin wrappers over the lane reduction.

:func:`delta_thresholds_batch` is delta-stepping's threshold, a second
entry point of the same source: one pass over ``d``, ``status`` and
``last_proc`` that divides by the bucket width in registers and gives each
lane its bucket, its fringe size and the witness of a light round (the
count and the least bucket id of the fringe vertices below their
``last_proc``).
"""
from __future__ import annotations

import contextlib
import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.config import (
    CRIT_BLOCKS_PER_SM,
    CRIT_MAX_KEYS,
    CRIT_THREADS,
    runs_twin,
)
from repro_torch.kernels.ell_relax_keys import on_stream

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "frontier_crit_lanes_launch": (
        [_P, _P, _P, _LL, _I, _I, _LL, _LL, _I, _P, _P, _P, _P, _P, _P],
        _I,
    ),
    "delta_thresholds_launch": (
        [_P, _P, _P, ctypes.c_float, _LL, _I, _I, _P, _P, _P, _P, _P, _P],
        _I,
    ),
}
MAX_LANES = 65535  # lanes ride the grid's second axis

# (device index, stream) -> [partial minima, partial counts, ticket]: the
# ticket is zeroed once and every launch leaves it 0; the partials grow to
# the largest call seen. One scratch a stream: launches on one stream are
# ordered, so they never share it at once.
_scratch: dict = {}
_sms: dict = {}  # device index -> SM count


def blocks_per_lane(dev, lanes: int, n: int) -> int:
    """Blocks of one lane's row: ``CRIT_BLOCKS_PER_SM`` blocks on each SM
    over all lanes (one wave), no more than the row has chunks of
    ``CRIT_THREADS`` groups of 4 vertices."""
    sms = _sms.get(dev.index)
    if sms is None:
        sms = _sms[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    wave = -(-sms * CRIT_BLOCKS_PER_SM // lanes)
    return max(1, min(wave, -(-n // (4 * CRIT_THREADS))))


def scratch(dev, stream: int, n_min: int, n_cnt: int):
    """The reduction's scratch on ``dev`` for ``stream``: at least
    ``n_min`` partial minima and ``n_cnt`` partial counts, and the ticket."""
    key = (dev.index, stream)
    buf = _scratch.get(key)
    if buf is None:
        buf = _scratch[key] = [
            torch.empty(0, dtype=torch.float32, device=dev),
            torch.empty(0, dtype=torch.int32, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev)]
    if buf[0].numel() < n_min:
        buf[0] = torch.empty(n_min, dtype=torch.float32, device=dev)
    if buf[1].numel() < n_cnt:
        buf[1] = torch.empty(n_cnt, dtype=torch.int32, device=dev)
    return buf


@contextlib.contextmanager
def capture_scratch():
    """Inside the block, :func:`scratch` serves a table of its own, which
    the block yields: the stepper wraps a CUDA graph capture in it, so the
    partials and the ticket a graph bakes in are allocated in the captures'
    private pool and kept by the caller with the graph, and no eager call
    can grow (and so free) a buffer a graph still reads. The ticket's
    zeroing is captured too; every launch leaves it 0 anyway."""
    global _scratch
    saved, _scratch = _scratch, {}
    try:
        yield _scratch
    finally:
        _scratch = saved


def _check(d, status, keys):
    if d.dim() != 2 or status.shape != d.shape:
        raise ValueError(
            f"want d and status (B, n); got {tuple(d.shape)}, "
            f"{tuple(status.shape)}"
        )
    b, n = d.shape
    if n < 1:
        raise ValueError("the frontier reduction needs n >= 1 vertices")
    if (d.dtype, status.dtype) != (torch.float32, torch.int32):
        raise TypeError(f"want f32 d, int32 status; got {d.dtype}, {status.dtype}")
    tensors = [d, status]
    if keys is not None:
        if keys.dtype != torch.float32:
            raise TypeError(f"want f32 keys; got {keys.dtype}")
        if not (keys.dim() == 2 and keys.shape[1] == n
                or keys.dim() == 3 and keys.shape[1:] == (b, n)):
            raise ValueError(
                f"keys must be (K, {n}) or (K, {b}, {n}); got {tuple(keys.shape)}"
            )
        if keys.shape[0] > CRIT_MAX_KEYS:
            raise ValueError(
                f"too many OUT lanes: {keys.shape[0]} > {CRIT_MAX_KEYS}"
            )
        tensors.append(keys)
    if any(t.device != d.device for t in tensors):
        raise ValueError(
            f"inputs on different devices: {[str(t.device) for t in tensors]}"
        )
    if d.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {d.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("d, status and keys must be contiguous")


def frontier_crit_lanes_batch(d: torch.Tensor, status: torch.Tensor,
                              keys: torch.Tensor | None):
    """Returns (mins (1+K, B) f32, fringe_count (B,) i32).

    ``mins[0]`` is the per-lane min fringe distance; ``mins[1 + k]`` the
    OUT threshold ``min_F (d + keys[k])``.
    """
    _check(d, status, keys)
    if runs_twin(d):
        return ref.frontier_crit_lanes_batch_ref(d, status, keys)
    b, n = d.shape
    k = 0 if keys is None else keys.shape[0]
    dev = d.device
    # mins and cnt share one allocation: (1 + K) * B f32 words, then B i32
    out = torch.empty(((2 + k) * b,), dtype=torch.int32, device=dev)
    mins = out[:(1 + k) * b].view(torch.float32).view(1 + k, b)
    cnt = out[(1 + k) * b:]
    if b == 0:
        return mins, cnt
    if b > MAX_LANES:
        raise ValueError(f"at most {MAX_LANES} lanes per launch; got {b}")
    key_sk = key_sb = 0
    if keys is not None:
        key_sk, key_sb = (n, 0) if keys.dim() == 2 else (b * n, n)
    lib = _build.load("frontier_crit", _SIGNATURES)
    bx = blocks_per_lane(dev, b, n)

    def call(stream):
        part_min, part_cnt, ticket = scratch(dev, stream, (1 + k) * b * bx,
                                             b * bx)
        return lib.frontier_crit_lanes_launch(
            d.data_ptr(), status.data_ptr(),
            None if keys is None else keys.data_ptr(), n, b, k, key_sk,
            key_sb, bx, part_min.data_ptr(), part_cnt.data_ptr(),
            ticket.data_ptr(), mins.data_ptr(), cnt.data_ptr(), stream,
        )

    rc = on_stream(dev, call)
    if rc != 0:
        raise RuntimeError(
            f"frontier_crit_lanes_batch launch failed: CUDA error {rc}"
        )
    frontier_crit_lanes_batch.launches += 1
    return mins, cnt


frontier_crit_lanes_batch.launches = 0  # kernel launches since the last reset


def delta_thresholds_batch(d: torch.Tensor, status: torch.Tensor,
                           last_proc: torch.Tensor, delta: float):
    """Delta's threshold of one phase: ``(mins (2, B) f32, counts (2, B)
    int32)``, ``mins[0]`` each lane's bucket ``min_F floor(d / delta)``
    (NaN kept, as #2 keeps it), ``mins[1]`` the least bucket id of the
    fringe vertices with ``d < last_proc``, ``counts`` the two sets' sizes
    (``ref.delta_thresholds_ref``). ``delta`` is the f32 width as a Python
    float; the divide is the reference's IEEE f32 one."""
    _check(d, status, None)
    if last_proc.shape != d.shape or last_proc.dtype != torch.float32 or \
            last_proc.device != d.device or not last_proc.is_contiguous():
        raise ValueError(f"want a contiguous f32 last_proc {tuple(d.shape)} "
                         f"on {d.device}; got {last_proc.dtype} "
                         f"{tuple(last_proc.shape)} on {last_proc.device}")
    if not isinstance(delta, float):
        raise TypeError(f"want the f32 delta as a Python float; got "
                        f"{type(delta).__name__}")
    if runs_twin(d):
        return ref.delta_thresholds_ref(d, status, last_proc, delta)
    b, n = d.shape
    dev = d.device
    # mins and counts share one allocation: 2 * B f32 words, then 2 * B i32
    out = torch.empty((4 * b,), dtype=torch.int32, device=dev)
    mins = out[:2 * b].view(torch.float32).view(2, b)
    counts = out[2 * b:].view(2, b)
    if b == 0:
        return mins, counts
    if b > MAX_LANES:
        raise ValueError(f"at most {MAX_LANES} lanes per launch; got {b}")
    lib = _build.load("frontier_crit", _SIGNATURES)
    bx = blocks_per_lane(dev, b, n)

    def call(stream):
        part_min, part_cnt, ticket = scratch(dev, stream, 2 * b * bx,
                                             2 * b * bx)
        return lib.delta_thresholds_launch(
            d.data_ptr(), status.data_ptr(), last_proc.data_ptr(), delta, n,
            b, bx, part_min.data_ptr(), part_cnt.data_ptr(),
            ticket.data_ptr(), mins.data_ptr(), counts.data_ptr(), stream)

    rc = on_stream(dev, call)
    if rc != 0:
        raise RuntimeError(
            f"delta_thresholds_batch launch failed: CUDA error {rc}")
    delta_thresholds_batch.launches += 1
    return mins, counts


delta_thresholds_batch.launches = 0  # kernel launches since the last reset


def frontier_crit_lanes(d: torch.Tensor, status: torch.Tensor,
                        keys: torch.Tensor | None):
    """1-D entry point: returns (mins (1+K,) f32, fringe_count i32 scalar)."""
    mins, cnt = frontier_crit_lanes_batch(d[None], status[None], keys)
    return mins[:, 0], cnt[0]


def frontier_crit(d: torch.Tensor, status: torch.Tensor,
                  out_min: torch.Tensor):
    """Returns (min_fringe_d, l_out, fringe_count) scalars: the fixed
    INSTATIC|OUTSTATIC lane pair."""
    mins, cnt = frontier_crit_lanes(d, status, out_min[None])
    return mins[0], mins[1], cnt


def frontier_crit_batch(d: torch.Tensor, status: torch.Tensor,
                        out_min: torch.Tensor):
    """Returns (min_fringe_d (B,), l_out (B,), fringe_count (B,))."""
    mins, cnt = frontier_crit_lanes_batch(d, status, out_min[None])
    return mins[0], mins[1], cnt


def register_kernels(reg):
    """Register this module's kernel contracts (``kernels/registry.py``)."""
    from repro_torch.kernels import registry as R

    crit = ((R.SRC_CRIT, "crit_kernel"),)
    n, b, k = R.FIXTURE_N, R.FIXTURE_B, R.FIXTURE_K

    def cases_lanes():
        d, status = R.fixture_rows((b, n), seed=21), R.fixture_status((b, n))
        return (
            R.SpecCase("nokeys", (d, status, None)),
            R.SpecCase("shared_keys", (d, status,
                                       R.fixture_rows((k, n), seed=22))),
            R.SpecCase("per_lane_keys", (d, status,
                                         R.fixture_rows((k, b, n), seed=23))),
            *R.wide(lambda b, n, seed, signed: R.SpecCase(
                f"b{b}_n{n}", (R.fixture_rows((b, n), seed, nan=True,
                                              signed=signed),
                               R.fixture_status((b, n), seed),
                               R.fixture_rows((k, b, n) if seed % 2 else
                                              (k, n), seed + 1,
                                              signed=signed)))),
        )

    def cases_scalar():
        return (R.SpecCase("one_row", (R.fixture_rows((n,), seed=24),
                                       R.fixture_status((n,)),
                                       R.fixture_rows((n,), seed=25))),)

    def cases_batch():
        return (R.SpecCase("ref", (R.fixture_rows((b, n), seed=26),
                                   R.fixture_status((b, n)),
                                   R.fixture_rows((n,), seed=27))),)

    notes = ("one launch; per-block partials folded by the last block to "
             "take the ticket; |F| is an int32 work counter")
    # the instances of more than 4 keys on rows off 16-byte boundaries
    # spill 36-40 bytes under CRIT_MIN_BLOCKS 4 (csrc/frontier_crit.cu,
    # Unroll): compiled for KMAX = 8, they run on no plan's path
    unused = ("K = {} keys off 16-byte boundaries: no criterion plan has "
              "more than 4 OUT keys, so no engine path launches this "
              "instance; bit-equal to the twin on the card "
              "(test_frontier_crit_every_key_count_matches_twin)")
    reg.register(R.KernelContract(
        name="frontier_crit_lanes_batch", module=__name__,
        wrapper=frontier_crit_lanes_batch, make_cases=cases_lanes,
        counter_outputs=(1,), kernels=crit, notes=notes,
        spills_ok={f"crit_kernel<{k},0>": unused.format(k)
                   for k in (7, 8)}))

    def cases_delta():
        out = []
        for i, (b, n) in enumerate(((R.FIXTURE_B, R.FIXTURE_N),)
                                   + R.WIDE_SHAPES):
            args, _ = R.fixture_delta(b, n, 400 + i, signed=bool(i % 2))
            d, status, keys = args[:3]
            out.append(R.SpecCase(f"b{b}_n{n}" if i else "ref",
                                  (d, status, keys[0].contiguous(),
                                   args[-1])))
        return tuple(out)

    reg.register(R.KernelContract(
        name="delta_thresholds_batch", module=__name__,
        wrapper=delta_thresholds_batch, make_cases=cases_delta,
        counter_outputs=(1,), kernels=((R.SRC_CRIT, "delta_crit_kernel"),),
        notes="delta's threshold: #2's one launch on the bucket ids of d "
              "divided in registers, with the light round's witness"))
    reg.register(R.KernelContract(
        name="frontier_crit", module=__name__, wrapper=frontier_crit,
        make_cases=cases_scalar, counter_outputs=(2,), kernels=crit,
        notes=notes))
    reg.register(R.KernelContract(
        name="frontier_crit_batch", module=__name__,
        wrapper=frontier_crit_batch, make_cases=cases_batch,
        counter_outputs=(2,), kernels=crit, notes=notes))
