"""Multi-pod dry run (counterpart of ``repro.launch.dryrun``): one rank's
step of every (arch x shape x mesh) cell on the production meshes, with no
storage, and its memory, operations, bytes and collectives.

Usage (no card needed; the fake tensors live on the CPU where this build
of PyTorch has no CUDA, on ``cuda`` where it has):

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b \\
      --shape train_4k --mesh pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun
  PYTHONPATH=src python -m repro_torch.launch.dryrun --workload sssp \\
      --mesh multipod

The process joins a ``"fake"`` world of 256 (or 512) ranks as one rank
(``launch.mesh.make_production_mesh``): its collectives return at once and
move nothing. A cell places that rank's blocks of the parameters (and of
the optimizer state and decode cache) as fake tensors
(``FakeTensorMode``) and runs ``launch.steps.build_step``'s step once, as
the rank would. The port runs every unit in a Python loop, so that one
trace counts the full depth; the reference's record comes from XLA's
``memory_analysis`` / ``cost_analysis`` of the compiled program instead.
Each record holds the reference's keys:

  * ``flops``: ``torch.utils.flop_counter.FlopCounterMode`` (the products:
    ``mm``, ``bmm``, ``addmm``, attention; elementwise work is not
    counted);
  * ``bytes_accessed``: every op's input and output bytes (views and
    allocations move none), the traffic of an eager run;
  * ``collectives``: the bytes of each collective's result by the
    reference's kind (``sharding.comm``'s and ``core.distributed.Comm``'s
    counts); the roofline applies all-reduce's 2x, as the reference's;
  * ``memory``: ``argument_bytes``, the rank's parameter, optimizer-state
    and cache blocks and the batch the step takes (the global batch: the
    port's step cuts the rank's block itself); ``output_bytes``, the
    step's results; ``temp_bytes``, the peak of the storages the step
    allocated and still held (outputs included) above the arguments, from
    the storages' lifetimes; ``generated_code_bytes`` 0;
  * ``lower_s`` the trace's seconds and ``compile_s`` 0 (nothing
    compiles); ``rank``, the traced rank: the one whose argument bytes are
    the largest (a unit leaf that FSDP gives "data" lies whole on one data
    rank), the lowest of equals;
  * ``device``: where the step's tensors lived (fake ones for a cell);
  * ``extrapolated``: the reference's depth-1 / depth-2 probes, affine in
    the units (with the full cell's microbatches and FSDP choice); one
    trace is exact at full depth here. The probes agree with it but in a
    train cell's optimizer, in the reference's probes as in these: a
    depth-1 probe stacks each 1-D unit leaf (a norm's scale, a bias) to
    (1, D), which the factored second moment does not factor (it needs
    two rows), so that probe updates a full ``v`` where depth 2 on updates
    factored ones. A train cell's extrapolated ``bytes_accessed`` (and,
    where such a leaf is sharded, its all-reduce bytes: the factored means
    are summed over the axis) then differ from the full trace's.

``--no-shd`` maps to nothing: the reference drops its activation sharding
constraints and lets XLA choose, while the port's step computes the
reference's partition by construction (tensor parallel over "model" on
the weights' own blocks, the carry over the sequence, experts and
vocabulary over "model"; ``models.transformer``). It is recorded
(``use_shd``) and changes no number.

The SSSP workload (``--workload sssp``) runs the legacy program
(``core.distributed.make_distributed_sssp``) on real tensors, since it
reads the fringe count on the host each phase: one rank's block of a
uniform random graph (n_loc = 65,536 and E_loc = 1,048,576 at P = 256 by
default) over the fake world, for exactly one phase (``cap = 1``), as the
reference's record counts its while body once, on the card unless the
caller asks for the CPU (``--device cpu``): the CPU runs the kernels'
plain twins in their place.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import traceback
import weakref

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import ALIASES, SHAPES, get_config, runnable_shapes
from repro_torch.kernels.config import resolve_device
from repro_torch.launch.collectives import KINDS
from repro_torch.launch.mesh import (
    AXES,
    POD_AXES,
    PRODUCTION_SHAPE,
    make_production_mesh,
)
from repro_torch.obs.timer import now

_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "detach", "alias",
               "lift_fresh", "_local_scalar_dense"}


class Accounting(TorchDispatchMode):
    """Under it, every op's input and output bytes add to
    ``bytes_accessed`` (views and allocations move none), and every
    storage an op creates is live from then until it is freed: ``live``
    its bytes now, ``peak`` the most at once. Storages made before
    (:meth:`hold`: the arguments) are never counted."""

    def __init__(self):
        super().__init__()
        self.bytes_accessed = 0
        self.live = 0
        self.peak = 0
        self._seen: dict[int, int] = {}

    def hold(self, tensors) -> int:
        """Mark the storages of ``tensors`` as the step's arguments; returns
        their bytes (each storage once)."""
        total = 0
        for t in tensors:
            st = t.untyped_storage()
            if id(st) not in self._seen:
                self._seen[id(st)] = 0
                weakref.finalize(st, self._seen.pop, id(st), None)
                total += st.nbytes()
        return total

    def created(self, t: torch.Tensor) -> bool:
        """Whether an op under the mode made ``t``'s storage (it is live)."""
        return bool(self._seen.get(id(t.untyped_storage())))

    def _free(self, key: int, nbytes: int) -> None:
        self._seen.pop(key, None)
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        # a prim op (``prim.device``) reads a tensor's metadata, not its data
        if not (func.is_view or func.namespace == "prim"
                or name in _NO_TRAFFIC):
            for t in tree_flatten((args, kwargs, out))[0]:
                if isinstance(t, torch.Tensor):
                    self.bytes_accessed += t.numel() * t.element_size()
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                if id(st) in self._seen:
                    continue
                n = st.nbytes()
                self._seen[id(st)] = n
                self.live += n
                self.peak = max(self.peak, self.live)
                weakref.finalize(st, self._free, id(st), n)
        return out


def fake_device() -> torch.device:
    """Where the fake tensors live: ``cuda`` where this build of PyTorch
    has CUDA, the CPU where it has not (autograd over fake CUDA tensors
    needs the CUDA runtime)."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _tensors(x):
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    seen, total = set(), 0
    for t in ts:
        st = t.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            total += st.nbytes()
    return total


def placed_param_bytes(step, pshape, mesh_shape: dict, data: int) -> int:
    """The bytes of the parameter blocks of the rank at data coordinate
    ``data`` (every block over "model" is the same size): a unit leaf that
    FSDP gives "data" counts on its owner only."""
    from repro_torch.sharding.partition import _param_table

    n_units = len(pshape.units)
    total = 0
    for module, local, path, unit in _param_table(pshape):
        p = module._parameters[local]
        spec = step.param_specs[path]
        if unit is not None and spec.unit is not None:
            owner = unit // (n_units // mesh_shape[spec.unit])
            if owner != data:
                continue
        n = p.numel()
        for a in spec.dims:
            for ax in (() if a is None else (a,) if isinstance(a, str) else a):
                n //= mesh_shape[ax]
        total += n * p.element_size()
    return total


def heaviest_rank(step, pshape, multi_pod: bool) -> int:
    """The global rank of the production mesh whose argument bytes are the
    largest: every rank's blocks are alike but for the unit leaves FSDP
    gives one data rank, so the data coordinate decides (pod and model
    coordinates 0; the lowest of equals)."""
    names = POD_AXES if multi_pod else AXES
    shape = dict(zip(names, PRODUCTION_SHAPE[multi_pod]))
    per = [placed_param_bytes(step, pshape, shape, d)
           for d in range(shape["data"])]
    best = int(np.argmax(per))
    return best * shape["model"]


def _block_shape(mesh, shape, dims) -> tuple:
    """The shape of this rank's block of a ``shape`` tensor under
    ``dims`` (one entry a dim: None, an axis or a tuple of axes)."""
    return tuple(n // mesh.size(a) for n, a in zip(shape, dims)) + tuple(
        shape[len(dims):])


def _make(shape, dtype, dev, gen):
    """A tensor of ``shape`` on ``dev``: unwritten with no generator
    (under ``FakeTensorMode``, a fake one), else seeded values (N(0, 0.02)
    floats, zero integers)."""
    t = torch.empty(shape, dtype=dtype, device=dev)
    if gen is not None:
        if dtype.is_floating_point:
            t.normal_(0.0, 0.02, generator=gen)
        else:
            t.zero_()
    return t


def placed_model(cfg, mesh, step, dev, gen=None):
    """The model as this rank of ``mesh`` holds it under ``step``'s specs:
    each parameter the rank's block (``partition.place_params`` on the meta
    device), made on ``dev`` by :func:`_make` (bf16, the reference's
    dry-run dtype). The whole model is never made."""
    from repro_torch.models import init_params
    from repro_torch.sharding.partition import place_params

    model = init_params(cfg, dtype=torch.bfloat16, device="meta")
    place_params(model, dataclasses.replace(mesh, device=torch.device("meta")),
                 step.param_specs)
    model.mesh = mesh
    for module in model.modules():
        for k, p in list(module._parameters.items()):
            module._parameters[k] = torch.nn.Parameter(
                _make(p.shape, p.dtype, dev, gen), requires_grad=False)
    return model


def _placed_cache(cfg, shape_name, mesh, dev, gen):
    """This rank's blocks of the decode cache of ``shape_name`` (a
    ``PlacedCache``, as ``prefill`` leaves it on a mesh), each made on
    ``dev`` by :func:`_make`."""
    from repro_torch.launch.steps import abstract_cache
    from repro_torch.models.transformer import PlacedCache
    from repro_torch.runtime.train_loop import data_axes
    from repro_torch.sharding.partition import cache_specs

    spec = SHAPES[shape_name]
    dp = data_axes(mesh)
    whole = abstract_cache(cfg, spec.global_batch, spec.seq_len)
    split = spec.global_batch % mesh.size(dp) == 0
    specs = {ln: {nm: ((dp if split else None),) + sp[1:]
                  for nm, sp in e.items()}
             for ln, e in cache_specs(cfg, whole, dp, mesh).items()}
    units = []
    for unit in whole:
        units.append({ln: {nm: _make(_block_shape(mesh, t.shape,
                                                  specs[ln][nm]),
                                     t.dtype, dev, gen)
                           for nm, t in entry.items()}
                      for ln, entry in unit.items()})
    return PlacedCache(units, specs)


def step_args(cfg, shape_name: str, mesh, step, dev, gen=None):
    """``(args, parts)``: the arguments of ``step.fn`` on this rank (the
    placed model first), made by :func:`_make`, and the argument tensors
    by part (params, optimizer, batch, cache). The batch is the global
    one, zeros (token 0 everywhere): the step cuts the rank's block."""
    from repro_torch.launch.steps import input_specs
    from repro_torch.optim.adamw import init_opt_state

    spec = SHAPES[shape_name]
    model = placed_model(cfg, mesh, step, dev, gen)
    parts = {"params": list(model.parameters())}
    if spec.kind == "decode":
        tokens = torch.zeros((spec.global_batch, 1), dtype=torch.int32,
                             device=dev)
        cache = _placed_cache(cfg, shape_name, mesh, dev, gen)
        parts.update(batch=tokens, cache=list(cache))
        return (model, tokens, cache, spec.seq_len), parts

    def zeros(x):
        if isinstance(x, dict):
            return {k: zeros(v) for k, v in x.items()}
        return torch.zeros(x.shape, dtype=x.dtype, device=dev)

    batch = zeros(input_specs(cfg, shape_name))
    parts["batch"] = batch
    if spec.kind == "prefill":
        return (model, batch), parts
    opt = init_opt_state(model, step.opt_cfg)
    parts["optimizer"] = opt
    return (model, opt, batch), parts


def account(fn, args, parts, mesh=None) -> dict:
    """Run ``fn(*args)`` once under :class:`Accounting` and
    ``FlopCounterMode``: ``{flops, bytes_accessed, collectives, memory,
    arguments, seconds}`` (``collectives`` from ``mesh.stats``, counted
    for the call; ``arguments`` the argument bytes by part)."""
    from torch.utils.flop_counter import FlopCounterMode

    acc = Accounting()
    argument = acc.hold(_tensors(list(parts.values())))
    split = {k: _nbytes(_tensors(v)) for k, v in parts.items()}
    if mesh is not None:
        mesh.stats = {"by_kind": dict.fromkeys(KINDS, 0)}
    t0 = now()
    with FlopCounterMode(display=False) as flops, acc:
        out = fn(*args)
        output = _nbytes([t for t in _tensors(out) if acc.created(t)])
    seconds = now() - t0
    by_kind = dict.fromkeys(KINDS, 0)
    if mesh is not None:
        by_kind, mesh.stats = mesh.stats["by_kind"], None
    return {"flops": float(flops.get_total_flops()),
            "bytes_accessed": float(acc.bytes_accessed),
            "collectives": by_kind,
            "memory": {"argument_bytes": int(argument),
                       "output_bytes": int(output),
                       "temp_bytes": int(acc.peak),
                       "generated_code_bytes": 0},
            "arguments": split, "seconds": seconds}


def trace_step(cfg, shape_name: str, mesh, step, dev) -> dict:
    """Run ``step`` once on this rank of ``mesh`` over fake tensors on
    ``dev``: :func:`account`'s record."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        args, parts = step_args(cfg, shape_name, mesh, step, dev)
        return account(step.fn, args, parts, mesh)


def _build(cfg, shape_name, mesh, remat, remat_policy, **kw):
    from repro_torch.launch.steps import build_step

    return build_step(cfg, shape_name, mesh, remat=remat,
                      remat_policy=remat_policy, **kw)


def _probe_stats(cfg, shape_name, mesh, step, remat, remat_policy, dev):
    """The reference's depth-1 / depth-2 probes, extrapolated affinely to
    the full depth: total(U) = s1 + (s2 - s1) (U - 1). The probes keep the
    full cell's microbatches and FSDP choice (both depend on the depth)."""
    plen = len(cfg.pattern)
    out = {}
    for u in (1, 2):
        c = dataclasses.replace(cfg, n_layers=plen * u)
        st = _build(c, shape_name, mesh, remat, remat_policy,
                    fsdp=step.fsdp, microbatches=step.microbatches)
        out[u] = trace_step(c, shape_name, mesh, st, dev)
    U = cfg.n_units

    def ext(a, b):
        return a + (b - a) * (U - 1)

    return {
        "flops": ext(out[1]["flops"], out[2]["flops"]),
        "bytes_accessed": ext(out[1]["bytes_accessed"],
                              out[2]["bytes_accessed"]),
        "collectives": {k: ext(out[1]["collectives"][k],
                               out[2]["collectives"][k])
                        for k in out[1]["collectives"]},
    }


def _mesh_record(mesh_kind: str) -> dict:
    multi = mesh_kind == "multipod"
    shape = PRODUCTION_SHAPE[multi]
    return {"mesh_shape": dict(zip(POD_AXES if multi else AXES, shape)),
            "chips": int(np.prod(shape))}


def run_cell(arch: str, shape: str, mesh_kind: str, remat: bool = True,
             use_shd: bool = True, probe: bool = True,
             remat_policy: str = "full") -> dict:
    """One cell's record: the reference's keys, plus ``rank``,
    ``use_shd``, ``device``, ``arguments`` (``argument_bytes`` by params,
    optimizer, batch and cache), ``microbatches`` and ``fsdp``; a failing
    cell is a record with ``status: error``."""
    from repro_torch.models import init_params

    cfg = get_config(arch)
    multi = mesh_kind == "multipod"
    rec: dict = {"arch": cfg.name, "shape": shape, "mesh": mesh_kind,
                 **_mesh_record(mesh_kind)}
    skip = runnable_shapes(cfg)[shape]
    if skip:
        rec["status"] = "skipped"
        rec["reason"] = skip
        return rec
    rec["remat_policy"] = remat_policy
    rec["use_shd"] = bool(use_shd)
    dev = fake_device()
    rec["device"] = str(dev)
    t0 = now()
    try:
        mesh = make_production_mesh(multi_pod=multi, rank=0, device=dev)
        step = _build(cfg, shape, mesh, remat, remat_policy)
        rank = heaviest_rank(step, init_params(cfg, dtype=torch.bfloat16,
                                               device="meta"), multi)
        if rank != mesh.rank:
            mesh = make_production_mesh(multi_pod=multi, rank=rank,
                                        device=dev)
            step = _build(cfg, shape, mesh, remat, remat_policy)
        got = trace_step(cfg, shape, mesh, step, dev)
        rec.update(
            status="ok", rank=rank,
            lower_s=round(now() - t0, 1), compile_s=0.0,
            flops=got["flops"], bytes_accessed=got["bytes_accessed"],
            collectives=got["collectives"], memory=got["memory"],
            arguments=got["arguments"], microbatches=step.microbatches,
            fsdp=step.fsdp,
        )
        if probe:
            rec["extrapolated"] = _probe_stats(cfg, shape, mesh, step, remat,
                                               remat_policy, dev)
    except Exception as e:  # noqa: BLE001 (a failing cell is a result)
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


# ---------------------------------------------------------------------------
# the SSSP workload
# ---------------------------------------------------------------------------


def sssp_block(n_vertices: int, avg_deg: int, num_shards: int, rank: int,
               device, seed: int = 0):
    """Rank ``rank``'s :class:`~repro_torch.core.distributed.ShardedGraph`
    block of a uniform random graph of ``n_vertices`` vertices and
    ``avg_deg`` out-edges a vertex: n_loc = ceil(n / P) owned vertices,
    E_loc = n_loc * avg_deg edges from them to uniform targets with U(0, 1)
    weights (the reference's dry-run shapes), drawn from ``seed`` and the
    rank. ``in_min`` (its in-edges live on other ranks) is drawn as the
    least of ``avg_deg`` U(0, 1) weights; the source is vertex 0 (rank
    0's)."""
    from repro_torch.core.distributed import ShardedGraph, local_out_view

    n_loc = -(-n_vertices // num_shards)
    n_pad = n_loc * num_shards
    e_loc = n_loc * avg_deg
    rng = np.random.default_rng([seed, rank])
    src = np.sort(rng.integers(0, n_loc, e_loc)).astype(np.int32)
    dst = rng.integers(0, n_vertices, e_loc).astype(np.int32)
    w = rng.random(e_loc, dtype=np.float32)
    real = rank * n_loc + np.arange(n_loc) < n_vertices
    out_min = np.full(n_loc, np.inf, np.float32)
    np.minimum.at(out_min, src, w)
    in_min = rng.random((n_loc, avg_deg), dtype=np.float32).min(axis=1)
    in_min[~real] = np.inf
    out_min[~real] = np.inf
    d0 = np.full(n_loc, np.inf, np.float32)
    st0 = np.zeros(n_loc, np.int32)
    if rank == 0:
        d0[0], st0[0] = 0.0, 1

    def t(x):
        return torch.from_numpy(x).to(device)

    src_l, dst_l, w_l = t(src), t(dst), t(w)
    return ShardedGraph(
        n=n_vertices, n_pad=n_pad, n_loc=n_loc, num_shards=num_shards,
        rank=rank, src_local=src_l, dst=dst_l, w=w_l, d_init=t(d0),
        status_init=t(st0), in_min=t(in_min), out_min=t(out_min),
        ell_out=local_out_view(src_l, dst_l, w_l, n_loc, n_pad))


def sssp_phase(sg, schedule: str) -> dict:
    """One phase (``cap = 1``) of the legacy program on ``sg`` over the
    default group, its tensors real:
    ``{flops, bytes_accessed, collectives, memory, seconds}`` as
    :func:`trace_step` gives them (``flops``: no product runs)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.core.distributed import make_distributed_sssp

    stats: dict = {"by_kind": dict.fromkeys(KINDS, 0)}
    fn = make_distributed_sssp(schedule=schedule, stats=stats)
    acc = Accounting()
    fields = [f.name for f in dataclasses.fields(sg)]
    argument = acc.hold(_tensors([getattr(sg, f) for f in fields]))
    t0 = now()
    with FlopCounterMode(display=False) as flops, acc:
        out = fn(sg, 1)
        output = _nbytes(_tensors(out))
    if sg.device.type == "cuda":
        torch.cuda.synchronize(sg.device)
    return {"flops": float(flops.get_total_flops()),
            "bytes_accessed": float(acc.bytes_accessed),
            "collectives": stats["by_kind"],
            "memory": {"argument_bytes": int(argument),
                       "output_bytes": int(output),
                       "temp_bytes": int(acc.peak),
                       "generated_code_bytes": 0},
            "seconds": now() - t0, "phases": int(out[1])}


def run_sssp(mesh_kind: str, n_vertices: int = 1 << 24, avg_deg: int = 16,
             schedule: str = "reduce_scatter", device=None) -> dict:
    """Dry-run the paper's own workload on the production mesh: rank 0's
    block of the legacy distributed program (vertices over every mesh
    axis) for one phase on ``device`` (None = the card; raises where there
    is none, as ``resolve_device`` does: the CPU runs the kernels' plain
    twins, so only a caller that asks for it gets it)."""
    dev = resolve_device(device)
    multi = mesh_kind == "multipod"
    P = int(np.prod(PRODUCTION_SHAPE[multi]))
    rec = {"arch": f"sssp-n{n_vertices}-d{avg_deg}-{schedule}",
           "shape": "phased_sssp", "mesh": mesh_kind, "chips": P,
           "device": str(dev)}
    t0 = now()
    try:
        mesh = make_production_mesh(multi_pod=multi, rank=0, device=dev)
        sg = sssp_block(n_vertices, avg_deg, P, mesh.rank, dev)
        got = sssp_phase(sg, schedule)
        rec.update(
            status="ok", rank=mesh.rank, compile_s=round(now() - t0, 1),
            flops=got["flops"], bytes_accessed=got["bytes_accessed"],
            collectives=got["collectives"],
            memory={k: got["memory"][k] for k in
                    ("argument_bytes", "output_bytes", "temp_bytes")},
            n_loc=sg.n_loc, e_loc=int(sg.w.shape[0]), phases=got["phases"],
        )
    except Exception as e:  # noqa: BLE001
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id (assignment or module name)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true", help="every (arch x shape)")
    ap.add_argument("--workload", default="lm", choices=["lm", "sssp"])
    ap.add_argument("--schedule", default="reduce_scatter",
                    choices=["reduce_scatter", "allreduce"])
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--no-shd", action="store_true",
                    help="the reference's baseline without activation "
                         "sharding constraints (a no-op here, recorded)")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="where --workload sssp runs (default: the card; "
                         "the LM cells' tensors are fake)")
    ap.add_argument("--out", default=None, help="output dir for JSON records")
    args = ap.parse_args(argv)

    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    records = []
    if args.workload == "sssp":
        for mk in meshes:
            rec = run_sssp(mk, schedule=args.schedule, device=args.device)
            print(json.dumps(rec, indent=None, default=str), flush=True)
            records.append(rec)
    else:
        archs = list(ALIASES) if args.all or not args.arch else [args.arch]
        shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
        for mk in meshes:
            for a in archs:
                for s in shapes:
                    rec = run_cell(a, s, mk, remat=not args.no_remat,
                                   use_shd=not args.no_shd)
                    brief = {k: v for k, v in rec.items() if k != "traceback"}
                    print(json.dumps(brief, default=str), flush=True)
                    records.append(rec)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        tag = f"{args.workload}_{args.mesh}_{args.arch or 'all'}_{args.shape or 'all'}"
        tag = tag.replace("/", "_").replace(".", "_")
        with open(os.path.join(args.out, f"{tag}.json"), "w") as f:
            json.dump(records, f, indent=1, default=str)


if __name__ == "__main__":
    main()
