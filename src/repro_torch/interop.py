"""Carry graphs, sliced adjacency views and stepper state in from the JAX
package, as numpy; and the LM substrate's weights and decode caches both
ways.

The port never imports the reference; a caller that holds a reference
``Graph``, ``SlicedEll``, ``BatchState``, ``ShardedBatchGraph`` or
``ShardedBatchState`` passes its arrays as a dict of numpy arrays
(``np.asarray`` of each field) and gets the port's counterpart, with no
recomputation (a sharded one as one rank's block). The tests use this to
start both packages from one mid-solve state, and to feed the reference's
own sliced view to the port's kernels. ``lm_params_from_numpy`` /
``lm_params_to_numpy``, ``opt_state_from_numpy`` / ``opt_state_to_numpy``
and ``lm_cache_from_numpy`` / ``lm_cache_to_numpy`` carry a model's
parameters, its optimizer state and its decode caches both ways, in the
reference's stacked ``(U, ...)`` layout. bf16 leaves come out as 2-byte
void records (``BF16_RECORD``), as numpy writes the reference's
``ml_dtypes.bfloat16`` into a checkpoint, and go in from either form.
``flatten_tree`` / ``unflatten_into`` are the one path between such trees
(a model among them) and ``'/'``-keyed host arrays, shared with the
checkpoint manager.

On a mesh: ``lm_shards_from_numpy`` places the reference's parameter tree
on a rank (its blocks, ``sharding.partition.place_params``), and
``lm_params_to_numpy`` of a placed model gathers the whole tree back (every
rank of the mesh calls it); ``flatten_tree`` / ``unflatten_into`` gather
and place the leaves that a ``shardings`` tree names.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.distributed import (
    ShardedBatchGraph,
    ShardedBatchState,
    local_out_view,
)
from repro_torch.core.graph import EllSlice, Graph, SlicedEll, sliced_ell
from repro_torch.core.static_engine import BatchState
from repro_torch.kernels.config import resolve_device
from repro_torch.models.transformer import LM, init_params, leaf_paths
from repro_torch.optim.adamw import OptConfig, init_opt_state, state_specs_for
from repro_torch.sharding.partition import (
    Sharding,
    gather,
    gather_param,
    place,
    place_params,
    to_shardings,
)

BF16_RECORD = np.dtype("V2")  # a bf16 value as numpy stores it, unnamed

_GRAPH_FIELDS = {
    "src": np.int32, "dst": np.int32, "w": np.float32,
    "in_min_static": np.float32, "out_min_static": np.float32,
}


def _tensor(x, dtype, dev) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype != dtype:
        raise TypeError(f"want {np.dtype(dtype)}; got {arr.dtype}")
    return torch.from_numpy(np.array(arr, copy=True)).to(dev)


def graph_from_numpy(fields: dict, device=None) -> Graph:
    """The port's :class:`Graph` from a reference graph's fields
    (``src, dst, w, in_min_static, out_min_static, n, m``) on ``device``
    (None = the CUDA card). The static minima are taken as given."""
    dev = resolve_device(device)
    arrays = {k: _tensor(fields[k], t, dev) for k, t in _GRAPH_FIELDS.items()}
    return Graph(n=int(fields["n"]), m=int(fields["m"]), **arrays)


def sliced_from_numpy(fields: dict, device=None) -> SlicedEll:
    """The port's :class:`~repro_torch.core.graph.SlicedEll` from a
    reference view's arrays on ``device`` (None = the CUDA card):
    ``fields["slices"]`` holds one ``{"rows", "cols", "ws"}`` dict per
    bucket (int32, int32, f32) and ``fields["merge_idx"]`` the (n, C)
    int32 merge plan, taken as given; only its compact form is derived."""
    dev = resolve_device(device)
    slices = [
        EllSlice(rows=_tensor(s["rows"], np.int32, dev),
                 cols=_tensor(s["cols"], np.int32, dev),
                 ws=_tensor(s["ws"], np.float32, dev))
        for s in fields["slices"]
    ]
    return sliced_ell(slices, _tensor(fields["merge_idx"], np.int32, dev))


def combine_limbs(lo, hi) -> np.ndarray:
    """A two-limb (u32 low, i32 high) counter as int64, the way the
    reference's ``combine_limbs`` folds it."""
    lo64 = np.asarray(lo).astype(np.int64)
    hi64 = np.asarray(hi).astype(np.int64)
    return (hi64 << np.int64(32)) + lo64


def state_from_numpy(fields: dict, device=None) -> BatchState:
    """The port's :class:`BatchState` from a reference state's fields on
    ``device`` (None = the CUDA card).

    Two-limb counters (``sum_fringe``/``sum_fringe_hi``,
    ``relax_edges``/``relax_edges_hi``) fold into int64. The carried key
    stack ``crit_keys`` and its ``keys_valid`` flag (a host bool here) come
    over as they are, so both packages continue from one mid-solve state.
    So do the fields a mode carries, each absent or None where the state
    has none: ``dist_true`` (oracle plans), the telemetry rings
    ``fringe_trace`` / ``relax_trace`` / ``attr_trace``, ``delta`` (the
    0-dim f32 bucket width of a delta-stepping state) and ``target`` (the
    (B,) int32 s->t targets).
    """
    dev = resolve_device(device)

    def counter(name):
        folded = combine_limbs(fields[name], fields[name + "_hi"])
        return torch.from_numpy(folded).to(dev)

    def opt(name, dtype, shape=None):
        x = fields.get(name)
        if x is None:
            return None
        if shape is not None:
            x = np.asarray(x).reshape(shape)
        return _tensor(x, dtype, dev)

    return BatchState(
        dist=_tensor(fields["dist"], np.float32, dev),
        status=_tensor(fields["status"], np.int32, dev),
        trips=_tensor(np.asarray(fields["trips"]).reshape(()), np.int32, dev),
        phases=_tensor(fields["phases"], np.int32, dev),
        sum_fringe=counter("sum_fringe"),
        relax_edges=counter("relax_edges"),
        out_deg=_tensor(fields["out_deg"], np.int32, dev),
        crit_keys=opt("crit_keys", np.float32),
        keys_valid=(None if fields.get("keys_valid") is None
                    else bool(np.asarray(fields["keys_valid"]))),
        dist_true=opt("dist_true", np.float32),
        settled_trace=_tensor(fields["settled_trace"], np.int32, dev),
        fringe_trace=opt("fringe_trace", np.int32),
        relax_trace=opt("relax_trace", np.int32),
        attr_trace=opt("attr_trace", np.int32),
        delta=opt("delta", np.float32, ()),
        target=opt("target", np.int32),
        criterion=str(fields["criterion"]),
    )


def sharded_graph_from_numpy(fields: dict, rank: int,
                             device=None) -> ShardedBatchGraph:
    """Rank ``rank``'s block of a reference ``ShardedBatchGraph`` on
    ``device`` (None = the CUDA card): its row of the stacked ``(P,
    E_loc)`` edge arrays (``src_local, dst, w`` and, where present,
    ``tsrc_local, tdst, tw``) and its ``(n_loc,)`` slices of ``in_min``,
    ``out_min`` and ``out_deg``, taken as given; only the rank-local
    outgoing views are built from the rows."""
    dev = resolve_device(device)
    n_loc, n_pad = int(fields["n_loc"]), int(fields["n_pad"])
    lo, hi = rank * n_loc, (rank + 1) * n_loc

    def row(name, dtype):
        return _tensor(np.asarray(fields[name])[rank], dtype, dev)

    def block(name, dtype):
        return _tensor(np.asarray(fields[name])[lo:hi], dtype, dev)

    fwd = (row("src_local", np.int32), row("dst", np.int32),
           row("w", np.float32))
    rev = (None,) * 3
    if fields.get("tsrc_local") is not None:
        rev = (row("tsrc_local", np.int32), row("tdst", np.int32),
               row("tw", np.float32))
    return ShardedBatchGraph(
        n=int(fields["n"]), n_pad=n_pad, n_loc=n_loc,
        num_shards=int(fields["num_shards"]), rank=int(rank),
        src_local=fwd[0], dst=fwd[1], w=fwd[2],
        tsrc_local=rev[0], tdst=rev[1], tw=rev[2],
        in_min=block("in_min", np.float32),
        out_min=block("out_min", np.float32),
        out_deg=block("out_deg", np.int32),
        ell_out=local_out_view(*fwd, n_loc, n_pad),
        ell_t=None if rev[0] is None else local_out_view(*rev, n_loc, n_pad),
    )


def sharded_state_from_numpy(fields: dict, rank: int, num_shards: int,
                             device=None) -> ShardedBatchState:
    """Rank ``rank``'s block of a reference ``ShardedBatchState`` (its
    ``(B, n_pad)`` fields read as global arrays, ``np.asarray`` of each)
    on ``device`` (None = the CUDA card): the ``(B, n_loc)`` column block
    of ``dist``, ``status`` and ``dist_true`` (absent or None off the
    oracle plans), the replicated ``trips``, ``phases`` and
    ``settled_trace``, and the two-limb counters folded into int64."""
    dev = resolve_device(device)
    dist = np.asarray(fields["dist"])
    n_pad = dist.shape[1]
    n_loc = n_pad // int(num_shards)
    cols = slice(rank * n_loc, (rank + 1) * n_loc)

    def counter(name):
        folded = combine_limbs(fields[name], fields[name + "_hi"])
        return torch.from_numpy(folded).to(dev)

    dt = fields.get("dist_true")
    return ShardedBatchState(
        n=int(fields["n"]), n_pad=n_pad, rank=int(rank),
        dist=_tensor(dist[:, cols], np.float32, dev),
        status=_tensor(np.asarray(fields["status"])[:, cols], np.int32, dev),
        trips=_tensor(np.asarray(fields["trips"]).reshape(()), np.int32, dev),
        phases=_tensor(fields["phases"], np.int32, dev),
        sum_fringe=counter("sum_fringe"),
        relax_edges=counter("relax_edges"),
        dist_true=(None if dt is None
                   else _tensor(np.asarray(dt)[:, cols], np.float32, dev)),
        settled_trace=_tensor(fields["settled_trace"], np.int32, dev),
        criterion=str(fields["criterion"]),
    )


def leaf_tensor(arr, dev) -> torch.Tensor:
    """A numpy leaf as a tensor (a copy); the reference's bf16 leaves
    (``ml_dtypes``' bfloat16, which torch cannot read, or its 2-byte void
    records) go through their 16-bit pattern."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16" or arr.dtype == BF16_RECORD:
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.tensor(bits).view(torch.bfloat16).to(dev)
    return torch.tensor(arr).to(dev)


def tensor_to_numpy(tensors, stack: bool = False) -> np.ndarray:
    """A host copy of a tensor, or (``stack``) of a list of tensors stacked
    on a new leading axis; bf16 as ``BF16_RECORD``s. Never aliases the
    tensors, on the CPU either."""
    tensors = list(tensors) if stack else [tensors]
    head = tensors[0]
    shape = ((len(tensors),) if stack else ()) + tuple(head.shape)
    bf16 = head.dtype == torch.bfloat16
    out = torch.empty(shape, dtype=torch.int16 if bf16 else head.dtype)
    into = out.view(torch.bfloat16) if bf16 else out
    with torch.no_grad():
        if stack:
            for u, t in enumerate(tensors):
                into[u].copy_(t)
        else:
            into.copy_(head)
    arr = out.numpy()
    return arr.view(BF16_RECORD) if bf16 else arr


def nest(flat: dict) -> dict:
    """``{"a/b/c": x}`` -> ``{"a": {"b": {"c": x}}}``."""
    tree: dict = {}
    for path, leaf in flat.items():
        *dirs, name = path.split("/")
        node = tree
        for d in dirs:
            node = node.setdefault(d, {})
        node[name] = leaf
    return tree


def _leaf(tree: dict, path: list[str]):
    """The numpy leaf of a parameter path: ``units.<u>.<rest>`` is row u of
    the reference's leaf ``units/<rest>``, stacked over units by vmap."""
    if path[0] == "units":
        node = tree["units"]
        for key in path[2:]:
            node = node[key]
        return np.asarray(node)[int(path[1])]
    node = tree
    for key in path:
        node = node[key]
    return node


def lm_params_from_numpy(cfg, tree: dict, device=None, dtype=None) -> LM:
    """The port's model from the reference's parameters, a nested dict of
    numpy arrays (``jax.tree.map(np.asarray, params)``), on ``device`` (None
    = the CUDA card). The leading U axis that vmap puts on ``units`` is
    unstacked. ``dtype=None`` keeps the tree's dtypes (each must be the
    port's for that parameter); a dtype casts every leaf to it except the
    router, ``A_log``, ``D`` and ``dt_bias``, which stay f32 as the
    reference keeps them."""
    dev = resolve_device(device)
    cast = dtype is not None
    if not cast:  # the model's dtype is its final norm's
        dtype = leaf_tensor(np.asarray(tree["final_norm"]), "cpu").dtype
    model = init_params(cfg, dtype=dtype, device="meta").to_empty(device=dev)
    want = {name for name, _ in model.named_parameters()}
    have = set()
    with torch.no_grad():
        for name, p in model.named_parameters():
            t = leaf_tensor(_leaf(tree, name.split(".")), dev)
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{name}: want shape {tuple(p.shape)}; got "
                                 f"{tuple(t.shape)}")
            if t.dtype != p.dtype and not cast:
                raise TypeError(f"{name}: want {p.dtype}; got {t.dtype}")
            p.copy_(t)
            have.add(name)
    if have != want:
        raise ValueError(f"missing parameters: {sorted(want - have)}")
    return model


def lm_shards_from_numpy(cfg, tree: dict, mesh, specs: dict,
                         dtype=None) -> LM:
    """This rank's blocks of the reference's parameters (a nested dict of
    numpy arrays) under ``specs`` (``partition.param_specs``, with or
    without ``add_fsdp``): the model placed on ``mesh``."""
    model = lm_params_from_numpy(cfg, tree, device="cpu", dtype=dtype)
    return place_params(model, mesh, specs)


def lm_params_to_numpy(model: LM) -> dict:
    """The reference's parameter tree (nested dicts of numpy arrays) of the
    port's model, the inverse of ``lm_params_from_numpy``: each ``units``
    leaf restacked over the units (U, ...); host copies, bf16 leaves as
    ``BF16_RECORD``s. A placed model's leaves are gathered whole (every
    rank of its mesh calls this)."""
    placed = getattr(model, "mesh", None) is not None
    flat = {}
    for path, names in leaf_paths(model).items():
        ps = [gather_param(model, n) if placed else model.get_parameter(n)
              for n in names]
        stacked = path.startswith("units/")
        flat[path] = tensor_to_numpy(ps if stacked else ps[0], stack=stacked)
    return nest(flat)


def flatten_tree(tree: Any, prefix: str = "",
                 shardings: Any = None) -> dict[str, np.ndarray]:
    """Host arrays of a tree's leaves under their ``'/'``-joined keys:
    tensors copied, numpy leaves as given, a model as the reference's
    parameter tree. A tensor whose place in ``shardings`` holds a
    ``Sharding`` is gathered whole first (collective: every rank of its
    mesh calls this)."""
    if isinstance(tree, LM):  # a placed model gathers itself
        tree, shardings = lm_params_to_numpy(tree), None
    if isinstance(tree, dict):
        flat = {}
        for key, sub in tree.items():
            flat.update(flatten_tree(
                sub, f"{prefix}{key}/",
                None if shardings is None else shardings.get(key)))
        return flat
    if isinstance(shardings, Sharding):
        tree = gather(shardings.mesh, tree, shardings.spec)
    leaf = tensor_to_numpy(tree) if torch.is_tensor(tree) else np.asarray(tree)
    return {prefix[:-1]: leaf}


def unflatten_into(template: Any, flat: dict, dev, prefix: str = "",
                   shardings: Any = None) -> Any:
    """The template's structure with each leaf read from ``flat`` onto
    ``dev``: same shapes and dtypes as the template's leaves (which may be
    on the meta device; whole shapes), a model rebuilt as a model. Where
    ``shardings`` holds a ``Sharding`` (for a model: a dict of them by
    leaf path) the leaf is placed: this rank's block on its mesh's
    device."""
    if isinstance(template, LM):
        for path in leaf_paths(template):
            if prefix + path not in flat:
                raise KeyError(f"checkpoint missing leaf {prefix + path!r}")
        sub = {k[len(prefix):]: v for k, v in flat.items()
               if k.startswith(prefix)}
        model = lm_params_from_numpy(
            template.cfg, nest(sub),
            device="cpu" if shardings is not None else dev)
        want = template.final_norm.dtype
        if model.final_norm.dtype != want:
            raise TypeError(f"{prefix[:-1]}: ckpt dtype "
                            f"{model.final_norm.dtype} != {want}")
        if shardings is not None:
            mesh = next(iter(shardings.values())).mesh
            model = place_params(model, mesh, {
                k: v.spec for k, v in shardings.items()})
        return model
    if isinstance(template, dict):
        return {key: unflatten_into(
            sub, flat, dev, f"{prefix}{key}/",
            None if shardings is None else shardings.get(key))
            for key, sub in template.items()}
    key = prefix[:-1]
    if key not in flat:
        raise KeyError(f"checkpoint missing leaf {key!r}")
    arr = flat[key]
    if tuple(arr.shape) != tuple(template.shape):
        raise ValueError(f"{key}: ckpt shape {arr.shape} != "
                         f"{tuple(template.shape)}")
    sharded = isinstance(shardings, Sharding)
    out = leaf_tensor(arr, "cpu" if sharded else dev)
    if out.dtype != template.dtype:
        raise TypeError(f"{key}: ckpt dtype {out.dtype} != {template.dtype}")
    return place(shardings.mesh, out, shardings.spec) if sharded else out


def opt_state_to_numpy(state: dict, model: LM | None = None) -> dict:
    """The reference's optimizer tree ``{"step", "m", "v"}`` (nested dicts
    of numpy arrays, leaf paths as the parameters') of the port's state:
    host copies, a bf16 ``m`` as ``BF16_RECORD``s. The state of a placed
    ``model`` is gathered whole (collective)."""
    return nest(flatten_tree(state, shardings=opt_shardings(state, model)))


def opt_shardings(state: dict, model: LM | None):
    """The ``Sharding`` tree of a placed model's optimizer state (None
    off a mesh)."""
    if model is None or getattr(model, "mesh", None) is None:
        return None
    return to_shardings(model.mesh, state_specs_for(state, model.specs))


def opt_state_from_numpy(cfg: OptConfig, tree: dict, model: LM,
                         device=None) -> dict:
    """The port's optimizer state for ``model`` from the reference's tree
    ``{"step", "m", "v"}`` (numpy leaves, ``jax.tree.map(np.asarray,
    state)``) on ``device`` (None = the CUDA card), read as a checkpoint
    is: every leaf that ``init_opt_state(model, cfg)`` has, with its shape
    and dtype. For a placed ``model``, the rank's blocks."""
    template = init_opt_state(model, cfg, device="meta")
    shardings = opt_shardings(template, model)
    dev = model.mesh.device if shardings is not None else resolve_device(
        device)
    return unflatten_into(template, flatten_tree(tree), dev,
                          shardings=shardings)


def lm_cache_to_numpy(cache: list) -> dict:
    """The port's decode cache (one dict per unit) in the reference's
    stacked layout: ``{"l{j}": {leaf: (U, B, ...)}}``. bf16 leaves come out
    as f32 (exact)."""
    out = {}
    for lname, entry in cache[0].items():
        out[lname] = {}
        for leaf in entry:
            rows = [unit[lname][leaf] for unit in cache]
            stacked = torch.stack(rows).detach().cpu()
            if stacked.dtype == torch.bfloat16:
                stacked = stacked.float()
            out[lname][leaf] = stacked.numpy()
    return out


def lm_cache_from_numpy(tree: dict, device=None) -> list:
    """The port's decode cache from the reference's stacked ``(U, B, ...)``
    cache (numpy leaves, ``jax.tree.map(np.asarray, cache)``) on ``device``
    (None = the CUDA card); the leaves keep their dtypes."""
    dev = resolve_device(device)
    n_units = {np.asarray(v).shape[0]
               for entry in tree.values() for v in entry.values()}
    if len(n_units) != 1:
        raise ValueError(f"cache leaves disagree on U: {sorted(n_units)}")
    (U,) = n_units
    return [{lname: {leaf: leaf_tensor(np.asarray(v)[u], dev)
                     for leaf, v in entry.items()}
             for lname, entry in tree.items()} for u in range(U)]
