"""Partition rules (counterpart of ``repro.sharding.partition``): where each
parameter, batch, cache and optimizer leaf lives on a ``(data, model)``
:class:`~repro_torch.launch.mesh.Mesh`, and the placement that follows them.

A spec is a tuple with one entry a dim: None (whole), an axis name, or a
tuple of axis names (the reference's ``PartitionSpec`` entries). The
reference stacks every ``units/...`` leaf over the units; the port keeps a
module a unit, so a parameter spec is a :class:`Spec`: the per-unit dims,
and ``unit``, the axis that the reference's FSDP gives the unit stack
(None, or "data": then unit u's leaf lies whole, as its dims say, on the
data rank ``u // (U / dp)``). :func:`stacked` gives the reference's tuple
back. Optimizer, batch and cache specs are plain tuples of the port's own
layouts (the optimizer state is stacked as the reference's).

A rank holds exactly the block of each leaf that the reference's
``NamedSharding`` gives the device at its coordinates (:func:`place`);
:func:`place_params` cuts a model's parameters so, and the model then
computes by gathering each unit's weights before use
(``models.transformer``, ``sharding.comm``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import Mesh
from repro_torch.sharding import comm

TP = "model"


@dataclasses.dataclass(frozen=True)
class Spec:
    """A parameter leaf's spec: ``dims`` for the port's tensor (a unit's
    leaf has no stack axis), ``unit`` the axis of the reference's unit
    stack (None or "data")."""

    dims: tuple
    unit: str | None = None


def stacked(path: str, spec: Spec) -> tuple:
    """The reference's spec of leaf ``path`` (a unit leaf's stack axis
    first)."""
    if path.startswith("units/"):
        return (spec.unit,) + spec.dims
    return spec.dims


def _from_stacked(path: str, dims: tuple) -> Spec:
    if path.startswith("units/"):
        return Spec(tuple(dims[1:]), dims[0])
    return Spec(tuple(dims))


def leaf_shapes(params: nn.Module) -> dict[str, tuple]:
    """The reference's shape of every leaf (a unit leaf stacked over the
    units), by leaf path; ``params`` may live on the meta device."""
    from repro_torch.models.transformer import leaf_paths

    out = {}
    for path, names in leaf_paths(params).items():
        shape = tuple(params.get_parameter(names[0]).shape)
        out[path] = ((len(names),) + shape if path.startswith("units/")
                     else shape)
    return out


def _unit_rule(names: tuple, nd: int) -> tuple:
    """The stacked spec of a leaf under ``units`` (nd counts the stack)."""
    nm = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    if nm in ("norm1", "norm2", "q_norm", "k_norm", "A_log", "D", "dt_bias"):
        return (None,) * nd
    if parent == "moe":
        if nm == "router":
            return (None,) * nd
        return (None, TP) + (None,) * (nd - 2)  # experts over tp
    if nm in ("wq", "wk", "wv", "wi", "wg", "wz", "wx", "wb", "wc", "wdt"):
        return (None,) * (nd - 1) + (TP,)  # column parallel
    if nm in ("bq", "bk", "bv"):
        return (None, TP)
    if nm in ("wo", "out_proj"):
        return (None, TP, None)  # row parallel (contracting dim sharded)
    if nm in ("conv_wx", "conv_wb", "conv_wc"):
        return (None, None, TP)
    if nm in ("conv_bx", "conv_bb", "conv_bc", "norm"):
        return (None, TP)
    return (None,) * nd


def param_specs(cfg: ModelConfig, params_shape: nn.Module) -> dict[str, Spec]:
    """The spec of every parameter leaf, by leaf path: the embedding's
    vocabulary and the LM head's over "model", attention and MLP
    projections column- or row-parallel, experts over "model" (expert
    parallelism), norms, the router and the SSM scalars whole."""
    out = {}
    for path, shape in leaf_shapes(params_shape).items():
        names = tuple(path.split("/"))
        if names[0] == "embed":
            dims = (TP, None)
        elif names[0] == "lm_head":
            dims = (None, TP)
        elif names[0] == "final_norm":
            dims = (None,)
        elif names[0] == "units":
            dims = _unit_rule(names, len(shape))
        else:
            dims = (None,) * len(shape)
        out[path] = _from_stacked(path, dims)
    return out


def add_fsdp(specs: dict[str, Spec], shapes: nn.Module, axis: str = "data",
             size: int = 16) -> dict[str, Spec]:
    """The specs with FSDP over ``axis``: in every leaf of two or more
    (stacked) dims, the largest dim still whole whose length ``size``
    divides (the first of equals) also goes to ``axis``. That dim may be a
    unit stack: its ``Spec.unit`` then names the axis. Leaves with no such
    dim keep their spec."""
    out = {}
    for path, shape in leaf_shapes(shapes).items():
        spec = specs[path]
        if len(shape) < 2:
            out[path] = spec
            continue
        t = list(stacked(path, spec))
        t += [None] * (len(shape) - len(t))
        best, best_dim = -1, None
        for i, n in enumerate(shape):
            if t[i] is None and n % size == 0 and n > best:
                best, best_dim = n, i
        if best_dim is None:
            out[path] = spec
            continue
        t[best_dim] = axis
        out[path] = _from_stacked(path, tuple(t))
    return out


def batch_specs(cfg: ModelConfig, batch_shape: dict, dp: tuple,
                mesh: Mesh | None = None) -> dict[str, tuple]:
    """The batch's leading dim over the data axes ``dp`` where it divides
    them; every other leaf and dim whole."""
    dp_n = 1 if mesh is None else mesh.size(dp)
    out = {}
    for name, leaf in batch_shape.items():
        nd = len(leaf.shape)
        if (name in ("tokens", "labels", "token", "embeds", "vision")
                and leaf.shape[0] % max(dp_n, 1) == 0):
            out[name] = (dp,) + (None,) * (nd - 1)
        else:
            out[name] = (None,) * nd
    return out


def cache_specs(cfg: ModelConfig, cache_shape: list, dp: tuple,
                mesh: Mesh | None = None) -> dict[str, dict[str, tuple]]:
    """A decode cache's specs, ``{layer: {leaf: spec}}``, for every unit's
    dict of ``cache_shape`` (the port's cache: one dict a unit). K / V
    (B, S, K, dh): the batch over ``dp``, the sequence over "model"; Mamba
    states: channels or heads over "model"; a dim its axis does not divide
    stays whole (e.g. batch 1)."""
    dp_n = 1 if mesh is None else mesh.size(dp)
    tp_n = 1 if mesh is None else mesh.size(TP)
    out: dict[str, dict[str, tuple]] = {}
    for lname, entry in cache_shape[0].items():
        out[lname] = {}
        for nm, leaf in entry.items():
            shape = tuple(leaf.shape)
            bdp = dp if shape[0] % max(dp_n, 1) == 0 else None
            if nm in ("k", "v", "xk", "xv"):
                seq = TP if shape[1] % max(tp_n, 1) == 0 else None
                spec = (bdp, seq, None, None)
            elif nm in ("convx", "convb", "convc"):
                ch = TP if shape[2] % max(tp_n, 1) == 0 else None
                spec = (bdp, None, ch)
            elif nm == "ssm":
                hd = TP if shape[1] % max(tp_n, 1) == 0 else None
                spec = (bdp, hd, None, None)
            else:
                spec = (None,) * len(shape)
            out[lname][nm] = spec
    return out


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def place(mesh: Mesh, x: torch.Tensor, spec: tuple) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` under ``spec``."""
    return comm.place(mesh, x, spec)


def gather(mesh: Mesh, x: torch.Tensor, spec: tuple) -> torch.Tensor:
    """The whole tensor from every rank's block under ``spec``."""
    return comm.gather_whole(mesh, x, spec)


@dataclasses.dataclass(frozen=True)
class Placed:
    """How one parameter tensor is placed: its spec's dims, the owner of a
    unit leaf given to one data rank, its whole shape."""

    dims: tuple
    owner: int | None
    shape: tuple


def _param_table(model: nn.Module):
    """(module, local name, leaf path, unit index or None) of every
    parameter, in ``named_parameters`` order."""
    out = []
    for name, _ in model.named_parameters():
        parts = name.split(".")
        unit = None
        if parts[0] == "units":
            unit = int(parts[1])
            path = "/".join(["units"] + parts[2:])
        else:
            path = "/".join(parts)
        module = model.get_submodule(".".join(parts[:-1]))
        out.append((module, parts[-1], path, unit))
    return out


@torch.no_grad()
def place_params(model: nn.Module, mesh: Mesh,
                 specs: dict[str, Spec]) -> nn.Module:
    """Cut ``model``'s parameters, in place, to this rank's blocks under
    ``specs`` (a unit leaf that another data rank holds becomes an empty
    tensor), on the mesh's device; record the placement on each module
    (``module.placed``) and the mesh and specs on the model
    (``model.mesh``, ``model.specs``). Returns the model."""
    n_units = len(getattr(model, "units", ()))
    for module, local, path, unit in _param_table(model):
        p = module._parameters[local]
        spec = specs[path]
        owner = None  # the data rank that holds a unit leaf FSDP gives it
        if unit is not None and spec.unit is not None:
            owner = unit // (n_units // mesh.size(spec.unit))
        if owner is not None and mesh.coord(spec.unit) != owner:
            block = torch.empty(0, dtype=p.dtype, device=mesh.device)
        else:
            block = comm.place(mesh, p.data, spec.dims)
        module._parameters[local] = nn.Parameter(
            block, requires_grad=p.requires_grad)
        if not hasattr(module, "placed"):
            module.placed = {}
        module.placed[local] = Placed(spec.dims, owner, tuple(p.shape))
    model.mesh, model.specs = mesh, dict(specs)
    return model


def gather_param(model: nn.Module, name: str, value=None) -> torch.Tensor:
    """Parameter ``name`` of a placed model (or ``value``, a tensor placed
    as it is: its gradient) whole on every rank, no autograd."""
    parts = name.split(".")
    module = model.get_submodule(".".join(parts[:-1]))
    pl = module.placed[parts[-1]]
    x = (module._parameters[parts[-1]] if value is None else value).detach()
    mesh = model.mesh
    if pl.owner is None:
        return comm.gather_whole(mesh, x, pl.dims)
    # the owner row joins its blocks over "model", then sends the leaf out
    if mesh.coord("data") == pl.owner:
        x = comm.gather_whole(mesh, x, pl.dims)
    return comm.broadcast(mesh, "data", x, pl.owner, pl.shape, x.dtype)


def place_like(model: nn.Module, name: str, whole: torch.Tensor):
    """This rank's block of ``whole``, a tensor shaped and placed as
    parameter ``name`` of a placed model (its gradient, say); empty where
    another data rank holds the parameter."""
    parts = name.split(".")
    pl = model.get_submodule(".".join(parts[:-1])).placed[parts[-1]]
    mesh = model.mesh
    if pl.owner is not None and mesh.coord("data") != pl.owner:
        return torch.empty(0, dtype=whole.dtype, device=mesh.device)
    return comm.place(mesh, whole, pl.dims)


class Gathered:
    """A placed module as the layer functions read it: each parameter whole
    (gathered on first use through :func:`comm.gather_param`, with its
    gradient rule; kept for the view's life), each submodule a view, any
    other attribute the module's. :meth:`local` gathers over "data" only
    (the expert-parallel MoE's experts keep their blocks over "model")."""

    def __init__(self, module: nn.Module, mesh: Mesh):
        self._module, self._mesh, self._cache = module, mesh, {}

    def _get(self, name: str, join_model: bool):
        key = (name, join_model)
        if key not in self._cache:
            pl = self._module.placed[name]
            dims = pl.dims if join_model else tuple(
                a if a != TP else None for a in pl.dims)
            shape = pl.shape if join_model else tuple(
                n // self._mesh.size(TP) if a == TP else n
                for n, a in zip(pl.shape, pl.dims))
            self._cache[key] = comm.gather_param(
                self._mesh, self._module._parameters[name], dims, pl.owner,
                shape)
        return self._cache[key]

    def local(self, name: str):
        return self._get(name, False)

    def __getattr__(self, name: str):
        module = self.__dict__["_module"]
        if name in module._parameters:
            return self._get(name, True)
        if name in module._modules:
            return Gathered(module._modules[name], self._mesh)
        return getattr(module, name)


def to_shardings(mesh: Mesh, specs: Any) -> Any:
    """``specs`` with every spec paired with ``mesh``: the tree that
    ``CheckpointManager.restore`` takes where the reference takes
    ``NamedSharding``s."""
    if isinstance(specs, dict):
        return {k: to_shardings(mesh, v) for k, v in specs.items()}
    return Sharding(mesh, specs)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""

    mesh: Mesh
    spec: Any
