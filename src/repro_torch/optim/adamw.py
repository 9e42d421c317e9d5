"""AdamW with the reference's large-scale memory options (counterpart of
``repro.optim.adamw``), as plain functions on tensors:

  * ``m_dtype="bfloat16"``: the momentum stored in bf16 (quantised on
    write), the update math in f32;
  * ``v_mode="factored"``: an Adafactor-style rank-1 second moment over the
    last two axes (row and column EMAs) of every factorable leaf;
  * global-norm clipping and a cosine schedule with linear warm-up,
    computed in f32 tensors as the reference computes them;
  * a global-finiteness guard: a step whose gradient norm is not finite
    leaves the parameters and ``m`` as they were. As in the reference,
    ``v`` is NOT guarded: such a step writes its NaN into ``v`` (and the
    step counter advances), so the next finite step turns those
    parameters into NaN.

The state is the reference's tree with its leaf paths as keys: ``{"step":
int32 0-d, "m": {path: tensor}, "v": {path: {"v": tensor} or {"vr", "vc"}}}``
(``models.leaf_paths``). A ``units/...`` leaf is stacked over the units
(U, ...), as the reference's vmap stacks it, and the reference factorises
the STACKED leaf: a leaf that is 1-D in each unit (norm scales, ``A_log``,
``D``, ``dt_bias``, conv biases) is (U, D), factored across the units when
U >= 2. ``apply_updates`` updates such a leaf stacked; every other unit
leaf factorises (or not) per unit exactly as its stacked form does, and is
updated unit by unit in place, through views of the stacked state.
``torch.optim.AdamW`` has none of the three options above.

On a mesh (a model placed by ``sharding.partition.place_params``) the
state is the rank's block of each leaf under :func:`state_specs_for` (the
moments inherit the parameters' specs), ``grads`` the blocks of the
parameters' gradients, and ``apply_updates`` updates the blocks: the
global norm counts every element of a leaf once (one rank of each set of
copies adds it), and a factored mean over a dim that lies across an axis
sums over that axis's group before dividing by the dim's whole length.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from repro_torch.kernels.config import resolve_device
from repro_torch.models import leaf_paths
from repro_torch.sharding import comm
from repro_torch.sharding.partition import stacked


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    m_dtype: str = "float32"  # or "bfloat16"
    v_mode: str = "full"  # or "factored"


def _factorable(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= 2 and shape[-2] >= 2


def _placed(params: nn.Module, name: str):
    """Parameter ``name``'s placement on a mesh (None off one)."""
    parts = name.split(".")
    module = params.get_submodule(".".join(parts[:-1]))
    placed = getattr(module, "placed", None)
    return None if placed is None else placed[parts[-1]]


def _leaf_shape(params: nn.Module, names: list[str]) -> tuple[int, ...]:
    """The reference's shape of a leaf: a unit leaf stacked over the
    units; a placed parameter's whole shape."""
    pl = _placed(params, names[0])
    shape = (tuple(params.get_parameter(names[0]).shape) if pl is None
             else pl.shape)
    if names[0].startswith("units."):
        return (len(names),) + shape
    return shape


def state_specs_for(state: dict, param_specs: dict) -> dict:
    """The specs of an optimizer state's leaves (stacked as the state is):
    ``m`` and a full ``v`` as their parameter, a factored ``v``'s rows
    without the last dim and its columns without the second-last."""
    m, v = {}, {}
    for path, entry in state["v"].items():
        spec = stacked(path, param_specs[path])
        m[path] = spec
        v[path] = ({"v": spec} if "v" in entry else
                   {"vr": spec[:-1], "vc": spec[:-2] + spec[-1:]})
    return {"step": (), "m": m, "v": v}


def _local_shape(mesh, shape: tuple, spec: tuple) -> tuple:
    return tuple(n // mesh.size(a) if a is not None else n
                 for n, a in zip(shape, spec))


def init_opt_state(params: nn.Module, cfg: OptConfig, device=None) -> dict:
    """Zero moments for every leaf of ``params`` on ``device`` (None = the
    CUDA card, or a placed model's mesh device; ``"meta"`` gives the shapes
    only). A placed model gets the rank's block of each leaf."""
    mesh = getattr(params, "mesh", None)
    if str(device) == "meta":
        dev, mesh = torch.device("meta"), None
    elif mesh is not None and device is None:
        dev = mesh.device
    else:
        dev = resolve_device(device)
    m_dt = torch.bfloat16 if cfg.m_dtype == "bfloat16" else torch.float32
    m, v = {}, {}
    for path, names in leaf_paths(params).items():
        shape = _leaf_shape(params, names)
        m[path] = shape
        if cfg.v_mode == "factored" and _factorable(shape):
            v[path] = {"vr": shape[:-1], "vc": shape[:-2] + shape[-1:]}
        else:
            v[path] = {"v": shape}
    if mesh is not None:  # the rank's block of each leaf
        specs = state_specs_for({"v": v}, params.specs)
        m = {k: _local_shape(mesh, t, specs["m"][k]) for k, t in m.items()}
        v = {k: {n: _local_shape(mesh, t, specs["v"][k][n])
                 for n, t in e.items()} for k, e in v.items()}

    def zeros(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return {"step": zeros((), torch.int32),
            "m": {k: zeros(t, m_dt) for k, t in m.items()},
            "v": {k: {n: zeros(t) for n, t in e.items()}
                  for k, e in v.items()}}


def schedule(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int tensor), in f32 with the
    reference's order of operations."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp((step + 1.0) / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tensors))


def _vhat_update(v_entry: dict, g2, b2, means=(torch.mean, torch.mean)):
    """Update a second-moment entry; returns (new entry, dense vhat).
    ``means`` reduce over the parameter's last dim and its second-last
    (``f(x, dim, keepdim=False)``; on a mesh they sum across the dim's
    axis)."""
    mean_c, mean_r = means
    if "v" in v_entry:
        nv = b2 * v_entry["v"] + (1 - b2) * g2
        return {"v": nv}, nv
    vr = b2 * v_entry["vr"] + (1 - b2) * mean_c(g2, -1)
    vc = b2 * v_entry["vc"] + (1 - b2) * mean_r(g2, -2)
    denom = torch.clamp(mean_r(vr, -1, keepdim=True), min=1e-30)
    vhat = vr[..., None] * (vc[..., None, :] / denom[..., None])
    return {"vr": vr, "vc": vc}, vhat


def _leaf_update(p, g, m, ve: dict, cfg: OptConfig, scale, lr, bc1, bc2,
                 finite, means=(torch.mean, torch.mean)) -> None:
    """One leaf's AdamW step, written into ``p``, ``m`` and ``ve`` in
    place."""
    g32 = g.to(torch.float32) * scale
    m32 = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g32
    ve_new, vhat = _vhat_update(ve, torch.square(g32), cfg.b2, means)
    upd = (m32 / bc1) / (torch.sqrt(vhat / bc2) + cfg.eps)
    p32 = p.to(torch.float32)
    upd = upd + cfg.weight_decay * p32
    # the NaN guard: a poisoned step leaves p and m (not v) as they were
    p.copy_(torch.where(finite, p32 - lr * upd, p32))
    m.copy_(torch.where(finite, m32, m.to(torch.float32)))
    for key, val in ve_new.items():
        ve[key].copy_(val)


@torch.no_grad()
def apply_updates(params: nn.Module, grads: dict, state: dict,
                  cfg: OptConfig) -> dict:
    """One AdamW step, in place: ``params``' parameters and ``state``'s
    tensors are written. ``grads`` maps each parameter name (as
    ``params.named_parameters()`` gives it) to its gradient. Returns the
    stats: ``gnorm``, ``lr`` and ``finite`` (0-d tensors)."""
    mesh = getattr(params, "mesh", None)
    if mesh is not None:
        return _apply_sharded(params, mesh, grads, state, cfg)
    step = state["step"]
    gnorm = global_norm(grads.values())
    finite = torch.isfinite(gnorm)
    scale = torch.where(finite & (gnorm > cfg.clip_norm),
                        cfg.clip_norm / (gnorm + 1e-12),
                        torch.ones_like(gnorm))
    lr = schedule(cfg, step)
    t = (step + 1).to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.full_like(t, cfg.b1), t)
    bc2 = 1.0 - torch.pow(torch.full_like(t, cfg.b2), t)
    hyper = (cfg, scale, lr, bc1, bc2, finite)

    for path, names in leaf_paths(params).items():
        m, ve = state["m"][path], state["v"][path]
        ps = [params.get_parameter(n) for n in names]
        gs = [grads[n] for n in names]
        if not names[0].startswith("units."):
            _leaf_update(ps[0], gs[0], m, ve, *hyper)
        elif "vr" in ve and ps[0].dim() == 1:
            # factored across the units: the stacked leaf, as the reference
            stacked = torch.stack([p.detach() for p in ps])
            _leaf_update(stacked, torch.stack(gs), m, ve, *hyper)
            for u, p in enumerate(ps):
                p.copy_(stacked[u])
        else:
            for u, (p, g) in enumerate(zip(ps, gs)):
                _leaf_update(p, g, m[u], {k: x[u] for k, x in ve.items()},
                             *hyper)
    step.add_(1)
    return {"gnorm": gnorm, "lr": lr, "finite": finite}


def _axis_mean(mesh, axis, n: int):
    """A mean over a dim of whole length ``n`` that lies across ``axis``
    (None: a dim whole on the rank)."""
    if axis is None:
        return torch.mean

    def mean(x, dim, keepdim=False):
        return comm.all_reduce(mesh, axis, x.sum(dim=dim, keepdim=keepdim)) / n
    return mean


def _means(mesh, spec: tuple, shape: tuple):
    """(last-dim mean, second-last-dim mean) of a tensor placed by
    ``spec``."""
    if len(shape) < 2:
        return (torch.mean, torch.mean)
    return (_axis_mean(mesh, spec[-1], shape[-1]),
            _axis_mean(mesh, spec[-2], shape[-2]))


def _counted(mesh, pl) -> bool:
    """Whether this rank adds a parameter's block to the global norm: the
    one rank at coordinate 0 of every axis the block is copied over."""
    used = {a for a in pl.dims if a is not None}
    if pl.owner is not None:
        used.add("data")
    return all(mesh.coords[a] == 0 for a in mesh.axis_names if a not in used)


def _apply_sharded(params: nn.Module, mesh, grads: dict, state: dict,
                   cfg: OptConfig) -> dict:
    """``apply_updates`` on the rank's blocks (see the module's
    docstring)."""
    step = state["step"]
    local = sum(torch.sum(torch.square(grads[n].to(torch.float32)))
                for n, _ in params.named_parameters()
                if _counted(mesh, _placed(params, n)))
    local = torch.as_tensor(local, dtype=torch.float32, device=mesh.device)
    gnorm = torch.sqrt(comm.all_reduce(mesh, None, local))
    finite = torch.isfinite(gnorm)
    scale = torch.where(finite & (gnorm > cfg.clip_norm),
                        cfg.clip_norm / (gnorm + 1e-12),
                        torch.ones_like(gnorm))
    lr = schedule(cfg, step)
    t = (step + 1).to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.full_like(t, cfg.b1), t)
    bc2 = 1.0 - torch.pow(torch.full_like(t, cfg.b2), t)
    hyper = (cfg, scale, lr, bc1, bc2, finite)
    me = mesh.coords["data"]

    for path, names in leaf_paths(params).items():
        m, ve = state["m"][path], state["v"][path]
        spec = stacked(path, params.specs[path])
        shape = _leaf_shape(params, names)
        if not names[0].startswith("units."):
            _leaf_update(params.get_parameter(names[0]), grads[names[0]], m,
                         ve, *hyper, means=_means(mesh, spec, shape))
            continue
        mine = [n for n in names if _placed(params, n).owner in (None, me)]
        ps = [params.get_parameter(n) for n in mine]
        gs = [grads[n] for n in mine]
        if "vr" in ve and len(shape) == 2:
            # factored across the units: the stacked leaf, as the reference
            stack = torch.stack([p.detach() for p in ps])
            _leaf_update(stack, torch.stack(gs), m, ve, *hyper,
                         means=_means(mesh, spec, shape))
            for u, p in enumerate(ps):
                p.copy_(stack[u])
        else:
            means = _means(mesh, spec[1:], shape[1:])
            for u, (p, g) in enumerate(zip(ps, gs)):
                _leaf_update(p, g, m[u], {k: x[u] for k, x in ve.items()},
                             *hyper, means=means)
    step.add_(1)
    return {"gnorm": gnorm, "lr": lr, "finite": finite}
