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
``torch.optim.AdamW`` has none of the three options above. The reference's
``state_specs_for`` (partition specs) comes with the mesh slice.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from repro_torch.kernels.config import resolve_device
from repro_torch.models import leaf_paths


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


def _leaf_shape(params: nn.Module, names: list[str]) -> tuple[int, ...]:
    """The reference's shape of a leaf: a unit leaf stacked over the
    units."""
    p = params.get_parameter(names[0])
    if names[0].startswith("units."):
        return (len(names),) + tuple(p.shape)
    return tuple(p.shape)


def init_opt_state(params: nn.Module, cfg: OptConfig, device=None) -> dict:
    """Zero moments for every leaf of ``params`` on ``device`` (None = the
    CUDA card; ``"meta"`` gives the shapes only)."""
    dev = (torch.device("meta") if str(device) == "meta"
           else resolve_device(device))
    m_dt = torch.bfloat16 if cfg.m_dtype == "bfloat16" else torch.float32

    def zeros(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    m, v = {}, {}
    for path, names in leaf_paths(params).items():
        shape = _leaf_shape(params, names)
        m[path] = zeros(shape, m_dt)
        if cfg.v_mode == "factored" and _factorable(shape):
            v[path] = {"vr": zeros(shape[:-1]),
                       "vc": zeros(shape[:-2] + shape[-1:])}
        else:
            v[path] = {"v": zeros(shape)}
    return {"step": zeros((), torch.int32), "m": m, "v": v}


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


def _vhat_update(v_entry: dict, g2, b2):
    """Update a second-moment entry; returns (new entry, dense vhat)."""
    if "v" in v_entry:
        nv = b2 * v_entry["v"] + (1 - b2) * g2
        return {"v": nv}, nv
    vr = b2 * v_entry["vr"] + (1 - b2) * torch.mean(g2, dim=-1)
    vc = b2 * v_entry["vc"] + (1 - b2) * torch.mean(g2, dim=-2)
    denom = torch.clamp(torch.mean(vr, dim=-1, keepdim=True), min=1e-30)
    vhat = vr[..., None] * (vc[..., None, :] / denom[..., None])
    return {"vr": vr, "vc": vc}, vhat


def _leaf_update(p, g, m, ve: dict, cfg: OptConfig, scale, lr, bc1, bc2,
                 finite) -> None:
    """One leaf's AdamW step, written into ``p``, ``m`` and ``ve`` in
    place."""
    g32 = g.to(torch.float32) * scale
    m32 = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g32
    ve_new, vhat = _vhat_update(ve, torch.square(g32), cfg.b2)
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
