"""Fault-tolerant training loop (counterpart of
``repro.runtime.train_loop``), on one device or on a mesh.

  * checkpoint/restart: periodic asynchronous checkpoints (atomic; see
    ``repro_torch.checkpoint``), in the reference's format; on start the
    loop resumes from the newest complete one, and the data stream is a
    pure function of ``(seed, step)``, so it replays exactly from there;
  * poisoned steps: the optimizer's finiteness guard leaves the
    parameters and ``m`` unchanged on a step whose gradient norm is not
    finite, and the loop counts the step as skipped. As in the reference,
    the guard does not cover ``v``, which takes the step's NaN (see
    ``optim.adamw``);
  * stragglers: a per-step wall-clock watchdog callback.

With ``mesh=`` (a ``launch.mesh.Mesh``; every rank of it runs the loop)
the path is the reference's: the parameters placed by ``param_specs``,
the optimizer state by ``state_specs_for``, each step's global batch cut
per ``batch_specs`` inside the step, checkpoints gathered to rank 0 and
restored onto the current mesh (whatever mesh wrote them: the elastic
restart of ``runtime/elastic.py``). Without it every tensor lives on
``device``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, batch_for
from repro_torch.kernels.config import resolve_device
from repro_torch.launch.mesh import Mesh
from repro_torch.models import init_params, train_loss
from repro_torch.models.layers import ShardingCtx
from repro_torch.obs.timer import now
from repro_torch.optim.adamw import (
    OptConfig,
    apply_updates,
    init_opt_state,
    state_specs_for,
)
from repro_torch.sharding.partition import (
    param_specs,
    place_params,
    to_shardings,
)


@dataclasses.dataclass
class TrainResult:
    losses: list[float]
    final_step: int
    skipped_steps: int
    restored_from: int | None


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a != "model")


def value_and_grad(cfg: ModelConfig, params, batch,
                   shd: ShardingCtx | None = None, remat: bool = True,
                   remat_policy: str = "full"):
    """(the loss, detached; its gradient by parameter name): the model's
    parameters are switched to ``requires_grad``. On a mesh each gradient
    is the block of its parameter."""
    params.requires_grad_(True)
    names, ps = zip(*params.named_parameters())
    loss = train_loss(cfg, params, batch, shd, remat=remat,
                      remat_policy=remat_policy)
    grads = torch.autograd.grad(loss, ps)
    return loss.detach(), dict(zip(names, grads))


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig, remat: bool = True,
                    *, mesh: Mesh | None = None):
    """``step(params, opt_state, batch) -> (loss, stats)``: the loss and its
    gradients, then one AdamW step in place. ``loss`` is a detached 0-d
    tensor. With ``mesh`` the step is the sharded one (``params`` placed,
    ``batch`` global)."""
    shd = (None if mesh is None else
           ShardingCtx(dp=data_axes(mesh), tp="model", mesh=mesh))

    def step(params, opt_state, batch):
        loss, grads = value_and_grad(cfg, params, batch, shd, remat)
        stats = apply_updates(params, grads, opt_state, opt_cfg)
        return loss, stats

    return step


def train(
    cfg: ModelConfig,
    steps: int,
    dcfg: DataConfig,
    opt_cfg: OptConfig | None = None,
    ckpt_dir: str | None = None,
    ckpt_every: int = 50,
    seed: int = 0,
    remat: bool = True,
    watchdog: Callable[[int, float], None] | None = None,
    step_timeout_s: float = 3600.0,
    log_every: int = 10,
    param_dtype=torch.float32,
    device=None,
    *,
    mesh: Mesh | None = None,
) -> TrainResult:
    """Train ``cfg`` for ``steps`` steps on ``device`` (None = the CUDA
    card), from ``init_params(cfg, seed=seed)`` or the newest complete
    checkpoint in ``ckpt_dir`` (the manager keeps the newest 3). Checkpoints
    are written asynchronously every ``ckpt_every`` steps and once at the end.
    ``watchdog(step, seconds)`` is called after every step that took longer
    than ``step_timeout_s``. ``log_every`` is the reference's argument,
    which logs nothing there either. With ``mesh`` every rank of it calls
    this, on the mesh's device (``device`` is not read)."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    opt_cfg = opt_cfg or OptConfig(total_steps=steps)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    restored = mgr.latest_step() if mgr is not None else None
    shapes = init_params(cfg, dtype=param_dtype, device="meta")
    shardings = None
    if mesh is not None:
        pspecs = param_specs(cfg, shapes)
        ospecs = state_specs_for(
            init_opt_state(shapes, opt_cfg, device="meta"), pspecs)
        shardings = {"params": to_shardings(mesh, pspecs),
                     "opt": to_shardings(mesh, ospecs)}
    if restored is None:
        params = init_params(cfg, seed=seed, dtype=param_dtype, device=dev)
        if mesh is not None:
            params = place_params(params, mesh, pspecs)
        opt_state = init_opt_state(params, opt_cfg, device=dev)
        start = 0
    else:  # the templates hold shapes only: nothing is drawn or allocated
        state = mgr.restore(restored, {
            "params": shapes,
            "opt": init_opt_state(shapes, opt_cfg, device="meta")},
            device=dev, shardings=shardings)
        params, opt_state = state["params"], state["opt"]
        start = restored

    step_fn = make_train_step(cfg, opt_cfg, remat=remat, mesh=mesh)
    losses: list[float] = []
    skipped = 0
    for s in range(start, steps):
        t0 = now()
        batch = batch_for(cfg, dcfg, s, device=dev)
        loss, stats = step_fn(params, opt_state, batch)
        loss_f = float(loss)
        if not bool(stats["finite"]):
            skipped += 1
        losses.append(loss_f)
        dt = now() - t0
        if watchdog is not None and dt > step_timeout_s:
            watchdog(s, dt)
        if mgr is not None and (s + 1) % ckpt_every == 0:
            mgr.save_async(s + 1, {"params": params, "opt": opt_state},
                           shardings)
    if mgr is not None:
        mgr.wait()
        if mgr.latest_step() != steps:
            mgr.save(steps, {"params": params, "opt": opt_state}, shardings)
    return TrainResult(losses=losses, final_step=steps, skipped_steps=skipped,
                       restored_from=restored)
