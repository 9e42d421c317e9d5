"""Fault-tolerant training loop on one device (counterpart of
``repro.runtime.train_loop``).

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

The reference's ``mesh`` argument, its parameter and batch shardings and
the elastic re-mesh (``runtime/elastic.py``) come with the mesh slice; here
every tensor lives on ``device``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, batch_for
from repro_torch.kernels.config import resolve_device
from repro_torch.models import init_params, train_loss
from repro_torch.obs.timer import now
from repro_torch.optim.adamw import OptConfig, apply_updates, init_opt_state


@dataclasses.dataclass
class TrainResult:
    losses: list[float]
    final_step: int
    skipped_steps: int
    restored_from: int | None


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig, remat: bool = True):
    """``step(params, opt_state, batch) -> (loss, stats)``: the loss and its
    gradients (the model's parameters are switched to ``requires_grad``),
    then one AdamW step in place. ``loss`` is a detached 0-d tensor."""

    def step(params, opt_state, batch):
        params.requires_grad_(True)
        names, ps = zip(*params.named_parameters())
        loss = train_loss(cfg, params, batch, remat=remat)
        grads = torch.autograd.grad(loss, ps)
        stats = apply_updates(params, dict(zip(names, grads)), opt_state,
                              opt_cfg)
        return loss.detach(), stats

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
) -> TrainResult:
    """Train ``cfg`` for ``steps`` steps on ``device`` (None = the CUDA
    card), from ``init_params(cfg, seed=seed)`` or the newest complete
    checkpoint in ``ckpt_dir`` (the manager keeps the newest 3). Checkpoints
    are written asynchronously every ``ckpt_every`` steps and once at the end.
    ``watchdog(step, seconds)`` is called after every step that took longer
    than ``step_timeout_s``. ``log_every`` is the reference's argument,
    which logs nothing there either."""
    dev = resolve_device(device)
    opt_cfg = opt_cfg or OptConfig(total_steps=steps)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    restored = mgr.latest_step() if mgr is not None else None
    if restored is None:
        params = init_params(cfg, seed=seed, dtype=param_dtype, device=dev)
        opt_state = init_opt_state(params, opt_cfg, device=dev)
        start = 0
    else:  # the templates hold shapes only: nothing is drawn or allocated
        shapes = init_params(cfg, dtype=param_dtype, device="meta")
        state = mgr.restore(restored, {
            "params": shapes,
            "opt": init_opt_state(shapes, opt_cfg, device="meta")},
            device=dev)
        params, opt_state = state["params"], state["opt"]
        start = restored

    step_fn = make_train_step(cfg, opt_cfg, remat=remat)
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
            mgr.save_async(s + 1, {"params": params, "opt": opt_state})
    if mgr is not None:
        mgr.wait()
        if mgr.latest_step() != steps:
            mgr.save(steps, {"params": params, "opt": opt_state})
    return TrainResult(losses=losses, final_step=steps, skipped_steps=skipped,
                       restored_from=restored)
