"""Elastic scaling: re-plan the mesh from the live ranks and restore a
checkpoint onto it (counterpart of ``repro.runtime.elastic``).

When ranks are lost, the relaunch picks the largest usable mesh from the
ranks that remain and restores the newest checkpoint onto that topology:
``CheckpointManager.restore`` places each rank's block of the whole leaves
per the new mesh's shardings (``runtime.train_loop.train`` does so on
start), so a change of topology needs nothing more.

Policy (greedy, model-axis-preserving): keep the model axis at the largest
power-of-two divisor of the rank count that divides the requested degree;
give the rest to data. Shrinking dp changes the global batch: the caller
decides whether to rescale the learning rate or microbatch (both factors
are in the plan).
"""
from __future__ import annotations

import dataclasses

from repro_torch.launch.mesh import AXES, Mesh, make_mesh


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    dp_degree: int
    tp_degree: int
    dropped_devices: int


def plan_mesh(n_devices: int, want_tp: int = 16,
              global_batch: int | None = None) -> ElasticPlan:
    """Largest (data, model) mesh from ``n_devices`` ranks with tp |
    want_tp; if ``global_batch`` is given, dp is reduced to a divisor of it
    (so the batch still shards evenly after losing ranks)."""
    tp = want_tp
    while tp > 1 and n_devices % tp != 0:
        tp //= 2
    dp = n_devices // tp
    if global_batch is not None:
        while dp > 1 and global_batch % dp != 0:
            dp -= 1
    used = dp * tp
    return ElasticPlan(
        mesh_shape=(dp, tp),
        axis_names=AXES,
        dp_degree=dp,
        tp_degree=tp,
        dropped_devices=n_devices - used,
    )


def build_mesh(plan: ElasticPlan, device=None) -> Mesh | None:
    """The plan's mesh over the first dp * tp ranks of the default group;
    every rank calls it, and the ranks past the mesh get None (idle)."""
    return make_mesh(plan.dp_degree, plan.tp_degree, device)


def remesh_after_failure(n_live: int, want_tp: int = 16,
                         device=None) -> tuple[ElasticPlan, Mesh | None]:
    plan = plan_mesh(n_live, want_tp)
    return plan, build_mesh(plan, device)


def remesh_after_failure_batched(n_live: int, want_tp: int,
                                 global_batch: int, device=None):
    plan = plan_mesh(n_live, want_tp, global_batch)
    return plan, build_mesh(plan, device)
