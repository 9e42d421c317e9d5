"""The port's ``train(mesh=)`` against the reference's ``train`` on the
CPU, and an elastic resume onto another plan, with checkpoints read across
the packages both ways.

``qwen3-moe`` smoke (its expert-parallel gate on), B = 4 x 64 of the
synthetic stream, AdamW with bf16 ``m`` and factored ``v``, a checkpoint
every step:

  1. the reference writes its own starting point (its ``init_params`` of
     seed 0, under ``jax.jit`` as every reference weight of these tests,
     and zero moments) as step 0 into the port's directory; the port's
     ``train`` on a 2 x 2 gloo mesh restores it and trains 2 steps, the
     reference's ``train`` 2 steps on its 2 x 2 Auto mesh from the same
     start: equal losses;
  2. a world of 3 ranks re-plans with ``plan_mesh(3, want_tp=2,
     global_batch=4)`` = (2, 1) (one rank idle): the port restores the
     reference's step-2 checkpoint onto it (every gathered leaf bit-equal
     to the file) and trains step 3;
  3. the reference's ``train`` on its own (2, 1) mesh restores the port's
     step-2 checkpoint (``train_loop.py:91-101``) and trains step 3: the
     same loss as the port's from the reference's checkpoint.

Tolerance: ``train_tol``'s loss rtol.
"""
import shutil
from pathlib import Path

import numpy as np

from repro_torch.configs import get_smoke
from test_torch_lm_mesh_common import (
    mesh_of,
    wait_for,
    start_jax,
    start_world,
)
from test_torch_lm_train_tol import train_tol

ARCH = "qwen3_moe_235b"
DATA = dict(seed=0, batch=4, seq_len=64)
OPT = dict(lr=1e-2, warmup_steps=1, total_steps=3, m_dtype="bfloat16",
           v_mode="factored")


def _manifest(directory, step):
    return Path(directory) / f"ckpt_{step:08d}.json"


def _first(rank, world, spec):
    """The port's 2-step run on 2 x 2 from the reference's step 0."""
    import torch.distributed as dist

    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.runtime.train_loop import train

    mesh = mesh_of(2, 2)
    wait_for(spec["ckpt0"])  # the reference's start, once written
    dist.barrier()
    res = train(get_smoke(ARCH), 2, DataConfig(**DATA), OptConfig(**OPT),
                ckpt_dir=spec["port_dir"], ckpt_every=1, mesh=mesh)
    return {"losses": res.losses, "restored": res.restored_from}


def _resume(rank, world, spec):
    """3 ranks re-planned to (2, 1): restore the reference's step 2, check
    it whole, train step 3."""
    import torch.distributed as dist

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.interop import lm_params_to_numpy, opt_state_to_numpy
    from repro_torch.models import init_params
    from repro_torch.optim.adamw import OptConfig, init_opt_state, state_specs_for
    from repro_torch.runtime.elastic import build_mesh, plan_mesh
    from repro_torch.runtime.train_loop import train
    from repro_torch.sharding.partition import param_specs, to_shardings

    if rank == 0:
        wait_for(spec["ref_ckpt2"])
        shutil.copytree(spec["ref_dir"], spec["resume_dir"])
    dist.barrier()
    plan = plan_mesh(world, want_tp=2, global_batch=DATA["batch"])
    mesh = build_mesh(plan, "cpu")
    if mesh is None:
        return None
    cfg, ocfg = get_smoke(ARCH), OptConfig(**OPT)
    shapes = init_params(cfg, device="meta")
    ostate = init_opt_state(shapes, ocfg, device="meta")
    pspecs = param_specs(cfg, shapes)
    back = CheckpointManager(spec["resume_dir"]).restore(
        2, {"params": shapes, "opt": ostate},
        shardings={"params": to_shardings(mesh, pspecs),
                   "opt": to_shardings(mesh, state_specs_for(ostate,
                                                             pspecs))})
    whole = {"params": lm_params_to_numpy(back["params"]),
             "opt": opt_state_to_numpy(back["opt"], back["params"])}
    res = train(cfg, 3, DataConfig(**DATA), ocfg,
                ckpt_dir=spec["resume_dir"], ckpt_every=1, mesh=mesh)
    return {"plan": plan, "losses": res.losses, "restored": res.restored_from,
            "whole": whole, "local_shapes": {
                n: tuple(p.shape) for n, p in back["params"].named_parameters()
                if n.endswith("moe.wi")}}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_train_with_a_mesh_follows_the_reference_and_resumes_elsewhere(
        tmp_path):
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    tasks = [
        {"kind": "ckpt0", "key": "ckpt0/", "arch": ARCH, "mesh": (1, 1),
         "ckpt_dir": str(port_dir), "opt": OPT},
        {"kind": "train", "key": "first/", "arch": ARCH, "mesh": (2, 2),
         "steps": 2, "data": DATA, "opt": OPT, "ckpt_dir": str(ref_dir),
         "ckpt_every": 1},
        {"kind": "train", "key": "ported/", "arch": ARCH, "mesh": (2, 1),
         "steps": 3, "data": DATA, "opt": OPT, "ckpt_every": 1,
         "ckpt_dir": str(tmp_path / "ref-from-port"),
         "copy_from": str(port_dir), "copy_step": 2},
    ]
    wait_jax = start_jax(tmp_path, "loop", tasks)
    wait_first = start_world(tmp_path, "first", 4, _first,
                             ckpt0=str(_manifest(port_dir, 0)),
                             port_dir=str(port_dir))
    wait_resumed = start_world(tmp_path, "resume", 3, _resume,
                               ref_dir=str(ref_dir),
                               ref_ckpt2=str(_manifest(ref_dir, 2)),
                               resume_dir=str(tmp_path / "port-resume"))
    first, resumed, want = wait_first(), wait_resumed(), wait_jax()
    rtol = train_tol(get_smoke(ARCH))[0]

    assert first["restored"] == 0
    np.testing.assert_allclose(first["losses"], want["first/losses"],
                               rtol=rtol)
    plan = resumed["plan"]
    assert (plan.mesh_shape, plan.dropped_devices) == ((2, 1), 1)
    assert resumed["restored"] == 2 and len(resumed["losses"]) == 1
    assert int(want["ported/restored"]) == 2
    np.testing.assert_allclose(resumed["losses"], want["ported/losses"],
                               rtol=rtol)
    # the restore onto (2, 1): every leaf whole again, bit for bit
    with np.load(ref_dir / "ckpt_00000002.npz") as z:
        file = {k: z[k] for k in z.files}
    got = _flat(resumed["whole"])
    assert set(got) == set(file)
    for key, arr in file.items():
        assert np.array_equal(np.ravel(got[key]).view(np.uint8),
                              np.ravel(arr).view(np.uint8)), key
    # the experts (E = 8) lie over "model" (tp 1: whole) and no data block
    assert set(resumed["local_shapes"].values()) == {(8, 64, 96)}
