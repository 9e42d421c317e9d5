"""The expert-parallel MoE against the reference's, on the CPU: the port's
sharded ``apply_moe`` (``_apply_moe_ep``: two ``all_to_all_single``s over
the model group) in a gloo world of 4 ranks, and its one-process twin
``apply_moe_ep_plain``, against the reference's ``apply_moe`` under
``jax.jit`` on the same (dp, tp) mesh of a forced 4-device platform: the
output, the gradient of ``sum(y * r)`` against the input and every
weight (the router's, summed over "model" and "data"). The reference's
EP path is a different function from its global view (capacity per
(data, model) block, truncated by ``int``), so the sharded MoE is held
against the reference's own EP path, never against one device.

Covered: (dp, tp) in {(1, 2), (2, 2), (1, 4), (4, 1)}, every MoE smoke
config (qwen3-moe, arctic, jamba's second layer; jamba's whole model at
(2, 2) is ``test_torch_lm_mesh_jamba.py``'s), the gate off (S = 40 is
no multiple of 16 tp; decode, S = 1, with the batch split over "data" and
not), and a capacity factor where ``int`` and ``ceil`` give different
capacities. Tolerances: ``train_tol``.
"""
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_smoke
from repro_torch.models import layers as L
from test_torch_lm_mesh_common import (
    close,
    mesh_of,
    start_jax,
    start_world,
    weights_tree,
)
from test_torch_lm_train_tol import train_tol

MOE_LAYER = {"qwen3_moe_235b": "l0", "arctic_480b": "l0",
             "jamba15_large_398b": "l1"}
# (key, arch, (dp, tp), B, S, cfg overrides)
CASES = [
    ("q22", "qwen3_moe_235b", (2, 2), 4, 64, {}),
    ("q12", "qwen3_moe_235b", (1, 2), 2, 32, {}),
    ("q14", "qwen3_moe_235b", (1, 4), 2, 64, {}),
    ("q41", "qwen3_moe_235b", (4, 1), 4, 16, {}),
    ("a22", "arctic_480b", (2, 2), 2, 64, {}),
    ("j14", "jamba15_large_398b", (1, 4), 2, 64, {}),
    ("off", "qwen3_moe_235b", (2, 2), 4, 40, {}),      # S % (16 tp) != 0
    ("dec", "qwen3_moe_235b", (2, 2), 4, 1, {}),       # decode, batch split
    ("dec3", "qwen3_moe_235b", (2, 2), 3, 1, {}),      # decode, batch whole
    ("cap", "qwen3_moe_235b", (2, 2), 2, 64, {"capacity_factor": 1.1}),
]


def _seed(key):
    return [c[0] for c in CASES].index(key)


def _cfg(arch, over):
    return dataclasses.replace(get_smoke(arch), **over)


def _inputs(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    r = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return x, r


def _moe_module(arch, tree):
    """The port's MoE of ``MOE_LAYER[arch]`` in unit 0, whole, on the CPU."""
    from repro_torch.interop import leaf_tensor

    cfg = get_smoke(arch)
    moe = L.MoE(cfg, device="cpu")
    with torch.no_grad():
        for nm, p in moe.named_parameters():
            p.copy_(leaf_tensor(tree["units"][MOE_LAYER[arch]]["moe"][nm][0],
                                "cpu"))
    return moe


def _world(rank, world, spec):
    """Every case on its mesh: the sharded apply_moe on the rank's batch
    block, then y, the input's gradient and each weight's, whole."""
    from repro_torch.sharding import comm
    from repro_torch.sharding.partition import (
        Gathered,
        Spec,
        gather_param,
        place_params,
    )

    meshes = {}
    out = {}
    for key, arch, (dp, tp), B, S, over in CASES:
        if (dp, tp) not in meshes:
            meshes[dp, tp] = mesh_of(dp, tp)
        mesh = meshes[dp, tp]
        if mesh is None:
            continue
        cfg = _cfg(arch, over)
        moe = _moe_module(arch, weights_tree(spec["dir"], arch))
        experts = Spec(("model", None, None))
        place_params(moe, mesh, {"router": Spec((None, None)), "wi": experts,
                                 "wg": experts, "wo": experts})
        moe.requires_grad_()
        x, r = _inputs(cfg, B, S, _seed(key))
        split = B % dp == 0
        d = mesh.coords["data"]
        rows = slice(d * B // dp, (d + 1) * B // dp) if split else slice(None)
        xr = torch.from_numpy(x[rows]).requires_grad_()
        shd = L.ShardingCtx(dp=("data",), tp="model", mesh=mesh, split=split)
        y = L.apply_moe(cfg, Gathered(moe, mesh), xr, shd)
        names, ps = zip(*moe.named_parameters())
        # a batch whole on every data rank counts 1 / dp on each (as the
        # loss's mean over "data" does), its input's gradient summed
        share = 1 if split else dp
        grads = torch.autograd.grad(
            (y * torch.from_numpy(r[rows])).sum() / share, ps + (xr,))
        if split:
            res = {"y": comm.all_gather(mesh, "data", y.detach(), 0),
                   "gx": comm.all_gather(mesh, "data", grads[-1], 0)}
        else:
            res = {"y": y.detach(),
                   "gx": comm.all_reduce(mesh, "data", grads[-1])}
        for nm, g in zip(names, grads):
            res["g/" + nm] = gather_param(moe, nm, g)
        out[key] = {k: v.numpy() for k, v in res.items()}
    return out


def test_sharded_and_plain_expert_parallel_moe_match_reference(tmp_path):
    tasks = []
    for key, arch, mesh, B, S, over in CASES:
        x, r = _inputs(_cfg(arch, over), B, S, _seed(key))
        tasks.append({"kind": "moe", "key": key + "/", "arch": arch,
                      "cfg": over, "mesh": mesh, "layer": MOE_LAYER[arch],
                      "unit": 0, "x": x, "r": r})
    wait_jax = start_jax(tmp_path, "moe", tasks)
    wait_port = start_world(tmp_path, "moe", 4, _world)
    want = wait_jax()
    port = wait_port()
    for key, arch, (dp, tp), B, S, over in CASES:
        cfg = _cfg(arch, over)
        _, g_rtol, g_share = train_tol(cfg)
        ref = {k[len(key) + 1:]: v for k, v in want.items()
               if k.startswith(key + "/")}
        got = port[key]
        close(got["y"], ref["y"], 1e-5, 1e-6, f"{key} y")
        for name in ("gx", "g/router", "g/wi", "g/wg", "g/wo"):
            close(got[name], ref[name], g_rtol, g_share, f"{key} {name}")
        # the plain twin, one process, on the same weights
        moe = _moe_module(arch, weights_tree(tmp_path, arch))
        x, _ = _inputs(cfg, B, S, _seed(key))
        with torch.no_grad():
            xt = torch.from_numpy(x)
            plain = (L.apply_moe_ep_plain(cfg, moe, xt, dp, tp)
                     if L.ep_gate(cfg, B, S, dp, tp) else
                     L.apply_moe(cfg, moe, xt))
        close(plain.numpy(), ref["y"], 1e-5, 1e-6, f"{key} plain")


def test_the_cases_cover_the_gate_and_the_truncated_capacity():
    """The gate is on for the EP cases and off for the others; the "cap"
    case's block capacity truncates to 8 where rounding up gives 16, and
    that changes the output (tokens drop)."""
    gate = {key: L.ep_gate(_cfg(arch, over), B, S, *mesh)
            for key, arch, mesh, B, S, over in CASES}
    assert not (gate["off"] or gate["dec"] or gate["dec3"])
    assert all(v for k, v in gate.items() if k not in ("off", "dec", "dec3"))
    cfg = _cfg("qwen3_moe_235b", {"capacity_factor": 1.1})
    t_loc = (2 // 2) * (64 // 2)
    assert L.ep_capacity(cfg, t_loc) == 8
    assert L.moe_capacity(dataclasses.replace(cfg, n_experts=8), t_loc) == 16
    gen = torch.Generator().manual_seed(0)
    moe = L.init_moe(cfg, torch.Generator().manual_seed(1))
    x = torch.randn(t_loc, cfg.d_model, generator=gen)
    with torch.no_grad():
        cut = L._moe_dispatch_compute(cfg, moe.router, x, 8,
                                      lambda b: L._expert_ffn(moe, b))
        up = L._moe_dispatch_compute(cfg, moe.router, x, 16,
                                     lambda b: L._expert_ffn(moe, b))
    assert not torch.allclose(cut, up)
