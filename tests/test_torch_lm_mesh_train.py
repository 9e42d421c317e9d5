"""The sharded training step against the reference's on the CPU, at
(dp, tp) = (2, 2) (here) and (1, 4) (``test_torch_lm_mesh_train14.py``):
``train_loss`` with ``shd`` and every gradient leaf (the router's named)
against ``jax.value_and_grad(train_loss(..., shd))`` under ``jax.jit`` on
the same mesh of a forced 4-device platform, and one sharded AdamW step
(bf16 ``m``, factored ``v``) applied to the reference's own gradients
against the reference's ``apply_updates`` on them: the parameters, ``m``,
``v`` and the global norm.

The port's parameters are placed with FSDP over "data" (``add_fsdp``,
size dp): at (2, 2) ``qwen25``'s ``attn/bq``, ``bk``, ``bv`` and
``mamba2``'s conv biases and ``norm`` have their unit stack on "data",
so each unit's leaf lives on one data rank. Configs: internlm2, qwen25,
qwen3-moe (its expert-parallel gate on), mamba2 at both meshes; jamba
at (2, 2) without the optimizer step (``test_torch_lm_mesh_jamba.py``).
B = 4 x 64 of the synthetic stream. Every model-sharded smoke dim divides
by 4, so no config is skipped at (1, 4) for its dims; jamba is left out
there because its reference compile alone takes ~23 s a mesh (its MoE
layer runs at (1, 4) in ``test_torch_lm_mesh_moe.py``). Tolerances:
``train_tol``; the optimizer on equal gradients: parameters and ``v``
rtol 1e-5, ``m`` (bf16) 2^-7.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.data.pipeline import DataConfig, batch_for
from test_torch_lm_mesh_common import (
    close,
    mesh_of,
    reference_file,
    start_jax,
    start_world,
    weights_tree,
)
from test_torch_lm_train_tol import train_tol

ARCHS = ("internlm2_1_8b", "qwen25_14b", "qwen3_moe_235b", "mamba2_1_3b")
B, S = 4, 64
OPT = dict(lr=1e-2, warmup_steps=1, m_dtype="bfloat16", v_mode="factored")


def batch_np(cfg):
    b = batch_for(cfg, DataConfig(seed=0, batch=B, seq_len=S), 0,
                  device="cpu")
    return {k: v.numpy() for k, v in b.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _ref_leaf(flat, name):
    """The reference's whole per-unit leaf of a port parameter name."""
    parts = name.split(".")
    if parts[0] == "units":
        return flat["/".join(["units"] + parts[2:])][int(parts[1])]
    return flat["/".join(parts)]


def _world(rank, world, spec):
    from repro_torch.interop import (
        lm_params_to_numpy,
        lm_shards_from_numpy,
        opt_state_to_numpy,
    )
    from repro_torch.models.layers import ShardingCtx
    from repro_torch.optim.adamw import OptConfig, apply_updates, init_opt_state
    from repro_torch.runtime.train_loop import value_and_grad
    from repro_torch.sharding.partition import (
        add_fsdp,
        gather_param,
        param_specs,
        place_like,
    )

    dp, tp = spec["mesh"]
    mesh = mesh_of(dp, tp)
    shd = ShardingCtx(dp=("data",), tp="model", mesh=mesh)
    out, models = {}, {}
    for arch in spec["archs"]:
        cfg = get_smoke(arch)
        tree = weights_tree(spec["dir"], arch)
        from repro_torch.models import init_params

        shapes = init_params(cfg, device="meta")
        specs = add_fsdp(param_specs(cfg, shapes), shapes, size=dp)
        model = lm_shards_from_numpy(cfg, tree, mesh, specs)
        batch = {k: torch.from_numpy(v) for k, v in batch_np(cfg).items()}
        loss, grads = value_and_grad(cfg, model, batch, shd)
        res = {"loss": float(loss)}
        res["g"] = {n: gather_param(model, n, g).numpy()
                    for n, g in grads.items()}
        res["unit_leaves"] = sorted(p for p, s in specs.items() if s.unit)
        models[arch] = model
        out[arch] = res
    if not spec["adam"]:
        return out
    # one AdamW step on the reference's gradients, once it has them
    want = reference_file(f"{spec['dir']}/jax-train.npz")
    for arch in spec["archs"]:
        res = out[arch]
        model = models[arch]
        ref_g = {k[len(arch) + 3:]: v for k, v in want.items()
                 if k.startswith(f"{arch}/g/")}
        ocfg = OptConfig(**OPT)
        state = init_opt_state(model, ocfg)
        g_ref = {n: place_like(model, n, torch.from_numpy(
            _ref_leaf(ref_g, n))) for n, _ in model.named_parameters()}
        stats = apply_updates(model, g_ref, state, ocfg)
        res["gnorm"] = float(stats["gnorm"])
        res["p"] = _flat(lm_params_to_numpy(model))
        res["s"] = _flat(opt_state_to_numpy(state, model))
    return out


def check_step(tmp_path, mesh, archs=ARCHS, adam=True):
    """Both runs at once, then every comparison."""
    tasks = [{"kind": "loss", "key": f"{arch}/", "arch": arch, "mesh": mesh,
              "batch": batch_np(get_smoke(arch)),
              "opt": OPT if adam else None} for arch in archs]
    wait_jax = start_jax(tmp_path, "train", tasks)
    wait_port = start_world(tmp_path, "train", mesh[0] * mesh[1], _world,
                            mesh=mesh, archs=archs, adam=adam)
    want = wait_jax()
    port = wait_port()
    for arch in archs:
        cfg = get_smoke(arch)
        loss_rtol, g_rtol, g_share = train_tol(cfg)
        r = {k[len(arch) + 1:]: v for k, v in want.items()
             if k.startswith(arch + "/")}
        got = port[arch]
        np.testing.assert_allclose(got["loss"], float(r["loss"]),
                                   rtol=loss_rtol, err_msg=arch)
        assert any(n.endswith("moe.router") for n in got["g"]) == cfg.has(
            "moe")
        ref_g = {k[2:]: v for k, v in r.items() if k.startswith("g/")}
        for name, g in got["g"].items():
            close(g, _ref_leaf(ref_g, name), g_rtol, g_share,
                  f"{arch} gradient {name}")
        if not adam:
            continue
        np.testing.assert_allclose(got["gnorm"], float(r["gnorm"]), rtol=1e-5)
        before = reference_file(tmp_path / f"w-{arch}.npz")
        for path, want_p in ((k[2:], v) for k, v in r.items()
                             if k.startswith("p/")):
            moved = float(np.abs(want_p - before[path]).max())
            np.testing.assert_allclose(got["p"][path], want_p, rtol=1e-5,
                                       atol=1e-5 * moved,
                                       err_msg=f"{arch} param {path}")
        for path, want_s in ((k[2:], v) for k, v in r.items()
                             if k.startswith("s/")):
            g = got["s"][path]
            if g.dtype.kind == "V":  # bf16 m: compare its f32 values
                close(_bf16(g), _bf16(want_s), 2.0 ** -7, 2.0 ** -8,
                      f"{arch} {path}")
            else:
                close(g, want_s, 1e-5, 1e-6, f"{arch} {path}")
    return port


def _bf16(a):
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def test_sharded_loss_gradients_and_adamw_match_reference_at_2x2(tmp_path):
    port = check_step(tmp_path, (2, 2))
    units = {arch: port[arch]["unit_leaves"] for arch in ARCHS}
    assert units["qwen25_14b"] == ["units/l0/attn/bk", "units/l0/attn/bq",
                                   "units/l0/attn/bv"]
    assert {"units/l0/mamba/conv_bx", "units/l0/mamba/norm"} <= set(
        units["mamba2_1_3b"])


@pytest.mark.parametrize("arch", ARCHS + ("jamba15_large_398b",))
def test_every_model_sharded_smoke_dim_divides_by_4(arch):
    """So (1, 4) skips no config."""
    from repro_torch.models import init_params
    from repro_torch.sharding.partition import leaf_shapes, param_specs, stacked

    cfg = get_smoke(arch)
    shapes = init_params(cfg, device="meta")
    for path, shape in leaf_shapes(shapes).items():
        spec = stacked(path, param_specs(cfg, shapes)[path])
        for n, a in zip(shape, spec):
            assert a != "model" or n % 4 == 0, (path, shape, spec)
