"""The LM substrate's tensor- and sequence-parallel compute on a mesh
against one process, on the CPU, in a gloo world of 4 ranks (the harness
of ``test_torch_lm_mesh_common.py``):

  * **uneven heads**: a smoke config with 6 q heads and 2 KV heads over
    tp = 4 at (1, 4): a wq block of 1.5 heads, so ranks compute 2, 1, 2
    and 1 heads and the cut halves move (``layers.head_plan``). The loss
    and every gradient against one process's step; prefill and 4 decode
    steps against one process's; ``mesh.stats["moved"]`` holds exactly
    the columns the plan moves (the cut half-heads of wq / wo, the K / V
    columns each rank's heads read) and nothing else moves a unit's
    weight over "model" (``comm.gather_param`` never joins a block over
    it);
  * **the Mamba2 gated norm** over tp = 2 at (2, 2): ``apply_mamba_tp``
    (its sum of squares all-reduced over "model") against
    ``apply_mamba``, the output and the gradients of the input and of
    every weight;
  * **decode over sequence-sharded caches** at (2, 2), internlm2 (the
    batch over "data", each rank's slots of every KV head), jamba (Mamba
    states on their blocks, attention and MoE layers) and llama-vision
    (the cross-attention cache whole, 17 slots): every logit of prefill
    and 4 decode steps against one process's (its MoE layers the plain
    expert-parallel twin's where the gate is on), each K / V block its
    slice of one process's cache, and a decode step's all-gathers below
    the rank's own blocks of the cache (gather-on-use moved them all, a
    step) with no weight moved.

Tolerances: ``train_tol`` for the training step, the serving tests' rtol
1e-4 and atol 1e-5 of the largest magnitude (Mamba 1e-4).
"""
import contextlib
import copy
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke
from test_torch_lm_mesh_common import close, mesh_of, start_world
from test_torch_lm_train_tol import train_tol

B, S, STEPS = 4, 64, 4
UNEVEN = dict(n_heads=6, n_kv=2, d_head=16)  # wq (64, 96) over 4: 1.5 heads


def uneven_cfg():
    return dataclasses.replace(get_smoke("internlm2_1_8b"), **UNEVEN)


def _batch(cfg, seed):
    from repro_torch.data.pipeline import DataConfig, batch_for

    return batch_for(cfg, DataConfig(seed=seed, batch=B, seq_len=S), 0,
                     device="cpu")


def _prompts(cfg, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))}
    if cfg.n_vision_tokens:
        batch["vision"] = torch.from_numpy((0.02 * rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_model))).astype(np.float32))
    decode = [torch.from_numpy(rng.integers(0, cfg.vocab, (B, 1)).astype(
        np.int32)) for _ in range(STEPS)]
    return batch, decode


@contextlib.contextmanager
def plain_moe(dp: int, tp: int):
    """One process's MoE layers as the (dp, tp) mesh runs them: the plain
    expert-parallel twin where the reference's gate is on."""
    from repro_torch.models import layers as L

    saved = L.apply_moe

    def plain(cfg, p, x, shd=None):
        if shd is None and L.ep_gate(cfg, x.shape[0], x.shape[1], dp, tp):
            return L.apply_moe_ep_plain(cfg, p, x, dp, tp)
        return saved(cfg, p, x, shd)

    L.apply_moe = plain
    try:
        yield
    finally:
        L.apply_moe = saved


def _serve(cfg, whole, model, shd, seed):
    """Prefill and the decode steps on the mesh and in one process:
    ``(pairs, cache, one-process cache, decode stats)``, pairs of (name,
    mesh logits, one-process logits)."""
    from repro_torch.models import decode_step, prefill

    batch, decode = _prompts(cfg, seed)
    lg, cache, pos = prefill(cfg, model, batch, shd)
    with plain_moe(shd.dp_size, shd.tp_size):
        lw, cw, pw = prefill(cfg, whole, batch)
    pairs = [("prefill", lg, lw)]
    stats = None
    for i, tok in enumerate(decode):
        shd.mesh.stats = {} if i == 0 else None
        lg, cache, pos = decode_step(cfg, model, tok, cache, pos, shd)
        stats = stats or shd.mesh.stats
        lw, cw, pw = decode_step(cfg, whole, tok, cw, pw)
        pairs.append((f"decode{i}", lg, lw))
    shd.mesh.stats = None
    return pairs, cache, cw, stats


def _expected_moves(cfg, tp, rank):
    """The bytes of each weight's columns ``head_plan`` brings to ``rank``
    a unit (f32)."""
    from repro_torch.models.layers import head_plan
    from repro_torch.sharding.comm import exchange_plan

    plan = head_plan(cfg.n_heads, cfg.n_kv, cfg.d_head, tp)
    D = cfg.d_model
    q_block = cfg.n_heads * cfg.d_head // tp
    kv_block = cfg.n_kv * cfg.d_head // tp
    q_in = sum(exchange_plan(tp, rank, q_block, plan.q_need)[2])
    kv_in = sum(exchange_plan(tp, rank, kv_block, plan.kv_need)[2])
    return {"wq": 4 * D * q_in, "wo": 4 * D * q_in, "wk": 4 * D * kv_in,
            "wv": 4 * D * kv_in}


def _uneven(rank, shd, out):
    from repro_torch.models import init_params
    from repro_torch.models.layers import head_plan
    from repro_torch.runtime.train_loop import value_and_grad
    from repro_torch.sharding import comm
    from repro_torch.sharding.partition import (
        gather_param,
        param_specs,
        place_params,
    )

    mesh = shd.mesh
    cfg = uneven_cfg()
    plan = head_plan(cfg.n_heads, cfg.n_kv, cfg.d_head, 4)
    whole = init_params(cfg, seed=2, device="cpu")
    model = place_params(copy.deepcopy(whole), mesh,
                         param_specs(cfg, whole))
    joined = []
    gather = comm.gather_param

    def watch(mesh_, x, dims, owner, shape):
        joined.append("model" in dims)
        return gather(mesh_, x, dims, owner, shape)

    comm.gather_param = watch
    try:
        mesh.stats = {}
        loss, grads = value_and_grad(cfg, model, _batch(cfg, 3), shd)
        moved, mesh.stats = mesh.stats.get("moved", {}), None
    finally:
        comm.gather_param = gather
    want_l, want_g = value_and_grad(cfg, copy.deepcopy(whole),
                                    _batch(cfg, 3))
    res = {"loss": (float(loss), float(want_l)),
           "grads": {n: (gather_param(model, n, g).numpy(),
                         want_g[n].numpy()) for n, g in grads.items()},
           "heads": plan.heads[rank], "moved": moved,
           # each unit's forward, then its recompute under remat
           "moved_want": {k: v * cfg.n_units * 2 for k, v in
                          _expected_moves(cfg, 4, rank).items()},
           "joined_model": any(joined)}
    model.requires_grad_(False)
    pairs, _, _, _ = _serve(cfg, whole, model, shd, 4)
    res["serve"] = [(n, a.numpy(), b.numpy()) for n, a, b in pairs]
    out["uneven"] = res


def _mamba_norm(rank, shd, out):
    """apply_mamba_tp over tp = 2 against apply_mamba: output and
    gradients (input, every weight)."""
    from repro_torch.models import layers as L
    from repro_torch.sharding.partition import (
        Gathered,
        Spec,
        gather_param,
        place_params,
    )
    from repro_torch.sharding.partition import _unit_rule

    mesh = shd.mesh
    cfg = get_smoke("mamba2_1_3b")
    gen = torch.Generator().manual_seed(6)
    whole = L.init_mamba(cfg, gen)
    with torch.no_grad():  # a norm scale and biases away from 1 and 0
        for nm in ("norm", "conv_bx", "conv_bb", "dt_bias"):
            getattr(whole, nm).add_(0.1 * torch.randn(
                getattr(whole, nm).shape, generator=gen))
    specs = {nm: Spec(_unit_rule(("mamba", nm), p.dim() + 1)[1:])
             for nm, p in whole.named_parameters()}
    placed = place_params(copy.deepcopy(whole), mesh, specs)
    placed.requires_grad_()
    whole.requires_grad_()
    u = torch.randn(B // 2, S, cfg.d_model, generator=gen)
    r = torch.randn(B // 2, S, cfg.d_model, generator=gen)
    d = mesh.coords["data"]
    ur = u.clone().requires_grad_()
    y_part, _ = L.apply_mamba_tp(cfg, Gathered(placed, mesh),
                                 L.enter(shd, ur, False), shd)
    y = L.leave(shd, y_part, False)
    names, ps = zip(*placed.named_parameters())
    # each data rank's loss on its own copy of the block: the gradients
    # summed over "data" are twice one's
    got = torch.autograd.grad((y * r).sum(), ps + (ur,))
    uw = u.clone().requires_grad_()
    yw = L.apply_mamba(cfg, whole, uw)
    want = torch.autograd.grad((yw * r).sum(), tuple(
        whole.parameters()) + (uw,))
    res = {"y": (y.detach().numpy(), yw.detach().numpy()),
           "gu": (got[-1].numpy(), want[-1].numpy())}
    for nm, g, w in zip(names, got, want):
        res["g/" + nm] = (gather_param(placed, nm, g).numpy() / 2,
                          w.numpy())
    out[f"mamba_d{d}"] = res


def _decode(rank, shd, out):
    from repro_torch.models import init_params
    from repro_torch.sharding.partition import param_specs, place_params

    mesh = shd.mesh
    res = {}
    for arch in ("internlm2_1_8b", "jamba15_large_398b",
                 "llama32_vision_90b"):
        cfg = get_smoke(arch)
        whole = init_params(cfg, seed=5, device="cpu")
        model = place_params(copy.deepcopy(whole), mesh,
                             param_specs(cfg, whole))
        pairs, cache, cw, stats = _serve(cfg, whole, model, shd, 8)
        d, m = mesh.coords["data"], mesh.coords["model"]
        blocks = []
        held = 0  # the bytes of every cache block this rank holds
        for u, unit in enumerate(cache):
            for ln, entry in unit.items():
                for nm, t in entry.items():
                    held += t.numel() * t.element_size()
                    if nm in ("k", "v"):
                        n = t.shape[1]
                        want = cw[u][ln][nm][2 * d:2 * d + 2,
                                             m * n:(m + 1) * n]
                        blocks.append((f"{u}/{ln}/{nm}", t.shape,
                                       t.float().numpy(),
                                       want.float().numpy()))
        res[arch] = {"serve": [(n, a.numpy(), b.numpy())
                               for n, a, b in pairs],
                     "blocks": blocks, "held": held,
                     "all_gather": stats["by_kind"]["all-gather"],
                     "moved": stats.get("moved", {})}
    out[f"decode_r{rank}"] = res


def _world(rank, world, spec):
    from repro_torch.models.layers import ShardingCtx

    torch.manual_seed(0)
    out = {}
    for shape, fns in (((1, 4), (_uneven,)), ((2, 2), (_mamba_norm,
                                                        _decode))):
        mesh = mesh_of(*shape)
        shd = ShardingCtx(dp=("data",), tp="model", mesh=mesh)
        for fn in fns:
            fn(rank, shd, out)
    every = [None] * world
    dist.all_gather_object(every, out)
    return every


def test_tensor_parallel_mesh_matches_one_process(tmp_path):
    every = start_world(tmp_path, "tp", 4, _world)()
    cfg = uneven_cfg()
    loss_rtol, g_rtol, g_share = train_tol(cfg)
    # uneven heads: the loss, every gradient, the serving path
    assert [every[r]["uneven"]["heads"] for r in range(4)] == [
        (0, 1), (2,), (3, 4), (5,)]
    for rank in range(4):
        res = every[rank]["uneven"]
        got, want = res["loss"]
        np.testing.assert_allclose(got, want, rtol=loss_rtol)
        for name, (g, w) in res["grads"].items():
            close(g, w, g_rtol, g_share, f"uneven gradient {name}")
        for name, a, b in res["serve"]:
            close(a, b, 1e-4, 1e-5, f"uneven {name}")
        assert not res["joined_model"]
        assert res["moved"] == res["moved_want"], (rank, res["moved"])
    # ranks 0 and 2 take half a head of wq's columns and wo's rows
    assert every[0]["uneven"]["moved"]["wq"] > 0
    assert every[1]["uneven"]["moved"]["wq"] == 0
    # the Mamba2 gated norm over two model ranks, on both data rows
    mcfg = get_smoke("mamba2_1_3b")
    _, g_rtol, g_share = train_tol(mcfg)
    for d in range(2):
        res = every[2 * d]["mamba_d" + str(d)]
        for key, (a, b) in res.items():
            close(a, b, g_rtol, g_share, f"mamba {key}")
    # decode over the sequence-sharded caches
    for rank in range(4):
        res = every[rank][f"decode_r{rank}"]
        for arch, r in res.items():
            share = 1e-4 if get_smoke(arch).has("mamba") else 1e-5
            for name, a, b in r["serve"]:
                close(a, b, 1e-4, share, f"{arch} {name}")
            for key, shape, a, b in r["blocks"]:
                assert shape[0] == B // 2 and shape[1] == (S + 64) // 2
                close(a, b, 1e-4, share, f"{arch} cache {key}")
            # gather-on-use moved every block of the cache each step
            assert 0 < r["all_gather"] < r["held"], (arch, r["all_gather"])
            assert not r["moved"]
