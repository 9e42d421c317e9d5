"""Prefill followed by decode on the tensor-parallel mesh against the
reference's mesh path, on the CPU, at (dp, tp) = (1, 4): the model axis
over every rank, so each rank holds a quarter of every KV head's columns,
of the FFN and of the vocabulary, and the cache's sequence in quarters.
``prefill`` and 4 ``decode_step``s of ``launch.steps.build_step``'s cells
against the reference's ``prefill`` / ``decode_step`` under ``jax.jit`` on
the same mesh of a forced 4-device platform (the harness of
``test_torch_lm_mesh_common.py``): every logit, then the whole cache.

Configs: internlm2 (2 KV heads over 4 ranks: each rank's heads read
columns of another's block), qwen2.5 (q / k / v biases exchanged with
their columns) and mamba2 (the SSD heads, B / C all-gathered, the gated
norm over the whole d_inner), B = 4 prompts of 64 tokens. Tolerances:
rtol 1e-4, atol 1e-5 of each array's largest magnitude (Mamba 1e-4), the
serving tests' own (``test_torch_lm_mesh_serve.py``).
"""
import numpy as np
import torch

from repro_torch.configs import get_smoke
from test_torch_lm_mesh_common import (
    close,
    mesh_of,
    start_jax,
    start_world,
    weights_tree,
)
from test_torch_lm_mesh_serve import STEPS, inputs

ARCHS = ("internlm2_1_8b", "qwen25_14b", "mamba2_1_3b")
MESH = (1, 4)


def _world(rank, world, spec):
    from repro_torch.interop import lm_shards_from_numpy
    from repro_torch.launch.steps import build_step
    from repro_torch.sharding.comm import gather_whole

    mesh = mesh_of(*MESH)
    out = {}
    for arch in ARCHS:
        cfg = get_smoke(arch)
        pre = build_step(cfg, "prefill_32k", mesh)
        dec = build_step(cfg, "decode_32k", mesh)
        model = lm_shards_from_numpy(cfg, weights_tree(spec["dir"], arch),
                                     mesh, pre.param_specs)
        batch, decode = inputs(cfg)
        logits, cache, pos = pre.fn(
            model, {k: torch.from_numpy(v) for k, v in batch.items()})
        res = {"prefill": logits.numpy()}
        for i, tok in enumerate(decode):
            logits, cache, pos = dec.fn(model, torch.from_numpy(tok), cache,
                                        pos)
            res[f"decode{i}"] = logits.numpy()
        for u, unit in enumerate(cache):
            for ln, entry in unit.items():
                for nm, t in entry.items():
                    res[f"cache/{ln}/{nm}/{u}"] = gather_whole(
                        mesh, t, cache.specs[ln][nm]).float().numpy()
        res["specs"] = cache.specs
        out[arch] = res
    return out


def test_tensor_parallel_prefill_and_decode_match_reference_at_1x4(
        tmp_path):
    tasks = []
    for arch in ARCHS:
        batch, decode = inputs(get_smoke(arch))
        tasks.append({"kind": "serve", "key": f"{arch}/", "arch": arch,
                      "mesh": MESH, "batch": batch, "decode": decode})
    wait_jax = start_jax(tmp_path, "serve", tasks)
    wait_port = start_world(tmp_path, "serve", 4, _world)
    want = wait_jax()
    port = wait_port()
    for arch in ARCHS:
        cfg = get_smoke(arch)
        share = 1e-4 if cfg.has("mamba") else 1e-5
        got = port[arch]
        for name in ["prefill"] + [f"decode{i}" for i in range(STEPS)]:
            close(got[name], want[f"{arch}/{name}"], 1e-4, share,
                  f"{arch} {name}")
        n_cache = 0
        for key, w in want.items():
            if not key.startswith(f"{arch}/cache/"):
                continue
            ln, nm = key.split("/")[2:4]
            for u in range(w.shape[0]):
                close(got[f"cache/{ln}/{nm}/{u}"], w[u], 1e-4, share,
                      f"{arch} {key} unit {u}")
                n_cache += 1
        assert n_cache == cfg.n_units * sum(
            len(e) for e in got["specs"].values())
        for ln, entry in got["specs"].items():
            for nm, spec in entry.items():
                if nm in ("k", "v"):  # (B, S + 64, K, dh): 128 over 4
                    assert spec[1] == "model"
                elif nm == "ssm":  # (B, H, N, P): 8 heads over 4
                    assert spec[1] == "model"
