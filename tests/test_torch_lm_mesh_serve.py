"""The sharded serving path against the reference's on the CPU, at (dp, tp)
= (2, 2): ``prefill`` and 4 ``decode_step``s with ``shd`` (the steps of
``launch.steps.build_step``'s prefill and decode cells) against the
reference's ``prefill`` / ``decode_step`` under ``jax.jit`` on the same
mesh of a forced 4-device platform: every logit, then the whole cache.

The port's cache is a ``PlacedCache`` of the rank's blocks (``cache_specs``:
K / V with the batch over "data" and the sequence over "model", Mamba
states with their channels or heads over "model"); decode gathers each
layer's blocks before use and writes slot ``pos`` into the block that
holds it. Configs: internlm2 (attention), qwen3-moe (the MoE's global view
on a split batch: each data rank ranks its tokens among the whole
batch's), mamba2 (the SSM state) and llama-vision (cross-attention), B = 4
prompts of 64 tokens, the decoded tokens drawn from a seed. Tolerances:
rtol 1e-4, atol 1e-5 of each array's largest magnitude (Mamba 1e-4), the
serving tests' own.
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

ARCHS = ("internlm2_1_8b", "qwen3_moe_235b", "mamba2_1_3b",
         "llama32_vision_90b")
B, S, STEPS = 4, 64, 4


def inputs(cfg):
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.n_vision_tokens:
        batch["vision"] = (0.02 * rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_model))).astype(np.float32)
    decode = [rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
              for _ in range(STEPS)]
    return batch, decode


def _world(rank, world, spec):
    from repro_torch.interop import lm_shards_from_numpy
    from repro_torch.launch.steps import build_step
    from repro_torch.sharding.comm import gather_whole

    mesh = mesh_of(2, 2)
    out = {}
    for arch in ARCHS:
        cfg = get_smoke(arch)
        pre = build_step(cfg, "prefill_32k", mesh)
        dec = build_step(cfg, "decode_32k", mesh)
        assert pre.param_specs == dec.param_specs and not pre.fsdp
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


def test_sharded_prefill_and_decode_match_reference(tmp_path):
    tasks = []
    for arch in ARCHS:
        batch, decode = inputs(get_smoke(arch))
        tasks.append({"kind": "serve", "key": f"{arch}/", "arch": arch,
                      "mesh": (2, 2), "batch": batch, "decode": decode})
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
        specs = got["specs"]
        for ln, entry in specs.items():
            for nm, spec in entry.items():
                if nm in ("k", "v"):  # (B, S + 64, K, dh): 4 and 128 divide
                    assert spec == (("data",), "model", None, None)
