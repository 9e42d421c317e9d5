"""The port's production mesh and multi-pod dry run
(``repro_torch.launch.mesh.make_production_mesh``,
``repro_torch.launch.dryrun``) against the JAX package's dry run.

Setup: the default process group is process-wide, so every fake world
runs in a subprocess of its own (``python -c``; its last stdout line is
the JSON the test reads), and the gloo world of the SSSP check in
``torch.multiprocessing`` ranks over a ``file://`` store. The reference
runs in one JAX subprocess with its own ``XLA_FLAGS`` (512 host devices,
set before jax is imported, as its ``dryrun.py`` does), probes off.

Checked here: the production ``Mesh``'s coordinates, groups and
``global_rank`` on both meshes; the record's keys, ``mesh_shape``,
``chips`` and skip reasons against the reference's for every (arch x
shape x mesh); ``internlm2-1.8b`` ``decode_32k``'s argument bytes equal to
the reference's to the byte where the placement is the reference's, and
an FSDP cell's difference pinned; a ``train_4k`` cell's FLOPs against
``benchmarks.roofline.model_flops``; ``extrapolated`` equal to the full
trace, and in a train cell off from it by the depth-1 probe's unfactored
optimizer alone; ``run_sssp`` on the CPU only when asked; and one phase
of the SSSP program over a fake P = 4 world counting the same collective
bytes by kind as a real 4-rank gloo world.

This module imports no JAX at the top: the spawned ranks import it.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]
REF_KEYS = {"arch", "shape", "mesh", "mesh_shape", "chips", "remat_policy",
            "status", "lower_s", "compile_s", "flops", "bytes_accessed",
            "collectives", "memory"}
PORT_EXTRA = {"rank", "use_shd", "device", "arguments", "microbatches",
              "fsdp"}
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
# internlm2-1.8b decode_32k on the pod, the reference's memory_analysis
INTERNLM_ARGUMENT_BYTES = 1_850_150_948
# llama-3.2-vision-90b decode_32k (FSDP): XLA's argument bytes are this
# many fewer than the NamedSharding blocks of the cell's own in_shardings
# (the port holds exactly those blocks)
LLAMA_VISION_XLA_SHORT = 2_621_440
JOIN_S = 300.0


def _start(code: str, env_extra: dict | None = None):
    """Start ``code`` in a fresh interpreter with ``src`` on the path;
    returns a function that waits for it and gives the JSON of its last
    stdout line."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.update(env_extra or {})
    proc = subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=ROOT)

    def wait(timeout: int = 600):
        out, err = proc.communicate(timeout=timeout)
        assert proc.returncode == 0, err[-4000:]
        return json.loads(out.strip().splitlines()[-1])

    return wait


def _python(code: str, env_extra: dict | None = None):
    return _start(code, env_extra)()


# ---------------------------------------------------------------------------
# the reference, once
# ---------------------------------------------------------------------------

REF_CODE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import json
import jax
import numpy as np
from jax.sharding import NamedSharding
from repro.configs import ALIASES, SHAPES, get_config, runnable_shapes
from repro.launch.dryrun import run_cell
from repro.launch.mesh import make_production_mesh
from repro.launch.steps import abstract_params
from repro.sharding.partition import add_fsdp, param_specs

out = {"skipped": {}, "runnable": {}}
for a in ALIASES:
    out["runnable"][a] = runnable_shapes(get_config(a))
    for s in SHAPES:
        if out["runnable"][a][s]:
            for mk in ("pod", "multipod"):
                out["skipped"][f"{a}|{s}|{mk}"] = run_cell(a, s, mk, probe=False)
for a in ("internlm2-1.8b", "llama-3.2-vision-90b"):
    rec = run_cell(a, "decode_32k", "pod", probe=False)
    rec.pop("traceback", None)
    out[a] = rec
cfg = get_config("llama-3.2-vision-90b")
mesh = make_production_mesh()
p = abstract_params(cfg)
sp = add_fsdp(param_specs(cfg, p), p, axis="data", size=16)
blocks = jax.tree.map(
    lambda a, s: int(np.prod(NamedSharding(mesh, s).shard_shape(a.shape)))
    * a.dtype.itemsize, p, sp,
    is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
out["llama_param_blocks"] = int(sum(jax.tree.leaves(blocks)))
print(json.dumps(out, default=str))
"""


@pytest.fixture(scope="module")
def records():
    """(the reference's records, the port's), made side by side."""
    ref = _start(REF_CODE, {"JAX_PLATFORMS": "cpu"})
    port = _start(PORT_CODE)
    return ref(), port()


@pytest.fixture(scope="module")
def reference(records):
    return records[0]


PORT_CODE = r"""
import json
from repro_torch.configs import ALIASES, SHAPES, get_config, runnable_shapes
from repro_torch.launch.dryrun import run_cell

out = {"skipped": {}, "runnable": {}}
for a in ALIASES:
    out["runnable"][a] = runnable_shapes(get_config(a))
    for s in SHAPES:
        if out["runnable"][a][s]:
            for mk in ("pod", "multipod"):
                out["skipped"][f"{a}|{s}|{mk}"] = run_cell(a, s, mk)
for a in ("internlm2-1.8b", "llama-3.2-vision-90b"):
    rec = run_cell(a, "decode_32k", "pod", probe=False)
    rec.pop("traceback", None)
    out[a] = rec
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def port(records):
    return records[1]


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

MESH_CODE = r"""
import json
import torch.distributed as dist
from repro_torch.launch.mesh import make_production_mesh

out = []
for multi, rank in ((False, 0), (False, 37), (False, 255), (True, 0),
                    (True, 300), (True, 511)):
    m = make_production_mesh(multi_pod=multi, rank=rank, device="cpu")
    groups = {"|".join(k) if isinstance(k, tuple) else k:
              sorted(dist.get_process_group_ranks(g))
              for k, g in m.groups.items()}
    out.append({"multi": multi, "rank": m.rank, "names": list(m.axis_names),
                "shape": m.shape, "coords": m.coords, "groups": groups,
                "world": dist.get_world_size(),
                "fake": dist.get_backend(m.world) == "fake",
                "back": m.global_rank(), "model0": m.global_rank(model=0),
                "data3": m.global_rank(data=3),
                "dp": [m.size(("pod", "data")) if multi else m.size("data"),
                       m.coord(("pod", "data") if multi else "data")],
                "whole": len(dist.get_process_group_ranks(m.world))})
print(json.dumps(out))
"""


def test_production_mesh_coordinates_groups_and_ranks():
    got = _python(MESH_CODE)
    for rec in got:
        multi, rank = rec["multi"], rec["rank"]
        assert rec["fake"] and rec["world"] == (512 if multi else 256)
        assert rec["whole"] == rec["world"]
        if multi:
            assert rec["names"] == ["pod", "data", "model"]
            assert rec["shape"] == {"pod": 2, "data": 16, "model": 16}
            p, rest = divmod(rank, 256)
            d, m = divmod(rest, 16)
            assert rec["coords"] == {"pod": p, "data": d, "model": m}
            assert rec["groups"]["pod"] == [d * 16 + m, 256 + d * 16 + m]
            assert rec["groups"]["data"] == [p * 256 + i * 16 + m
                                             for i in range(16)]
            assert rec["groups"]["pod|data"] == sorted(
                q * 256 + i * 16 + m for q in range(2) for i in range(16))
            assert rec["dp"] == [32, p * 16 + d]
            assert rec["data3"] == p * 256 + 3 * 16 + m
        else:
            assert rec["names"] == ["data", "model"]
            assert rec["shape"] == {"data": 16, "model": 16}
            d, m = divmod(rank, 16)
            p = 0
            assert rec["coords"] == {"data": d, "model": m}
            assert set(rec["groups"]) == {"data", "model"}
            assert rec["groups"]["data"] == [i * 16 + m for i in range(16)]
            assert rec["dp"] == [16, d]
            assert rec["data3"] == 3 * 16 + m
        assert rec["groups"]["model"] == [rank - m + i for i in range(16)]
        assert rec["back"] == rank and rec["model0"] == rank - m


def test_production_mesh_refuses_a_real_world_of_another_size(tmp_path):
    got = _python(r"""
import json
import torch.distributed as dist
from repro_torch.launch.mesh import make_production_mesh
dist.init_process_group("gloo", init_method="file://%s", rank=0,
                        world_size=1)
try:
    make_production_mesh(device="cpu")
    print(json.dumps("no error"))
except ValueError as e:
    print(json.dumps(str(e)))
""" % (tmp_path / "store"))
    assert "needs 256 ranks" in got and "holds 1" in got


# ---------------------------------------------------------------------------
# records against the reference's
# ---------------------------------------------------------------------------


def test_record_schema_mesh_and_skip_reasons(reference, port):
    assert port["runnable"] == reference["runnable"]
    assert set(port["skipped"]) == set(reference["skipped"])
    assert len(port["skipped"]) >= 8
    for key, want in reference["skipped"].items():
        got = port["skipped"][key]
        assert got == want, key  # every key, the reason and the mesh too
    rec, want = port["internlm2-1.8b"], reference["internlm2-1.8b"]
    assert set(want) == REF_KEYS
    assert set(rec) == REF_KEYS | PORT_EXTRA
    assert set(rec["memory"]) == set(want["memory"])
    assert set(rec["collectives"]) == set(want["collectives"]) == set(KINDS)
    for k in ("arch", "shape", "mesh", "mesh_shape", "chips", "status",
              "remat_policy"):
        assert rec[k] == want[k], k
    assert rec["compile_s"] == 0.0 and rec["memory"]["generated_code_bytes"] == 0


def test_internlm2_decode_argument_bytes_to_the_byte(reference, port):
    rec = port["internlm2-1.8b"]
    assert reference["internlm2-1.8b"]["memory"]["argument_bytes"] == \
        INTERNLM_ARGUMENT_BYTES
    parts = rec["arguments"]
    assert rec["fsdp"] is False and rec["rank"] == 0
    assert sum(parts.values()) == rec["memory"]["argument_bytes"]
    # the reference's placement: the (128, 1) int32 tokens over the 16
    # data ranks and a 0-d int32 pos; the port's step takes the global
    # tokens (and pos as a Python int)
    assert parts["batch"] == 128 * 4
    as_reference = parts["params"] + parts["cache"] + 128 * 4 // 16 + 4
    assert as_reference == INTERNLM_ARGUMENT_BYTES


def test_fsdp_cell_placement_difference_is_pinned(reference, port):
    rec, want = port["llama-3.2-vision-90b"], \
        reference["llama-3.2-vision-90b"]
    assert rec["fsdp"] is True
    parts = rec["arguments"]
    # the port holds exactly the reference's NamedSharding blocks
    assert parts["params"] == reference["llama_param_blocks"]
    as_reference = parts["params"] + parts["cache"] + 128 * 4 // 16 + 4
    assert as_reference - want["memory"]["argument_bytes"] == \
        LLAMA_VISION_XLA_SHORT


# ---------------------------------------------------------------------------
# counts of the trace
# ---------------------------------------------------------------------------

CUT_CODE = r"""
import dataclasses, json, sys
from repro_torch.configs import get_config
from repro_torch.launch import dryrun

arch, shape, layers, probe = sys.argv[1:5]
full = get_config(arch)
cut = dataclasses.replace(full, n_layers=int(layers))
dryrun.get_config = lambda name: cut
rec = dryrun.run_cell(arch, shape, "pod", probe=probe == "1")
rec.pop("traceback", None)
print(json.dumps(rec))
"""


def _cut_cell(arch, shape, layers, probe):
    code = CUT_CODE.replace("sys.argv[1:5]",
                            repr([arch, shape, str(layers), str(int(probe))]))
    return _python(code)


def test_train_flops_within_the_remat_factor():
    """internlm2-1.8b train_4k at published widths cut to 2 layers: the
    traced FLOPs of one rank against the analytic count. Each rank
    computes its share of the step (its data block's tokens, its heads,
    FFN columns and block of the vocabulary; nothing is repeated on the 16
    model ranks but the K / V columns its heads share with a neighbour),
    so the ranks' FLOPs sum to the whole step's; full remat runs every
    forward product twice (4 / 3 of 6ND, the chunked cross-entropy's head
    too), the lookup multiplies nothing (the analytic count takes the
    embedding as a product), and the attention computes every score under
    the causal mask (twice the causal half the analytic count takes).
    Elementwise work is not counted."""
    import dataclasses

    from benchmarks.roofline import model_flops
    from repro.configs import get_config as ref_config

    rec = _cut_cell("internlm2-1.8b", "train_4k", 2, False)
    assert rec["status"] == "ok", rec.get("error")
    cfg = dataclasses.replace(ref_config("internlm2-1.8b"), n_layers=2)
    analytic = model_flops(cfg, "train_4k")
    tokens = 256 * 4096
    attn_causal = 6 * 2 * cfg.n_units * 256 * 4096 ** 2 * \
        cfg.n_heads * cfg.d_head / 2
    lookup = 6 * cfg.vocab_pad * cfg.d_model * tokens
    dense = analytic - lookup - attn_causal
    whole_step = rec["flops"] * rec["chips"]
    # the products alone, remat's factor on them; then the scores too
    assert 4 / 3 * dense < whole_step <= 4 / 3 * (dense + 2 * attn_causal)


def test_decode_gathers_no_cache_leaf():
    """internlm2-1.8b decode_32k at published widths cut to 2 layers on
    the pod: the cache stays on its blocks (each rank attends every head
    over its slots and the blocks' softmax partials are combined), so a
    step's all-gathers (q, the new K / V, the partials, the logits) stay
    below one layer's K / V block, and no weight moves over "model"
    (internlm2's 8 KV heads over 16 ranks: a rank takes its neighbour's
    half-head of wk / wv only where it trains; decode gathers the new
    columns)."""
    rec = _cut_cell("internlm2-1.8b", "decode_32k", 2, False)
    assert rec["status"] == "ok", rec.get("error")
    layer_kv = rec["arguments"]["cache"] / 2  # k and v of one layer
    assert 0 < rec["collectives"]["all-gather"] < layer_kv / 2
    assert rec["collectives"]["collective-permute"] == 0


def test_extrapolated_equals_the_full_trace():
    rec = _cut_cell("qwen3-moe-235b-a22b", "decode_32k", 3, True)
    assert rec["status"] == "ok", rec.get("error")
    ext = rec["extrapolated"]
    assert ext["flops"] == rec["flops"]
    assert ext["bytes_accessed"] == rec["bytes_accessed"]
    assert ext["collectives"] == rec["collectives"]
    assert rec["collectives"]["all-gather"] > 0


# qwen2.5-14b train_4k cut to 3 units: the extrapolated bytes_accessed
# over the full trace's (the depth-1 probe's optimizer, see below)
QWEN_TRAIN_BYTES_GAP = 449_284

TRAIN_GAP_CODE = r"""
import dataclasses, json
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.optim.adamw import OptConfig

cut = dataclasses.replace(get_config("qwen2.5-14b"), n_layers=3)
dryrun.get_config = lambda name: cut
out = {"factored": dryrun.run_cell("qwen2.5-14b", "train_4k", "pod")}
build = dryrun._build
full_v = OptConfig(m_dtype="bfloat16", v_mode="full", total_steps=10000)
dryrun._build = lambda *a, **kw: build(*a, opt_cfg=full_v, **kw)
out["full_v"] = dryrun.run_cell("qwen2.5-14b", "train_4k", "pod")
for rec in out.values():
    rec.pop("traceback", None)
print(json.dumps(out))
"""


def test_extrapolated_train_cell_gap_is_the_depth_one_optimizer():
    """A train cell's probes are not affine in the optimizer, in the
    reference's dry run as here: at depth 1 a 1-D unit leaf stacks to
    (1, D), which the factored second moment does not factor (two rows
    needed), so only that probe updates a full ``v`` for it. With a full
    ``v`` everywhere the extrapolation is exact; with the cell's own
    factored one, FLOPs stay exact and the bytes and all-reduce bytes are
    off by that probe's difference. The all-reduce gap is the q, k and v
    biases' (sharded over "model") factored row means, one f32 a unit
    each, summed over "model" at depth >= 2 only: 4 * 3 * (U - 2) bytes
    (552 at the full 48 units)."""
    got = _python(TRAIN_GAP_CODE)
    units = 3
    for kind, rec in got.items():
        assert rec["status"] == "ok", (kind, rec.get("error"))
        assert rec["extrapolated"]["flops"] == rec["flops"], kind
    exact, ext = got["full_v"], got["full_v"]["extrapolated"]
    assert ext["bytes_accessed"] == exact["bytes_accessed"]
    assert ext["collectives"] == exact["collectives"]
    rec, ext = got["factored"], got["factored"]["extrapolated"]
    assert ext["bytes_accessed"] - rec["bytes_accessed"] == \
        QWEN_TRAIN_BYTES_GAP
    gap = {k: ext["collectives"][k] - rec["collectives"][k] for k in KINDS}
    assert gap == {**dict.fromkeys(KINDS, 0),
                   "all-reduce": 4 * 3 * (units - 2)}


# ---------------------------------------------------------------------------
# the SSSP program: on the card unless the CPU is asked for
# ---------------------------------------------------------------------------


def test_run_sssp_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    from repro_torch.launch import dryrun

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.run_sssp("pod", n_vertices=4096, avg_deg=4)
    assert not torch.distributed.is_initialized()  # raised before joining
    got = _python(r"""
import json
from repro_torch.launch.dryrun import run_sssp
rec = run_sssp("pod", n_vertices=4096, avg_deg=4, device="cpu")
rec.pop("traceback", None)
print(json.dumps(rec))
""")
    assert got["status"] == "ok", got.get("error")
    assert got["device"] == "cpu" and got["chips"] == 256
    assert got["n_loc"] == 16 and got["e_loc"] == 64 and got["phases"] == 1


# ---------------------------------------------------------------------------
# the SSSP program: a fake world against a real gloo one
# ---------------------------------------------------------------------------

SSSP_N, SSSP_DEG, SSSP_P = 4096, 8, 4


def _gloo_rank(rank: int, world: int, store: str, out: str):
    import torch.distributed as dist

    from repro_torch.launch.dryrun import sssp_block, sssp_phase

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=store, rank=rank,
                            world_size=world)
    try:
        got = {}
        for schedule in ("allreduce", "reduce_scatter"):
            sg = sssp_block(SSSP_N, SSSP_DEG, world, rank, "cpu")
            got[schedule] = sssp_phase(sg, schedule)["collectives"]
        with open(f"{out}.{rank}.json", "w") as f:
            json.dump(got, f)
    finally:
        dist.destroy_process_group()


def test_sssp_phase_collective_bytes_fake_against_gloo(tmp_path):
    ctx = mp.spawn(_gloo_rank, args=(SSSP_P, f"file://{tmp_path}/store",
                                     str(tmp_path / "gloo")),
                   nprocs=SSSP_P, join=False)
    fake = _python(f"""
import json
from repro_torch.launch.dryrun import sssp_block, sssp_phase
from repro_torch.launch.mesh import join_fake_world
out = {{}}
join_fake_world({SSSP_P}, 0)
for schedule in ("allreduce", "reduce_scatter"):
    sg = sssp_block({SSSP_N}, {SSSP_DEG}, {SSSP_P}, 0, "cpu")
    out[schedule] = sssp_phase(sg, schedule)
print(json.dumps(out))
""")
    deadline = time.monotonic() + JOIN_S
    while not ctx.join(timeout=2.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError("the gloo world outlived its limit")
    # the fake world's rank 0 holds the source, so its fringe count alone
    # starts the phase, as the sum does in the real world (the dry run
    # traces rank 0); every real rank runs the same collectives
    n_loc = SSSP_N // SSSP_P
    for rank in range(SSSP_P):
        with open(tmp_path / f"gloo.{rank}.json") as f:
            gloo = json.load(f)
        for schedule in ("allreduce", "reduce_scatter"):
            rec = fake[schedule]
            assert rec["collectives"] == gloo[schedule], (rank, schedule)
            assert rec["phases"] == 1
            assert rec["collectives"]["all-gather"] == SSSP_N * 4
            exchange = "all-reduce" if schedule == "allreduce" else \
                "all-to-all"
            assert rec["collectives"][exchange] >= SSSP_P * n_loc * 4
            assert rec["memory"]["argument_bytes"] > 0


# ---------------------------------------------------------------------------
# a mesh of two data axes, run for real
# ---------------------------------------------------------------------------

POD_MESH = (2, 2, 1)  # (pod, data, model): 4 gloo ranks


def _pod_rank(rank: int, world: int, store: str, out: str):
    """One rank of a (pod, data, model) mesh: the smoke internlm2's loss,
    every gathered gradient and one AdamW step's gradient norm, FSDP over
    "data" (the reference's: each pod holds a whole copy)."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch.configs import get_smoke
    from repro_torch.data.pipeline import DataConfig, batch_for
    from repro_torch.launch.mesh import POD_AXES, make_mesh_axes
    from repro_torch.models import init_params
    from repro_torch.models.layers import ShardingCtx
    from repro_torch.optim.adamw import OptConfig, apply_updates, init_opt_state
    from repro_torch.runtime.train_loop import data_axes, value_and_grad
    from repro_torch.sharding.partition import (
        add_fsdp,
        gather_param,
        param_specs,
        place_params,
    )

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=store, rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh_axes(POD_MESH, POD_AXES, "cpu")
        cfg = get_smoke("internlm2_1_8b")
        shapes = init_params(cfg, device="meta")
        specs = add_fsdp(param_specs(cfg, shapes), shapes,
                         size=mesh.shape["data"])
        model = place_params(init_params(cfg, seed=4, device="cpu"), mesh,
                             specs)
        batch = batch_for(cfg, DataConfig(batch=4, seq_len=32), 0,
                          device="cpu")
        shd = ShardingCtx(dp=data_axes(mesh), tp="model", mesh=mesh)
        mesh.stats = {}
        loss, grads = value_and_grad(cfg, model, batch, shd)
        got = {"loss": float(loss), "by_kind": mesh.stats["by_kind"],
               "dp": list(shd.dp)}
        mesh.stats = None
        whole = {n: gather_param(model, n, g) for n, g in grads.items()}
        ocfg = OptConfig(lr=1e-2, warmup_steps=1, total_steps=4,
                         m_dtype="bfloat16", v_mode="factored")
        stats = apply_updates(model, grads, init_opt_state(model, ocfg), ocfg)
        got["gnorm"] = float(stats["gnorm"])
        if rank == 0:
            np.savez(f"{out}.npz", **{n: g.numpy() for n, g in whole.items()})
            with open(f"{out}.json", "w") as f:
                json.dump(got, f)
    finally:
        dist.destroy_process_group()


def test_two_data_axes_train_step_against_one_process(tmp_path):
    """The batch over ("pod", "data"), FSDP over "data" and each pod a
    whole copy: the loss, every gradient (summed over "pod" too) and the
    optimizer's gradient norm against one process's step, within the
    standing tolerance."""
    import numpy as np

    from repro_torch.configs import get_smoke
    from repro_torch.data.pipeline import DataConfig, batch_for
    from repro_torch.models import init_params
    from repro_torch.optim.adamw import OptConfig, apply_updates, init_opt_state
    from repro_torch.runtime.train_loop import value_and_grad
    from test_torch_lm_train_tol import train_tol

    ctx = mp.spawn(_pod_rank, args=(4, f"file://{tmp_path}/store",
                                    str(tmp_path / "pod")),
                   nprocs=4, join=False)
    cfg = get_smoke("internlm2_1_8b")
    one = init_params(cfg, seed=4, device="cpu")
    batch = batch_for(cfg, DataConfig(batch=4, seq_len=32), 0, device="cpu")
    want_l, want_g = value_and_grad(cfg, one, batch)
    ocfg = OptConfig(lr=1e-2, warmup_steps=1, total_steps=4,
                     m_dtype="bfloat16", v_mode="factored")
    state = init_opt_state(one, ocfg, device="cpu")
    want_norm = float(apply_updates(one, want_g, state, ocfg)["gnorm"])
    deadline = time.monotonic() + JOIN_S
    while not ctx.join(timeout=2.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError("the pod world outlived its limit")
    with open(tmp_path / "pod.json") as f:
        got = json.load(f)
    got_g = dict(np.load(tmp_path / "pod.npz"))
    loss_rtol, g_rtol, share = train_tol(cfg)
    assert got["dp"] == ["pod", "data"]
    assert abs(got["loss"] - float(want_l)) <= loss_rtol * abs(float(want_l))
    assert set(got_g) == set(want_g)
    for n, w in want_g.items():
        w = w.numpy()
        np.testing.assert_allclose(got_g[n], w, rtol=g_rtol,
                                   atol=share * np.abs(w).max(), err_msg=n)
    assert abs(got["gnorm"] - want_norm) <= g_rtol * want_norm
    # the gradients of the whole copies are summed over "pod"
    assert got["by_kind"]["all-reduce"] > 0
    assert got["by_kind"]["reduce-scatter"] > 0
