"""The port's data stream and checkpoints against the JAX package's, on the
CPU.

Data: ``tokens`` and ``labels`` of ``make_batch`` / ``batch_for`` equal the
reference's bit for bit across seeds, steps (0, 123, 2**31 - 1), shapes,
chain counts and the smoke and full vocabularies; the threefry pieces
(``fold_in``, ``split``, the random bits) equal ``jax.random``'s;
``embeds`` and ``vision`` (``0.02 * normal``, XLA's f32 erfinv replayed in
numpy) within atol 1e-7.

Checkpoints: a checkpoint the reference writes restores in the port and
one the port writes restores in the reference, every leaf bit for bit (a
bf16 ``m``, the factored ``v`` and ``step`` included), with the same leaf
keys; the counterparts of the reference's retention, incomplete-manifest
and async tests; the async snapshot is a copy; restore's checks.
"""
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs import get_smoke as j_smoke
from repro.data import pipeline as JP
from repro.optim import adamw as JA
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_smoke
from repro_torch.data import pipeline as TP
from repro_torch.interop import (
    lm_params_from_numpy,
    lm_params_to_numpy,
    opt_state_to_numpy,
)
from repro_torch.models import init_params
from repro_torch.optim.adamw import (
    OptConfig,
    apply_updates,
    init_opt_state,
)
from test_torch_lm_dense import reference_params

EMBED_ATOL = 1e-7
# the smoke vocabularies (96, 64, 128, 32) and full ones of internlm2,
# qwen2.5 / qwen3 and mamba2
VOCABS = (96, 64, 128, 32, 92544, 151936, 50280)


# ---------------------------------------------------------------- data

@pytest.mark.parametrize("vocab", VOCABS)
@pytest.mark.parametrize("seed,step,batch,seq,chains", [
    (0, 0, 2, 16, 7), (7, 123, 3, 40, 7), (1, 2**31 - 1, 8, 256, 7),
    (5, 9, 4, 33, 3)])
def test_tokens_and_labels_bit_equal(vocab, seed, step, batch, seq, chains):
    d = dict(seed=seed, batch=batch, seq_len=seq, n_chains=chains)
    want = JP.make_batch(JP.DataConfig(**d), jnp.int32(step), vocab)
    got = TP.make_batch(TP.DataConfig(**d), step, vocab, device="cpu")
    assert got.keys() == want.keys() == {"tokens", "labels"}
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        assert g.dtype == w.dtype == np.int32 and g.shape == w.shape
        assert np.array_equal(g, w), k
    assert (got["tokens"][:, 1:] == got["labels"][:, :-1]).all()


@pytest.mark.parametrize("arch", ["hubert_xlarge", "llama32_vision_90b",
                                  "internlm2_1_8b"])
@pytest.mark.parametrize("step", [0, 2**31 - 1])
def test_batch_for_matches_reference(arch, step):
    """Tokens and labels bit for bit, ``embeds`` and ``vision`` (the only
    float leaves) within EMBED_ATOL."""
    d = dict(seed=3, batch=4, seq_len=32)
    want = JP.batch_for(j_smoke(arch), JP.DataConfig(**d), step)
    got = TP.batch_for(get_smoke(arch), TP.DataConfig(**d), step,
                       device="cpu")
    assert got.keys() == want.keys()
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k in ("embeds", "vision"):
            np.testing.assert_allclose(g, w, rtol=0, atol=EMBED_ATOL,
                                       err_msg=k)
        else:
            assert np.array_equal(g, w), k


def test_threefry_pieces_equal_jax_random():
    key = jax.random.PRNGKey(11)
    tkey = TP.prng_key(11)
    assert [int(x) for x in tkey] == np.asarray(key).tolist()
    for data in (0, 17, 2**31 - 1):
        want = np.asarray(jax.random.fold_in(key, data))
        assert [int(x) for x in TP.fold_in(tkey, data)] == want.tolist()
    want = np.asarray(jax.random.split(key, 5))
    got = [[int(x) for x in k] for k in TP.split(tkey, 5)]
    assert got == want.tolist()
    want = np.asarray(jax.random.bits(key, (3, 7), jnp.uint32))
    assert np.array_equal(TP.random_bits(tkey, (3, 7)), want)
    want = np.asarray(jax.random.uniform(key, (5, 9)))
    assert np.array_equal(TP.uniform(tkey, (5, 9)), want)
    want = np.asarray(jax.random.normal(key, (64, 64)))
    np.testing.assert_allclose(TP.normal(tkey, (64, 64)), want, rtol=0,
                               atol=EMBED_ATOL / 0.02)


def test_make_batch_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TP.make_batch(TP.DataConfig(batch=2, seq_len=8), 0, 64)


# ---------------------------------------------------------- checkpoints

def _bits(x):
    """A leaf's raw bytes and shape (bf16 of either package as 16 bits)."""
    x = np.ascontiguousarray(np.asarray(x))
    return x.shape, x.reshape(-1).view(np.uint8).tobytes()


def _flat(tree):
    return {jax.tree_util.keystr(p): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_same_bits(got, want):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k in want:
        assert _bits(got[k]) == _bits(want[k]), k


OPT = OptConfig(m_dtype="bfloat16", v_mode="factored", lr=1e-2,
                warmup_steps=1)


def _reference_state(arch="internlm2_1_8b"):
    """The reference's params and optimizer state after one step."""
    jcfg = JA.OptConfig(**{f: getattr(OPT, f)
                           for f in OPT.__dataclass_fields__})
    params, tree = reference_params(arch)
    state = JA.init_opt_state(params, jcfg)
    rng = np.random.default_rng(0)
    grads = jax.tree.map(lambda a: rng.standard_normal(a.shape)
                         .astype(a.dtype), tree)
    return jax.jit(lambda p, g, s: JA.apply_updates(p, g, s, jcfg)[:2])(
        params, grads, state)


def _port_state(arch="internlm2_1_8b"):
    """A port model (its own seed) and its state after one step."""
    cfg = get_smoke(arch)
    model = init_params(cfg, seed=1, device="cpu")
    state = init_opt_state(model, OPT, device="cpu")
    gen = torch.Generator().manual_seed(0)
    grads = {n: torch.randn(p.shape, generator=gen)
             for n, p in model.named_parameters()}
    apply_updates(model, grads, state, OPT)
    return model, state


def _templates(arch="internlm2_1_8b"):
    shapes = init_params(get_smoke(arch), device="meta")
    return {"params": shapes,
            "opt": init_opt_state(shapes, OPT, device="meta")}


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    params, state = _reference_state()
    JManager(str(tmp_path)).save(3, {"params": params, "opt": state})
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 3
    back = mgr.restore(3, _templates(), device="cpu")
    assert back["opt"]["m"]["embed"].dtype == torch.bfloat16
    assert back["opt"]["step"].dtype == torch.int32
    assert_same_bits(lm_params_to_numpy(back["params"]),
                     jax.tree.map(np.asarray, params))
    assert_same_bits(opt_state_to_numpy(back["opt"]),
                     jax.tree.map(np.asarray, state))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    model, state = _port_state()
    CheckpointManager(str(tmp_path)).save(5, {"params": model, "opt": state})
    params, j_state = _reference_state()  # templates: shapes and dtypes
    back = JManager(str(tmp_path)).restore(5, {"params": params,
                                               "opt": j_state})
    assert back["opt"]["m"]["embed"].dtype == jnp.bfloat16
    assert_same_bits(jax.tree.map(np.asarray, back["params"]),
                     lm_params_to_numpy(model))
    assert_same_bits(jax.tree.map(np.asarray, back["opt"]),
                     opt_state_to_numpy(state))


def test_both_writers_give_the_same_leaf_keys_dtypes_and_shapes(tmp_path):
    params, j_state = _reference_state()
    JManager(str(tmp_path / "j")).save(1, {"params": params,
                                           "opt": j_state})
    model, state = _port_state()
    CheckpointManager(str(tmp_path / "t")).save(1, {"params": model,
                                                    "opt": state})
    with np.load(tmp_path / "j" / "ckpt_00000001.npz") as j, \
            np.load(tmp_path / "t" / "ckpt_00000001.npz") as t:
        assert sorted(j.files) == sorted(t.files)
        assert "params/units/l0/attn/wq" in t.files
        assert "opt/v/units/l0/norm1/vr" in t.files
        for k in j.files:
            assert (j[k].dtype, j[k].shape) == (t[k].dtype, t[k].shape), k
    for sub in ("j", "t"):
        with open(tmp_path / sub / "ckpt_00000001.json") as f:
            man = json.load(f)
        assert man["step"] == 1 and man["n_leaves"] == len(j.files)


def test_round_trip_bf16_and_retention(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
            "nest": {"b": torch.tensor(3.5),
                     "c": torch.arange(4, dtype=torch.int32)}}
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (10, 20, 30):
        mgr.save(s, tree)
    assert mgr.all_steps() == [20, 30]  # keep=2 retention
    back = mgr.restore(30, tree, device="cpu")
    assert back["a"].dtype == torch.bfloat16
    assert torch.equal(back["a"], tree["a"])
    assert float(back["nest"]["b"]) == 3.5
    assert torch.equal(back["nest"]["c"], tree["nest"]["c"])


def test_incomplete_manifest_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, {"x": torch.zeros(3)})
    # a crash leaves a npz without a valid manifest
    (tmp_path / "ckpt_00000009.json").write_text("{corrupt")
    assert mgr.latest_step() == 5


def test_async_then_wait_and_the_snapshot_is_a_copy(tmp_path):
    """On the CPU a tensor's numpy view aliases it: the snapshot taken by
    save_async must not see an in-place update made before the write
    ends."""
    model, state = _port_state()
    mgr = CheckpointManager(str(tmp_path))
    before = lm_params_to_numpy(model)
    m_before = opt_state_to_numpy(state)
    mgr.save_async(3, {"params": model, "opt": state})
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
        state["m"]["embed"].add_(1.0)
        state["step"].add_(1)
    mgr.wait()
    assert mgr.latest_step() == 3
    back = mgr.restore(3, _templates(), device="cpu")
    assert_same_bits(lm_params_to_numpy(back["params"]), before)
    assert_same_bits(opt_state_to_numpy(back["opt"]), m_before)


def test_a_failed_async_write_raises_at_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "gone"))
    shutil.rmtree(tmp_path / "gone")
    mgr.save_async(1, {"x": torch.zeros(3)})
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        mgr.wait()
    mgr.wait()  # raised once


def test_restore_refuses_a_missing_leaf_or_another_shape_or_dtype(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.zeros(3), "y": torch.zeros(2)})
    with pytest.raises(KeyError, match="'z'"):
        mgr.restore(1, {"z": torch.zeros(3)}, device="cpu")
    with pytest.raises(ValueError, match="x: ckpt shape"):
        mgr.restore(1, {"x": torch.zeros(4)}, device="cpu")
    with pytest.raises(TypeError, match="x: ckpt dtype"):
        mgr.restore(1, {"x": torch.zeros(3, dtype=torch.bfloat16)},
                    device="cpu")
    model, state = _port_state()
    mgr.save(2, {"params": model})
    bf16 = init_params(get_smoke("internlm2_1_8b"), dtype=torch.bfloat16,
                       device="meta")
    with pytest.raises(TypeError, match="params: ckpt dtype"):
        mgr.restore(2, {"params": bf16}, device="cpu")
    other = init_params(get_smoke("qwen25_14b"), device="meta")
    with pytest.raises(KeyError, match="checkpoint missing leaf"):
        mgr.restore(2, {"params": other}, device="cpu")


def test_restore_runs_on_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.zeros(3)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mgr.restore(1, {"x": torch.zeros(3)})


def test_lm_round_trip_through_numpy_is_bit_equal():
    """lm_params_to_numpy inverts lm_params_from_numpy (bf16 too)."""
    for dtype in (torch.float32, torch.bfloat16):
        model = init_params(get_smoke("jamba15_large_398b"), seed=2,
                            dtype=dtype, device="cpu")
        tree = lm_params_to_numpy(model)
        back = lm_params_from_numpy(model.cfg, tree, device="cpu")
        for (n, p), (_, q) in zip(model.named_parameters(),
                                  back.named_parameters()):
            assert p.dtype == q.dtype and torch.equal(p, q), n
