"""The port's training loop on the CPU: resume determinism (a 6 + 6 run
against a 12-step run, bit for bit), the watchdog, a poisoned step and the
launcher; and a trajectory bridged by a checkpoint, against the JAX
package's own loop.

The bridge: the reference's composed loop (its ``init_params``,
``init_opt_state``, ``batch_for`` and a jitted value-and-grad step with
``shd=None``; its ``train`` needs a sharded mesh, which raises on one CPU
device) saves step 3 with the reference's ``CheckpointManager``; the
port's ``train()`` resumes there and its losses for steps 3-8 follow the
reference loop's within rtol 1e-5 (the forward's f32 parity, carried
through six optimizer steps at lr 5e-3).
"""
import jax
import numpy as np
import pytest
import torch

from repro import models as J
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs import get_smoke as j_smoke
from repro.data.pipeline import DataConfig as JData, batch_for as j_batch_for
from repro.optim import adamw as JA
from repro_torch.configs import get_smoke
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import train as launcher
from repro_torch.optim.adamw import OptConfig
from repro_torch.runtime import train_loop
from repro_torch.runtime.train_loop import train

ARCH = "internlm2_1_8b"
CFG = get_smoke(ARCH)
DCFG = DataConfig(seed=0, batch=4, seq_len=32)
OCFG = OptConfig(lr=5e-3, warmup_steps=2, total_steps=24)
BRIDGE_RTOL = 1e-5


def test_resume_is_bit_exact(tmp_path):
    r1 = train(CFG, 6, DCFG, OCFG, ckpt_dir=str(tmp_path / "a"),
               ckpt_every=3, device="cpu")
    r2 = train(CFG, 12, DCFG, OCFG, ckpt_dir=str(tmp_path / "a"),
               ckpt_every=3, device="cpu")
    assert r1.restored_from is None and r2.restored_from == 6
    r3 = train(CFG, 12, DCFG, OCFG, ckpt_dir=str(tmp_path / "b"),
               ckpt_every=100, device="cpu")
    assert r3.final_step == 12 and len(r3.losses) == 12
    assert r1.losses == r3.losses[:6]
    assert r2.losses == r3.losses[6:]
    assert r3.losses[-1] < r3.losses[0]  # it learns
    assert r1.skipped_steps == r2.skipped_steps == r3.skipped_steps == 0


def test_watchdog_fires_once_a_step():
    fired = []
    train(CFG, 2, DCFG, OCFG, watchdog=lambda s, dt: fired.append((s, dt)),
          step_timeout_s=0.0, device="cpu")
    assert [s for s, _ in fired] == [0, 1]
    assert all(dt > 0 for _, dt in fired)


def test_a_poisoned_step_is_skipped_and_poisons_v(monkeypatch):
    """NaN embeddings at step 1: that step is counted as skipped and leaves
    the parameters alone, but writes NaN into v (the reference's unguarded
    v), so step 2's update turns the parameters into NaN and step 3 is
    skipped too."""
    real = train_loop.batch_for

    def poisoned(cfg, dcfg, step, device=None):
        batch = real(cfg, dcfg, step, device=device)
        if step == 1:
            batch["embeds"] = torch.full_like(batch["embeds"], float("nan"))
        return batch

    monkeypatch.setattr(train_loop, "batch_for", poisoned)
    res = train(get_smoke("hubert_xlarge"), 4, DCFG, OCFG, device="cpu")
    finite = [bool(np.isfinite(x)) for x in res.losses]
    assert finite == [True, False, True, False]
    assert res.skipped_steps == 2


def test_launcher_prints_the_reference_line(tmp_path, capsys):
    assert launcher.main(["--arch", ARCH, "--smoke", "--steps", "2",
                          "--batch", "2", "--seq", "16", "--device", "cpu",
                          "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith("done: final loss ")
    assert out[-1].endswith("(skipped 0 poisoned steps)")
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt_00000002.json", "ckpt_00000002.npz"]


def test_train_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(CFG, 1, DCFG, OCFG)


def _reference_loop(steps, ckpt_dir, save_at):
    """The reference's training loop composed from its own pieces, saving
    ``save_at`` with its checkpoint manager; its losses."""
    cfg = j_smoke(ARCH)
    jcfg = JA.OptConfig(**{f: getattr(OCFG, f)
                           for f in OCFG.__dataclass_fields__})
    jdcfg = JData(seed=DCFG.seed, batch=DCFG.batch, seq_len=DCFG.seq_len)

    @jax.jit
    def step(params, state, batch):
        loss, grads = jax.value_and_grad(
            lambda p: J.train_loss(cfg, p, batch, None, remat=True))(params)
        params, state, _ = JA.apply_updates(params, grads, state, jcfg)
        return params, state, loss

    params = J.init_params(cfg, jax.random.PRNGKey(0))
    state = JA.init_opt_state(params, jcfg)
    losses = []
    for s in range(steps):
        params, state, loss = step(params, state, j_batch_for(cfg, jdcfg, s))
        losses.append(float(loss))
        if s + 1 == save_at:
            JManager(ckpt_dir).save(save_at, {"params": params,
                                              "opt": state})
    return losses


def test_a_trajectory_bridged_by_a_reference_checkpoint(tmp_path):
    want = _reference_loop(9, str(tmp_path), save_at=3)
    res = train(CFG, 9, DCFG, OCFG, ckpt_dir=str(tmp_path), device="cpu")
    assert res.restored_from == 3 and len(res.losses) == 6
    np.testing.assert_allclose(res.losses, want[3:], rtol=BRIDGE_RTOL)
