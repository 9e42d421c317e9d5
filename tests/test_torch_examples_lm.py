"""The port's LM entry points against the reference:
``repro_torch.examples.serve_lm`` and ``train_lm`` with ``--device cpu``.

``serve_lm``: the two packages draw their weights and prompts from
different generators, so the printed ids cannot agree. The decode loop,
``generate``, is held against the reference's ``prefill`` and greedy
``decode_step`` loop on the reference's weights (carried across with
``interop.lm_params_from_numpy``) and the same numpy prompt: every step's
logits within the tolerance of ``tests/test_torch_lm_dense.py``, and the
ids equal wherever the reference's top-2 margin exceeds twice that
tolerance (closer logits may swap within it; a row is compared up to the
first step its ids part). The printed lines are held to the reference
script's fields, and both refuse an encoder-only model alike.

``train_lm``: the reference script raises under jax 0.9 on one CPU
device (its ``make_host_mesh`` gives Explicit axes, on which the
embedding's gather raises ``ShardingTypeError``; the same gap fails
``tests/test_train_loop.py``), so its run cannot be compared. Instead the
reference's training code, composed as ``tests/test_torch_lm_train_loop.py``
composes it (its ``init_params``, ``init_opt_state``, ``batch_for`` and a
jitted value-and-grad step with the script's optimizer settings), saves a
checkpoint at step 3; the twin resumes from it (the packages share the
format) and its losses for steps 3-5 must follow the reference loop's
within rtol 1e-5. The mesh line is held to the reference's
``make_host_mesh(tp=2)`` on this host.
"""
import contextlib
import io
import re

import jax
import numpy as np
import pytest
import torch

from repro import models as J
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs import get_smoke as j_smoke
from repro.data.pipeline import DataConfig as JData, batch_for as j_batch_for
from repro.launch.mesh import make_host_mesh
from repro.optim import adamw as JA
from repro_torch.configs import get_smoke
from repro_torch.examples import serve_lm, train_lm
from repro_torch.interop import lm_params_from_numpy
from test_torch_examples_sssp import imports_of, run_reference, run_twin

TOL = {"rtol": 1e-4, "atol": 1e-5}  # tests/test_torch_lm_dense.py's
MAMBA_TOL = {"rtol": 1e-4, "atol": 1e-4}
B, S, GEN = 2, 12, 6
BRIDGE_RTOL = 1e-5  # tests/test_torch_lm_train_loop.py's

j_init_params = jax.jit(J.init_params, static_argnums=0)
j_prefill = jax.jit(J.prefill, static_argnums=0)
j_decode_step = jax.jit(J.decode_step, static_argnums=0)


@pytest.mark.parametrize("name", ["serve_lm", "train_lm"])
def test_twin_imports_no_jax(name):
    held = imports_of(f"repro_torch.examples.{name}")
    assert "repro_torch" in held
    assert not held & {"jax", "jaxlib", "repro"}, sorted(held)


# ---- serve_lm ---------------------------------------------------------------

def reference_generate(cfg, params, batch, gen):
    """The reference script's loop: (B, gen) ids and (B, gen, vocab)
    logits."""
    jb = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    logits, cache, pos = j_prefill(cfg, params, jb)
    ids, seen = [], []
    for i in range(gen):
        if i:
            logits, cache, pos = j_decode_step(cfg, params, tok, cache, pos)
        tok = jax.numpy.argmax(logits, -1)[:, None].astype(jax.numpy.int32)
        ids.append(np.asarray(tok))
        seen.append(np.asarray(logits, dtype=np.float32))
    return np.concatenate(ids, 1), np.stack(seen, 1)


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "mamba2_1_3b",
                                  "llama32_vision_90b"])
def test_generate_follows_the_reference_loop(arch):
    cfg, tcfg = j_smoke(arch), get_smoke(arch)
    params = j_init_params(cfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.n_vision_tokens:
        batch["vision"] = (0.02 * rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_model))).astype(np.float32)
    want_ids, want_logits = reference_generate(cfg, params, batch, GEN)

    model = lm_params_from_numpy(tcfg, tree, device="cpu")
    got_ids, got_logits, t_prefill, t_decode = serve_lm.generate(
        tcfg, model, {k: torch.from_numpy(v) for k, v in batch.items()}, GEN)
    got_ids, got_logits = got_ids.numpy(), got_logits.numpy()
    assert got_ids.shape == (B, GEN) and got_ids.dtype == np.int32
    assert got_logits.shape == want_logits.shape
    assert t_prefill > 0 and t_decode > 0
    tol = MAMBA_TOL if cfg.has("mamba") else TOL
    compared = 0
    for b in range(B):
        for t in range(GEN):
            np.testing.assert_allclose(got_logits[b, t], want_logits[b, t],
                                       **tol)
            top2 = np.sort(want_logits[b, t])[-2:]
            slack = 2 * (tol["atol"] + tol["rtol"] * np.abs(top2).max())
            if top2[1] - top2[0] > slack:
                assert got_ids[b, t] == want_ids[b, t], (arch, b, t)
                compared += 1
            if got_ids[b, t] != want_ids[b, t]:
                break  # the inputs part from here on
    assert compared >= B  # the margins leave most ids to compare


SERVED = re.compile(r"^(.+): prefill (\d+)x(\d+) in \d+ ms; decoded (\d+) "
                    r"tokens/request in \d+ ms \(\d+ tok/s\)$")
IDS = re.compile(r"^first request's continuation ids: \[([\d, ]*)\]$")


def parse_served(lines):
    head, ids = SERVED.match(lines[0]), IDS.match(lines[1])
    assert len(lines) == 2 and head and ids, lines
    return head.groups(), [int(x) for x in ids[1].split(",")]


def test_serve_lm_prints_the_reference_fields():
    args = ["--arch", "mamba2-1.3b", "--smoke", "--prompt-len", "16",
            "--gen", "4"]
    want, want_ids = parse_served(run_reference("serve_lm.py", args))
    got, got_ids = parse_served(run_twin(serve_lm, args))
    assert got == want == ("mamba2-smoke", "4", "16", "4")
    vocab = get_smoke("mamba2_1_3b").vocab
    assert len(got_ids) == len(want_ids) == 4
    assert all(0 <= i < vocab for i in got_ids)


def test_serve_lm_refuses_an_encoder_only_model():
    args = ["--arch", "hubert-xlarge", "--smoke"]
    with pytest.raises(SystemExit) as want:
        run_reference("serve_lm.py", args)
    with pytest.raises(SystemExit) as got:
        run_twin(serve_lm, args)
    assert str(got.value) == str(want.value) == (
        "hubert-smoke is encoder-only: no decode serving")


# ---- train_lm ---------------------------------------------------------------

ARCH = "internlm2_1_8b"
STEPS, BATCH, SEQ, LR = 6, 4, 32, 3e-3


def reference_losses(ckpt_dir: str, save_at: int) -> list[float]:
    """The reference's training code with the script's settings, saving
    ``save_at`` with its checkpoint manager; its losses."""
    cfg = j_smoke(ARCH)
    ocfg = JA.OptConfig(lr=LR, warmup_steps=10, total_steps=STEPS,
                        m_dtype="bfloat16", v_mode="factored")
    dcfg = JData(seed=0, batch=BATCH, seq_len=SEQ)

    @jax.jit
    def step(params, state, batch):
        loss, grads = jax.value_and_grad(
            lambda p: J.train_loss(cfg, p, batch, None, remat=True))(params)
        params, state, _ = JA.apply_updates(params, grads, state, ocfg)
        return params, state, loss

    params = J.init_params(cfg, jax.random.PRNGKey(0))
    state = JA.init_opt_state(params, ocfg)
    losses = []
    for s in range(STEPS):
        params, state, loss = step(params, state, j_batch_for(cfg, dcfg, s))
        losses.append(float(loss))
        if s + 1 == save_at:
            JManager(ckpt_dir).save(save_at, {"params": params,
                                              "opt": state})
    return losses


STEP = re.compile(r"^step\s+(\d+)  loss (\d+\.\d{4})$")


def test_train_lm_resumes_a_reference_checkpoint(tmp_path):
    want = reference_losses(str(tmp_path), save_at=3)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rec = train_lm.main(["--arch", ARCH, "--smoke", "--steps",
                             str(STEPS), "--batch", str(BATCH), "--seq",
                             str(SEQ), "--lr", str(LR), "--ckpt-dir",
                             str(tmp_path), "--device", "cpu"])
    lines = buf.getvalue().splitlines()
    assert rec.lines == lines
    mesh = dict(make_host_mesh(tp=2).shape)
    assert lines[0] == f"training internlm2-smoke on mesh {mesh}"
    assert lines[1] == "(resumed from checkpointed step 3)"
    steps = [STEP.match(line) for line in lines[2:-1]]
    assert [int(m[1]) for m in steps] == [3, 4, 5]
    np.testing.assert_allclose(rec.fields["losses"], want[3:],
                               rtol=BRIDGE_RTOL)
    np.testing.assert_allclose([float(m[2]) for m in steps], want[3:],
                               atol=5.1e-5)  # printed to 4 places
    assert lines[-1] == (f"final loss {rec.fields['losses'][-1]:.4f}  "
                         "skipped(NaN-guard)=0")
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt_00000003.json", "ckpt_00000003.npz", "ckpt_00000006.json",
        "ckpt_00000006.npz"]


def test_train_lm_from_scratch_prints_the_reference_lines(tmp_path):
    rec = run_twin(train_lm, ["--arch", ARCH, "--smoke", "--steps", "3",
                              "--batch", "2", "--seq", "16", "--ckpt-dir",
                              str(tmp_path)])
    assert rec[0] == "training internlm2-smoke on mesh {'data': 1, " \
                     "'model': 1}"
    assert [int(STEP.match(x)[1]) for x in rec[1:-1]] == [0, 1, 2]
    assert rec[-1].startswith("final loss ")
