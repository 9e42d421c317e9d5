"""The port's training loss and its gradients against the JAX package's, on
the CPU: ``train_loss`` and the gradient of every parameter leaf against
``jax.value_and_grad(train_loss)``, the port under each remat choice
(none, ``"full"``, ``"dots"``), on the dense, vision and encoder smoke
configs here and the MoE, SSM and hybrid ones in
``test_torch_lm_train_hybrid.py`` (one file each, so that the parallel
runner spreads the reference's compiles); the three choices against each
other; ``chunked_ce_loss`` against the cross-entropy of the full logits,
with S a multiple of the chunk and not.

Both packages run the reference's weights (carried across with
``interop.lm_params_from_numpy``) on one batch of the synthetic stream
(B = 2, S = 32). The reference runs under ``jax.jit`` with ``shd=None``
and ``remat=True`` (its sharded form raises on one device). Tolerances:
the loss at rtol 1e-5; each gradient leaf at rtol 1e-4 with an atol of
1e-5 times the leaf's largest reference magnitude; a model with Mamba
layers at rtol 1e-4 on the loss and 1e-3 times the leaf's largest
magnitude on the gradients (the chunk scan runs in another float order
than the reference's associative scan); ``test_torch_lm_train_tol.py``
holds them for every test that compares training runs.
The port's three remat choices give the same loss bit for bit, and
gradients within rtol 1e-6 / atol 1e-7 times the leaf's magnitude.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro import models as J
from repro.configs import get_smoke as j_smoke
from repro_torch.configs import ARCHS, get_smoke
from repro_torch.data.pipeline import DataConfig, batch_for
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import (
    REMAT_POLICIES,
    chunked_ce_loss,
    forward_logits,
    train_loss,
)
from repro_torch.models.transformer import _lm_head
from test_torch_lm_dense import reference_params
from test_torch_lm_train_tol import train_tol

B, S = 2, 32
REMATS = [(False, "full"), (True, "full"), (True, "dots")]


def batch_np(cfg, step=0):
    """One batch of the synthetic stream, as numpy (both packages read the
    same arrays)."""
    batch = batch_for(cfg, DataConfig(seed=0, batch=B, seq_len=S), step,
                      device="cpu")
    return {k: v.numpy() for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _j_value_and_grad(arch):
    cfg = j_smoke(arch)
    return jax.jit(jax.value_and_grad(
        lambda p, b: J.train_loss(cfg, p, b, None, remat=True)))


@functools.lru_cache(maxsize=None)
def reference_loss_and_grads(arch):
    """The reference's loss and gradient tree (numpy) on batch_np."""
    params, _ = reference_params(arch)
    loss, grads = _j_value_and_grad(arch)(params, batch_np(get_smoke(arch)))
    return float(loss), jax.tree.map(np.asarray, grads)


def ref_leaf(tree, name):
    """The reference's leaf for a port parameter name (row u of a stacked
    ``units`` leaf)."""
    path = name.split(".")
    if path[0] == "units":
        node = tree["units"]
        for key in path[2:]:
            node = node[key]
        return node[int(path[1])]
    node = tree
    for key in path:
        node = node[key]
    return node


def port_loss_and_grads(arch, remat, policy):
    cfg = get_smoke(arch)
    _, tree = reference_params(arch)
    model = lm_params_from_numpy(cfg, tree, device="cpu").requires_grad_()
    batch = {k: torch.from_numpy(v) for k, v in batch_np(cfg).items()}
    loss = train_loss(cfg, model, batch, remat=remat, remat_policy=policy)
    names, ps = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, ps)
    return loss.detach(), {n: g.numpy() for n, g in zip(names, grads)}


@functools.lru_cache(maxsize=None)
def port_runs(arch):
    return {(remat, policy): port_loss_and_grads(arch, remat, policy)
            for remat, policy in REMATS}


DENSE = ("internlm2_1_8b", "qwen25_14b", "phi3_medium_14b", "qwen3_32b",
         "llama32_vision_90b", "hubert_xlarge")


def check_loss_and_grads(arch):
    cfg = get_smoke(arch)
    loss_rtol, g_rtol, g_atol = train_tol(cfg)
    want_loss, want = reference_loss_and_grads(arch)
    for (remat, policy), (loss, grads) in port_runs(arch).items():
        what = f"remat={remat} {policy}"
        assert np.isfinite(float(loss)), what
        np.testing.assert_allclose(float(loss), want_loss, rtol=loss_rtol,
                                   err_msg=what)
        for name, g in grads.items():
            w = ref_leaf(want, name)
            assert g.shape == w.shape and g.dtype == w.dtype, (what, name)
            np.testing.assert_allclose(
                g, w, rtol=g_rtol, atol=g_atol * float(np.abs(w).max()),
                err_msg=f"{what} {name}")


@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_every_gradient_match_reference(arch):
    check_loss_and_grads(arch)


def test_every_smoke_config_is_checked():
    from test_torch_lm_train_hybrid import HYBRID

    assert sorted(DENSE + HYBRID) == sorted(ARCHS)


def check_remat_choices_agree(arch):
    """Remat changes what the backward pass keeps, not the arithmetic."""
    runs = port_runs(arch)
    loss0, grads0 = runs[(False, "full")]
    for key in REMATS[1:]:
        loss, grads = runs[key]
        assert torch.equal(loss, loss0), key
        for name, g in grads.items():
            scale = float(np.abs(grads0[name]).max())
            np.testing.assert_allclose(g, grads0[name], rtol=1e-6,
                                       atol=1e-7 * scale,
                                       err_msg=f"{key} {name}")


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "llama32_vision_90b"])
def test_remat_choices_agree(arch):
    check_remat_choices_agree(arch)


def test_dots_policy_saves_only_products_without_batch_dims():
    """``"dots"`` keeps ``aten.mm`` outputs (``x @ W`` folds its batch
    axes into rows) and recomputes ``bmm`` (the attention einsums, the
    experts), as ``dots_with_no_batch_dims_saveable`` does."""
    from torch.utils.checkpoint import CheckpointPolicy

    from repro_torch.models.transformer import _save_products

    assert set(REMAT_POLICIES) == set(J.transformer.REMAT_POLICIES)
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    assert _save_products(None, mm) == CheckpointPolicy.MUST_SAVE
    assert _save_products(None, bmm) == CheckpointPolicy.PREFER_RECOMPUTE
    seen = []

    class Record(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(func)
            return func(*args, **(kwargs or {}))

    x, w = torch.ones(2, 3, 4), torch.ones(4, 5)
    with Record():
        _ = x @ w
        _ = torch.einsum("bckgd,btkd->bkgct", torch.ones(1, 2, 1, 2, 4),
                         torch.ones(1, 3, 1, 4))
    assert mm in seen and bmm in seen


@pytest.mark.parametrize("S_", [32, 48])
@pytest.mark.parametrize("chunk", [8, 16])
def test_chunked_ce_equals_the_cross_entropy_of_the_full_logits(S_, chunk):
    """chunk 16 does not divide 48 and falls back to one chunk, as the
    reference does; the vocabulary padding (the smoke vocabulary rounded up
    to 256 rows) is masked out of the logsumexp."""
    cfg = get_smoke("internlm2_1_8b")
    assert cfg.vocab_pad != cfg.vocab
    _, tree = reference_params("internlm2_1_8b")
    model = lm_params_from_numpy(cfg, tree, device="cpu")
    rng = np.random.default_rng(S_ + chunk)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S_ + 1)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    logits = forward_logits(cfg, model, batch).double()
    want = float((torch.logsumexp(logits, -1)
                  - logits.gather(-1, batch["labels"][..., None])[..., 0]
                  ).mean())
    with torch.no_grad():
        got = float(train_loss(cfg, model, batch, remat=False))
        h = torch.randn(B, S_, cfg.d_model, generator=torch.Generator()
                        .manual_seed(0))
        lm_head = _lm_head(cfg, model)
        one = float(chunked_ce_loss(cfg, h, lm_head, batch["labels"],
                                    chunk=S_))
        many = float(chunked_ce_loss(cfg, h, lm_head, batch["labels"],
                                     chunk=chunk))
        j_one = float(J.transformer.chunked_ce_loss(
            j_smoke("internlm2_1_8b"), h.numpy(), np.asarray(lm_head),
            batch["labels"].numpy(), None, chunk=chunk))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(many, one, rtol=1e-6)
    np.testing.assert_allclose(many, j_one, rtol=1e-5)
