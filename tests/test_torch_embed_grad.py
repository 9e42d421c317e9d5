"""The fixed-order embedding gradient (``repro_torch.kernels.embed_grad``)
against the JAX package's lookup gradient and a sequential ``index_add_``.

On the CPU the wrapper runs its plain twin (``ref.embed_grad_ref``); the
card's kernel is held to the twin bit for bit in ``test_torch_cuda.py``
(``-k embed``). Checked here: the twin's bits against a sequential
``index_add_`` (one row at a time, in position order) in f32 and bf16,
with repeated ids, ids that never occur, a row of one and -0 gradients;
the gradient through ``EmbedLookup`` and through a model's lookup against
``jax.grad`` of ``jnp.take`` on the same seeded inputs, within the
standing gradient tolerance (``test_torch_lm_train_tol``: the reference's
scatter-add may sum in another order); the forward unchanged; the fake
tensors of the dry run taking shapes only; and the argument checks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_smoke as ref_smoke
from repro_torch.configs import get_smoke
from repro_torch.kernels import ref
from repro_torch.kernels.embed_grad import EmbedLookup, embed_grad
from repro_torch.models import init_params
from repro_torch.models.transformer import _embed_tokens
from test_torch_lm_train_tol import train_tol

CASES = (  # (ids shape, rows, D, seed)
    ((2, 5), 7, 3, 0), ((64,), 3, 9, 1), ((4,), 1, 300, 2),
    ((6,), 40, 5, 3), ((3, 17), 11, 16, 4), ((0,), 4, 2, 5),
)


def _inputs(shape, rows, d, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, rows, size=shape).astype(np.int32)
    g = rng.standard_normal(shape + (d,)).astype(np.float32)
    g.reshape(-1, d)[::3, 0] = np.float32(-0.0)
    return torch.from_numpy(g).to(dtype), torch.from_numpy(ids)


def _sequential(g, ids, rows):
    """A sequential ``index_add_``: one row at a time, in position order."""
    d = g.shape[-1]
    out = torch.zeros((rows, d), dtype=g.dtype)
    for i, v in enumerate(ids.reshape(-1).tolist()):
        out[v] += g.reshape(-1, d)[i]
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_twin_bits_against_a_sequential_index_add(case, dtype):
    g, ids = _inputs(*case, dtype=dtype)
    rows = case[1]
    got = embed_grad(g, ids, rows)
    want = _sequential(g, ids, rows)
    assert got.dtype == dtype and got.shape == (rows, g.shape[-1])
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16
                                 else torch.int32))
    absent = torch.ones(rows, dtype=torch.bool)
    absent[ids.reshape(-1).long()] = False
    assert not got[absent].signbit().any()  # +0 rows, never -0
    assert torch.equal(ref.embed_grad_ref(g, ids.long(), rows), got)


@pytest.mark.parametrize("case", CASES[:5])
def test_lookup_gradient_against_jax(case):
    g, ids = _inputs(*case)
    rows, d = case[1], case[2]
    rng = np.random.default_rng(case[3] + 100)
    table = rng.standard_normal((rows, d)).astype(np.float32)

    def loss(e):
        return jnp.sum(jnp.take(e, ids.numpy(), axis=0) * g.numpy())

    want = np.asarray(jax.grad(loss)(jnp.asarray(table)))
    t = torch.from_numpy(table).requires_grad_()
    y = EmbedLookup.apply(t, ids)
    assert torch.equal(y, torch.from_numpy(table)[ids.long()])
    y.backward(g)
    _, rtol, share = train_tol(get_smoke("internlm2_1_8b"))
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=rtol,
                               atol=share * np.abs(want).max())


def test_model_lookup_gradient_against_jax():
    """A smoke model's embedding through ``_embed_tokens``: the rows the
    forward gives and the gradient a loss over them sends back, against
    the reference's ``jnp.take`` on the same weights and tokens."""
    cfg, rcfg = get_smoke("internlm2_1_8b"), ref_smoke("internlm2_1_8b")
    model = init_params(cfg, seed=3, device="cpu").requires_grad_()
    table = model.embed.detach().numpy()
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, rcfg.vocab, size=(2, 24)).astype(np.int32)
    tokens[0, :8] = 5  # a run of one token
    w = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    x = _embed_tokens(model, torch.from_numpy(tokens))
    np.testing.assert_array_equal(x.detach().numpy(), table[tokens])
    (x * torch.from_numpy(w)).sum().backward()
    want = np.asarray(jax.grad(lambda e: jnp.sum(jnp.take(e, tokens, axis=0)
                                                 * w))(jnp.asarray(table)))
    _, rtol, share = train_tol(cfg)
    np.testing.assert_allclose(model.embed.grad.numpy(), want, rtol=rtol,
                               atol=share * np.abs(want).max())


def test_fake_tensors_take_shapes_only():
    before = embed_grad.launches
    with FakeTensorMode():
        g = torch.empty((4, 6, 8))
        ids = torch.zeros((4, 6), dtype=torch.int32)
        out = embed_grad(g, ids, 50)
        assert out.shape == (50, 8) and out.dtype == torch.float32
        t = torch.empty((50, 8), requires_grad=True)
        EmbedLookup.apply(t, ids).sum().backward()
        assert t.grad.shape == (50, 8)
    assert embed_grad.launches == before


def test_argument_checks():
    g, ids = _inputs((3,), 4, 2, 0)
    with pytest.raises(TypeError, match="int32 or int64"):
        embed_grad(g, ids.float(), 4)
    with pytest.raises(ValueError, match="want grad"):
        embed_grad(g[:2], ids, 4)
    with pytest.raises(ValueError, match="num_rows"):
        embed_grad(g, ids, -1)
