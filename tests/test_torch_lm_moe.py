"""The port's MoE against the JAX package's on the CPU: the routing (top-k
indices, capacity ranks, which assignments are kept and the slot each one
takes) equal to the reference's, with ties and with tokens dropped; the
layer's output; and the two MoE smoke configs end to end (``forward_logits``,
``prefill`` and three ``decode_step``s), f32 at rtol 1e-4, atol 1e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_smoke
from repro.models import layers as JL
from repro_torch.configs import get_smoke
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import layers as TL
from test_torch_lm_dense import (
    TOL,
    both_runs,
    check_decode,
    check_forward,
    check_prefill,
    reference_params,
)

MOE = ("arctic_480b", "qwen3_moe_235b")


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _dispatch(impl, cfg, router, xt, capacity):
    """Run a package's ``_moe_dispatch_compute`` with an expert_fn that
    records the (E, C, D) buffer it is handed and returns it unchanged, so
    the buffer shows which token sits in which slot and the output shows
    the kept weights."""
    seen = []

    def expert_fn(buf):
        seen.append(buf)
        return buf

    y = impl._moe_dispatch_compute(cfg, router, xt, capacity, expert_fn)
    return np.asarray(y), np.asarray(seen[0])


def _routing_ref(cfg, router, xt, capacity):
    """The reference's top_i, ranks and keep, by its own ops."""
    logits = jnp.einsum("td,de->te", jnp.asarray(xt), jnp.asarray(router))
    top_p, top_i = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)
    eid = top_i.reshape(-1)
    order = jnp.argsort(eid, stable=True)
    seg = jnp.searchsorted(eid[order], eid[order], side="left")
    ranks = jnp.zeros_like(eid).at[order].set(jnp.arange(eid.size) - seg)
    return np.asarray(top_i), np.asarray(ranks < capacity)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("tokens,capacity", [(16, None), (64, None),
                                             (64, 8), (200, 8)])
def test_dispatch_routes_like_the_reference(arch, tokens, capacity):
    """Equal top-k ids, keep flags, buffer slots and outputs. A capacity of
    8 for 64 or 200 tokens drops assignments (asserted)."""
    cfg, tcfg = j_smoke(arch), get_smoke(arch)
    rng = np.random.default_rng(tokens)
    xt = rng.standard_normal((tokens, cfg.d_model)).astype(np.float32)
    router = (rng.standard_normal((cfg.d_model, cfg.n_experts))
              / np.sqrt(cfg.d_model)).astype(np.float32)
    cap = capacity or JL.moe_capacity(cfg, tokens)
    assert TL.moe_capacity(tcfg, tokens) == JL.moe_capacity(cfg, tokens)
    y_ref, buf_ref = _dispatch(JL, cfg, jnp.asarray(router), jnp.asarray(xt),
                               cap)
    y, buf = _dispatch(TL, tcfg, _t(router), _t(xt), cap)
    top_i, keep = _routing_ref(cfg, router, xt, cap)
    probs = torch.softmax(_t(xt) @ _t(router), dim=-1)
    assert np.array_equal(TL._top_k(probs, tcfg.top_k)[1].numpy(), top_i)
    if capacity is not None:
        assert not keep.all()  # this case drops tokens
    assert buf.shape == buf_ref.shape
    assert np.array_equal(buf, buf_ref)  # every token in the same slot
    np.testing.assert_allclose(y, y_ref, **TOL)


def test_top_k_breaks_ties_to_the_lower_index_as_lax_top_k():
    probs = np.array([[0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.4, 0.1, 0.4],
                      [0.3, 0.2, 0.3, 0.2],
                      [0.0, 0.5, 0.5, 0.0]], np.float32)
    for k in (1, 2, 3):
        vals, idx = jax.lax.top_k(jnp.asarray(probs), k)
        got_v, got_i = TL._top_k(_t(probs), k)
        assert np.array_equal(got_i.numpy(), np.asarray(idx))
        assert np.array_equal(got_v.numpy(), np.asarray(vals))


def test_dispatch_with_tied_router_rows_matches_reference():
    """Tokens whose routers tie exactly (a zero router) take the lower
    expert ids in both packages, and the same slots."""
    cfg, tcfg = j_smoke("qwen3_moe_235b"), get_smoke("qwen3_moe_235b")
    rng = np.random.default_rng(9)
    xt = rng.standard_normal((24, cfg.d_model)).astype(np.float32)
    router = np.zeros((cfg.d_model, cfg.n_experts), np.float32)
    router[:, 5] = 0.1  # one expert above the tied rest
    y_ref, buf_ref = _dispatch(JL, cfg, jnp.asarray(router), jnp.asarray(xt),
                               8)
    y, buf = _dispatch(TL, tcfg, _t(router), _t(xt), 8)
    assert np.array_equal(buf, buf_ref)
    np.testing.assert_allclose(y, y_ref, **TOL)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("shape", [(2, 32), (2, 1), (1, 5)])
def test_apply_moe_matches_reference(arch, shape):
    """Prefill-sized and decode-sized token blocks (T = B at decode)."""
    cfg, tcfg = j_smoke(arch), get_smoke(arch)
    _, tree = reference_params(arch)
    model = lm_params_from_numpy(tcfg, tree, device="cpu")
    ref = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["units"]["l0"]["moe"])
    x = np.random.default_rng(sum(shape)).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)
    want = np.asarray(JL.apply_moe(cfg, ref, jnp.asarray(x)))
    got = TL.apply_moe(tcfg, model.units[0].l0.moe, _t(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_moe_capacity_matches_reference():
    for arch in MOE + ("jamba15_large_398b",):
        cfg, tcfg = j_smoke(arch), get_smoke(arch)
        for tokens in (1, 2, 4, 7, 64, 1000, 4096):
            for cf in (1.0, 1.25, 16.0):
                a = dataclasses.replace(cfg, capacity_factor=cf)
                b = dataclasses.replace(tcfg, capacity_factor=cf)
                assert TL.moe_capacity(b, tokens) == JL.moe_capacity(a, tokens)


@pytest.fixture(scope="module", params=MOE)
def runs(request):
    return both_runs(request.param)


def test_forward_logits_match_reference(runs):
    cfg, ref, port = runs
    check_forward(cfg, ref, port, TOL)


def test_prefill_logits_and_cache_match_reference(runs):
    _, ref, port = runs
    check_prefill(ref, port, TOL)


def test_decode_steps_match_reference(runs):
    _, ref, port = runs
    check_decode(ref, port, TOL)
