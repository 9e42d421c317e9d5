"""The port's Mamba2 (SSD) mixer against the JAX package's on the CPU: the
causal conv, ``softplus``, the chunked scan over several chunks
(``ssm_chunk=8``), the prefill state, the decode step, and the two smoke
configs with Mamba layers end to end. States and outputs are held at rtol
1e-4, atol 1e-4: the port carries chunk states by a loop, the reference by
an associative scan (the same terms in another float order)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_smoke
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import get_smoke
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from test_torch_lm_dense import (
    MAMBA_TOL,
    TOL,
    both_runs,
    check_decode,
    check_forward,
    check_prefill,
    reference_params,
)

SSM = ("mamba2_1_3b", "jamba15_large_398b")
_jit = functools.partial(jax.jit, static_argnums=0)
j_apply_mamba = _jit(JL.apply_mamba)
j_apply_mamba_decode = _jit(JL.apply_mamba_decode)
j_mamba_with_state = _jit(JT._mamba_with_state)
j_mamba_final_state = _jit(JT._mamba_final_state)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _mamba_pair(arch, chunk=None):
    """(ref cfg, port cfg, the reference's mamba params of unit 0's first
    mamba layer, the port's module with the same weights)."""
    cfg, tcfg = j_smoke(arch), get_smoke(arch)
    if chunk is not None:
        cfg = dataclasses.replace(cfg, ssm_chunk=chunk)
        tcfg = dataclasses.replace(tcfg, ssm_chunk=chunk)
    j = [m for m, _ in cfg.pattern].index("mamba")
    _, tree = reference_params(arch)
    model = lm_params_from_numpy(get_smoke(arch), tree, device="cpu")
    ref = jax.tree.map(lambda a: jnp.asarray(a[0]),
                       tree["units"][f"l{j}"]["mamba"])
    return cfg, tcfg, ref, getattr(model.units[0], f"l{j}").mamba


def _u(cfg, S, seed=0, b=2):
    return (np.random.default_rng(seed).standard_normal((b, S, cfg.d_model))
            .astype(np.float32))


@pytest.mark.parametrize("window", [2, 4])
def test_causal_conv_matches_reference(window):
    rng = np.random.default_rng(window)
    x = rng.standard_normal((2, 11, 24)).astype(np.float32)
    w = rng.standard_normal((window, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    got = TL._causal_conv(_t(x), _t(w), _t(b), window).numpy()
    np.testing.assert_allclose(got, _np(JL._causal_conv(x, w, b, window)),
                               **TOL)


def test_softplus_is_the_references_logaddexp():
    """Within 2 f32 ulps of ``jax.nn.softplus`` over [-60, 60] and past F.
    softplus's threshold of 20 (below 1e-20, where the two packages' exp
    differ in their last digits, a dt contributes nothing)."""
    x = np.concatenate([np.linspace(-60, 60, 4001),
                        [-1e4, -88.0, 19.99, 20.0, 20.01, 35.0, 1e4, 0.0]]
                       ).astype(np.float32)
    got = TL._softplus(_t(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=1e-20)


@pytest.mark.parametrize("arch", SSM)
@pytest.mark.parametrize("S,chunk", [(40, 8), (24, 16)])
def test_apply_mamba_matches_reference(arch, S, chunk):
    """chunk 8 runs 5 chunks through the scan; 16 does not divide 24 and
    falls back to one chunk, as the reference does (one chunk of 32 runs in
    the end-to-end tests)."""
    cfg, tcfg, ref, port = _mamba_pair(arch, chunk)
    u = _u(cfg, S, seed=S + chunk)
    want = _np(j_apply_mamba(cfg, ref, jnp.asarray(u)))
    got = TL.apply_mamba(tcfg, port, _t(u)).numpy()
    np.testing.assert_allclose(got, want, **MAMBA_TOL)


@pytest.mark.parametrize("arch", SSM)
def test_prefill_state_matches_reference(arch):
    """The decode-ready state: the pre-conv tails and the final SSM state
    over 5 chunks."""
    cfg, tcfg, ref, port = _mamba_pair(arch, chunk=8)
    u = _u(cfg, 40, seed=1)
    out_r, st_r = j_mamba_with_state(cfg, ref, jnp.asarray(u))
    out_p, st_p = TT._mamba_with_state(tcfg, port, _t(u))
    np.testing.assert_allclose(out_p.numpy(), _np(out_r), **MAMBA_TOL)
    assert st_p.keys() == st_r.keys()
    for leaf in st_r:
        assert tuple(st_p[leaf].shape) == st_r[leaf].shape, leaf
        np.testing.assert_allclose(st_p[leaf].numpy(), _np(st_r[leaf]),
                                   **MAMBA_TOL, err_msg=leaf)
    np.testing.assert_allclose(
        TT._mamba_final_state(tcfg, port, _t(u)).numpy(),
        _np(j_mamba_final_state(cfg, ref, jnp.asarray(u))), **MAMBA_TOL)


@pytest.mark.parametrize("arch", SSM)
def test_decode_steps_continue_the_sequence(arch):
    """Prefill 16 positions, then 4 decode steps from the carried state:
    each step's output equals the full-sequence ``apply_mamba`` at that
    position, and equals the reference's decode step from the same state."""
    cfg, tcfg, ref, port = _mamba_pair(arch, chunk=8)
    u = _u(cfg, 20, seed=2)
    full = TL.apply_mamba(tcfg, port, _t(u)).numpy()
    np.testing.assert_allclose(
        full, _np(j_apply_mamba(cfg, ref, jnp.asarray(u))), **MAMBA_TOL)
    _, st_p = TT._mamba_with_state(tcfg, port, _t(u[:, :16]))
    _, st_r = j_mamba_with_state(cfg, ref, jnp.asarray(u[:, :16]))
    for i in range(16, 20):
        out_p, st_p = TL.apply_mamba_decode(tcfg, port, _t(u[:, i:i + 1]),
                                            st_p)
        out_r, st_r = j_apply_mamba_decode(cfg, ref, jnp.asarray(
            u[:, i:i + 1]), st_r)
        np.testing.assert_allclose(out_p.numpy(), full[:, i:i + 1],
                                   **MAMBA_TOL, err_msg=f"position {i}")
        np.testing.assert_allclose(out_p.numpy(), _np(out_r), **MAMBA_TOL)
        for leaf in st_r:
            np.testing.assert_allclose(st_p[leaf].numpy(), _np(st_r[leaf]),
                                       **MAMBA_TOL, err_msg=leaf)


def test_mamba_state_init_matches_reference():
    cfg, tcfg = j_smoke("jamba15_large_398b"), get_smoke("jamba15_large_398b")
    want = JL.mamba_state_init(cfg, 3)
    got = TL.mamba_state_init(tcfg, 3)
    for leaf, w in want.items():
        assert tuple(got[leaf].shape) == w.shape
        assert str(got[leaf].dtype).split(".")[-1] == str(w.dtype)
        assert not bool(got[leaf].any())


@pytest.fixture(scope="module", params=SSM)
def runs(request):
    return both_runs(request.param)


def test_forward_logits_match_reference(runs):
    cfg, ref, port = runs
    check_forward(cfg, ref, port, MAMBA_TOL)


def test_prefill_logits_and_cache_match_reference(runs):
    _, ref, port = runs
    check_prefill(ref, port, MAMBA_TOL)


def test_decode_steps_match_reference(runs):
    _, ref, port = runs
    check_decode(ref, port, MAMBA_TOL)


def test_ssd_f32_error_grows_with_the_chunk_length():
    """The in-chunk decays exp(cum_i - cum_j) subtract cumulative log-decays
    that grow with the chunk (about -7 a step here), so f32 loses more in a
    long chunk. Against an f64 run of the same weights, the one chunk that
    513 positions fall back to (513 % 128 != 0, as in the reference) is
    several times less precise than chunks of 27; ``chip_smoke.py`` holds
    decode against a forward over 513 positions in chunks that divide it."""
    tcfg = get_smoke("mamba2_1_3b")
    gen = torch.Generator().manual_seed(0)
    p = TL.init_mamba(tcfg, gen)
    p64 = TL.Mamba(tcfg, torch.float64)
    p64.load_state_dict({k: v.double() for k, v in p.state_dict().items()})
    u = TL.rms_norm(torch.randn(2, 513, tcfg.d_model, generator=gen),
                    torch.ones(tcfg.d_model))
    exact = TL.apply_mamba(dataclasses.replace(tcfg, ssm_chunk=27), p64,
                           u.double())

    def err(chunk):
        got = TL.apply_mamba(dataclasses.replace(tcfg, ssm_chunk=chunk), p, u)
        return float((got.double() - exact).abs().max())

    short, one = err(27), err(128)  # 128 falls back to one chunk of 513
    assert one > 4 * short, (short, one)
    assert one < 1e-3
