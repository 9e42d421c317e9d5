"""The port's LM serving path against the JAX package's on the CPU: the dense,
vision and encoder smoke configs, end to end (``forward_logits``,
``prefill`` with every cache leaf, three ``decode_step``s), the bf16 case,
and the weight / cache converters.

Both packages run the reference's weights (``init_params`` carried across
with ``interop.lm_params_from_numpy``) on inputs made from a numpy seed.
f32 outputs are held at rtol 1e-4, atol 1e-5; a model with Mamba layers (its
states and everything downstream of them) at rtol 1e-4, atol 1e-4: the
chunk scan runs in another float order than the reference's associative
scan. The harness here is shared with ``test_torch_lm_moe.py`` and
``test_torch_lm_ssm.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as J
from repro.configs import get_smoke as j_smoke
from repro_torch.configs import get_smoke
from repro_torch.interop import (
    lm_cache_from_numpy,
    lm_cache_to_numpy,
    lm_params_from_numpy,
)
from repro_torch.models import (
    decode_step,
    forward_logits,
    init_cache,
    init_params,
    param_count,
    prefill,
)

B, S, STEPS = 2, 32, 3
TOL = {"rtol": 1e-4, "atol": 1e-5}
MAMBA_TOL = {"rtol": 1e-4, "atol": 1e-4}
# bf16 on internlm2-smoke: the largest difference measured was 0.040 on
# logits of magnitude up to 3.78 (bf16's spacing there is 0.0156); the two
# frameworks round bf16 at other places
BF16_TOL = {"rtol": 2e-2, "atol": 6e-2}


# the reference under jit (its own eager ops compile one by one: ~10x the
# wall time); cfg is a frozen dataclass, a static argument
j_init_params = jax.jit(J.init_params, static_argnums=(0, 2))
j_forward_logits = jax.jit(J.forward_logits, static_argnums=0)
j_prefill = jax.jit(J.prefill, static_argnums=0)
j_decode_step = jax.jit(J.decode_step, static_argnums=0)


def tol_for(cfg):
    return MAMBA_TOL if cfg.has("mamba") else TOL


@functools.lru_cache(maxsize=None)
def reference_params(arch, dtype=jnp.float32):
    """The reference's smoke weights for arch (kept per process: the tests
    only read them) and their numpy tree."""
    params = j_init_params(j_smoke(arch), jax.random.PRNGKey(0), dtype)
    return params, jax.tree.map(np.asarray, params)


def inputs(cfg, seed=0):
    """numpy inputs: the model's batch over S positions and STEPS more
    tokens to decode."""
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.embeddings_in:
        batch["embeds"] = (0.1 * rng.standard_normal(
            (B, S, cfg.d_model))).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (B, S + STEPS)).astype(np.int32)
    if not cfg.embeddings_in:
        batch["tokens"] = toks[:, :S]
    if cfg.n_vision_tokens:
        batch["vision"] = (0.02 * rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_model))).astype(np.float32)
    return batch, toks[:, S:]


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def reference_run(cfg, params, batch, nxt):
    """The reference's outputs as numpy (f32): forward logits and, for a
    model that decodes, prefill and STEPS decode steps."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = {"forward": _f32(j_forward_logits(cfg, params, jb))}
    if cfg.encoder_only:
        return out
    logits, cache, pos = j_prefill(cfg, params, jb)
    out["prefill"] = (_f32(logits), jax.tree.map(_f32, cache), int(pos))
    out["decode"] = []
    for i in range(STEPS):
        logits, cache, pos = j_decode_step(cfg, params,
                                           jnp.asarray(nxt[:, i:i + 1]),
                                           cache, pos)
        out["decode"].append((_f32(logits), jax.tree.map(_f32, cache),
                              int(pos)))
    return out


def port_run(cfg, model, batch, nxt):
    """The port's outputs in the reference's layout (numpy, f32)."""
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {"forward": forward_logits(cfg, model, tb).float().numpy()}
    if cfg.encoder_only:
        return out
    logits, cache, pos = prefill(cfg, model, tb)
    out["prefill"] = (logits.float().numpy(), lm_cache_to_numpy(cache), pos)
    out["decode"] = []
    for i in range(STEPS):
        logits, cache, pos = decode_step(
            cfg, model, torch.from_numpy(nxt[:, i:i + 1]), cache, pos)
        out["decode"].append((logits.float().numpy(),
                              lm_cache_to_numpy(cache), pos))
    return out


@functools.lru_cache(maxsize=None)
def both_runs(arch, dtype=jnp.float32):
    """(cfg, the reference's run, the port's run) on arch's smoke config,
    computed once a process."""
    cfg, tcfg = j_smoke(arch), get_smoke(arch)
    params, tree = reference_params(arch, dtype)
    model = lm_params_from_numpy(tcfg, tree, device="cpu")
    batch, nxt = inputs(cfg)
    return cfg, reference_run(cfg, params, batch, nxt), port_run(
        tcfg, model, batch, nxt)


def assert_cache_close(got, want, tol, what):
    assert got.keys() == want.keys(), what
    for lname in want:
        assert got[lname].keys() == want[lname].keys(), (what, lname)
        for leaf, w in want[lname].items():
            g = got[lname][leaf]
            assert g.shape == w.shape, (what, lname, leaf, g.shape, w.shape)
            np.testing.assert_allclose(g, w, **tol,
                                       err_msg=f"{what} {lname}.{leaf}")


def check_forward(cfg, ref, port, tol):
    assert port["forward"].shape == (B, S, cfg.vocab)
    np.testing.assert_allclose(port["forward"], ref["forward"], **tol)


def check_prefill(ref, port, tol):
    (lg, cache, pos), (rlg, rcache, rpos) = port["prefill"], ref["prefill"]
    np.testing.assert_allclose(lg, rlg, **tol)
    assert pos == rpos == S
    assert_cache_close(cache, rcache, tol, "prefill")


def check_decode(ref, port, tol):
    for i, ((lg, cache, pos), (rlg, rcache, rpos)) in enumerate(
            zip(port["decode"], ref["decode"])):
        np.testing.assert_allclose(lg, rlg, **tol, err_msg=f"step {i}")
        assert pos == rpos == S + i + 1
        assert_cache_close(cache, rcache, tol, f"step {i}")


DENSE = ("internlm2_1_8b", "qwen25_14b", "phi3_medium_14b", "qwen3_32b",
         "llama32_vision_90b")


@pytest.fixture(scope="module", params=DENSE + ("hubert_xlarge",))
def runs(request):
    return both_runs(request.param)


@pytest.fixture(scope="module", params=DENSE)
def decode_runs(request):
    return both_runs(request.param)


def test_forward_logits_match_reference(runs):
    cfg, ref, port = runs
    check_forward(cfg, ref, port, tol_for(cfg))


def test_prefill_logits_and_cache_match_reference(decode_runs):
    _, ref, port = decode_runs
    check_prefill(ref, port, TOL)


def test_decode_steps_match_reference(decode_runs):
    _, ref, port = decode_runs
    check_decode(ref, port, TOL)


def test_encoder_only_has_no_prefill_in_either_package():
    cfg = get_smoke("hubert_xlarge")
    params, tree = reference_params("hubert_xlarge")
    batch, _ = inputs(cfg)
    with pytest.raises(ValueError, match="encoder-only"):
        J.prefill(j_smoke("hubert_xlarge"), params,
                  {"embeds": jnp.asarray(batch["embeds"])})
    model = lm_params_from_numpy(cfg, tree, device="cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        prefill(cfg, model, {"embeds": torch.from_numpy(batch["embeds"])})


def test_bf16_serving_matches_reference_within_bf16_rounding():
    cfg, ref, port = both_runs("internlm2_1_8b", dtype=jnp.bfloat16)
    check_forward(cfg, ref, port, BF16_TOL)
    check_prefill(ref, port, BF16_TOL)
    check_decode(ref, port, BF16_TOL)


def test_bf16_params_keep_the_reference_f32_leaves():
    cfg = get_smoke("jamba15_large_398b")
    model = init_params(cfg, dtype=torch.bfloat16, device="cpu")
    f32 = {n.rsplit(".", 1)[-1] for n, p in model.named_parameters()
           if p.dtype == torch.float32}
    assert f32 == {"router", "A_log", "D", "dt_bias"}


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "llama32_vision_90b",
                                  "hubert_xlarge"])
def test_params_round_trip_bit_equal(arch):
    """numpy -> port -> numpy gives the reference's f32 leaves bit for bit,
    the leading U axis stacked back."""
    cfg = get_smoke(arch)
    _, tree = reference_params(arch)
    model = lm_params_from_numpy(cfg, tree, device="cpu")
    for name, p in model.named_parameters():
        path = name.split(".")
        node = tree["units"] if path[0] == "units" else tree
        for key in (path[2:] if path[0] == "units" else path):
            node = node[key]
        want = np.asarray(node)[int(path[1])] if path[0] == "units" else node
        got = p.detach().numpy()
        assert got.dtype == want.dtype and np.array_equal(
            got.view(np.int32), want.view(np.int32)), name
    assert param_count(model) == sum(x.size for x in jax.tree.leaves(tree))


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "llama32_vision_90b"])
def test_cache_round_trip_bit_equal(arch):
    cfg = j_smoke(arch)
    params, _ = reference_params(arch)
    batch, _ = inputs(cfg)
    _, cache, _ = J.prefill(cfg, params,
                            {k: jnp.asarray(v) for k, v in batch.items()})
    tree = jax.tree.map(np.asarray, cache)
    back = lm_cache_to_numpy(lm_cache_from_numpy(tree, device="cpu"))
    assert back.keys() == tree.keys()
    for lname in tree:
        for leaf, want in tree[lname].items():
            got = back[lname][leaf]
            assert got.dtype == want.dtype == np.float32
            assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_converter_refuses_a_wrong_shape_or_dtype():
    cfg = get_smoke("internlm2_1_8b")
    _, tree = reference_params("internlm2_1_8b")
    bad = jax.tree.map(lambda a: a, tree)
    bad["final_norm"] = np.ones(cfg.d_model + 1, np.float32)
    with pytest.raises(ValueError, match="final_norm"):
        lm_params_from_numpy(cfg, bad, device="cpu")
    bad = jax.tree.map(lambda a: a, tree)
    bad["lm_head"] = tree["lm_head"].astype(np.float16)
    with pytest.raises(TypeError, match="lm_head"):
        lm_params_from_numpy(cfg, bad, device="cpu")


def test_init_cache_matches_the_reference_shapes():
    for arch in ("jamba15_large_398b", "llama32_vision_90b"):
        cfg = get_smoke(arch)  # shapes only: nothing is drawn
        want = jax.eval_shape(lambda: J.init_cache(j_smoke(arch), B, S))
        got = init_cache(cfg, B, S, device="cpu")
        assert len(got) == cfg.n_units
        for lname, entry in want.items():
            for leaf, sds in entry.items():
                t = got[0][lname][leaf]
                assert (cfg.n_units,) + tuple(t.shape) == sds.shape
                assert str(t.dtype).split(".")[-1] == str(sds.dtype)


def test_entry_points_run_on_the_card_by_default():
    """``device=None`` is the card: with none present, the entry points
    raise rather than run on the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_smoke("internlm2_1_8b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(cfg, B, S)
    _, tree = reference_params("internlm2_1_8b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_params_from_numpy(cfg, tree)


def test_init_params_draws_the_reference_distributions():
    """Same shapes, dtypes and distributions as the reference's draws (the
    bits differ: threefry against torch's generator)."""
    cfg = get_smoke("mamba2_1_3b")
    model = init_params(cfg, seed=3, device="cpu")
    again = init_params(cfg, seed=3, device="cpu")
    for (n, p), (_, q) in zip(model.named_parameters(),
                              again.named_parameters()):
        assert torch.equal(p, q), n
    _, tree = reference_params("mamba2_1_3b")
    l0 = model.units[0].l0
    a_log = l0.mamba.A_log
    assert bool(((a_log >= 0) & (a_log <= np.log(16.0))).all())
    assert bool((l0.mamba.D == 1).all()) and bool((l0.mamba.dt_bias == 0).all())
    assert bool((l0.norm1 == 1).all())
    emb = model.embed.double()
    assert abs(float(emb.std()) - 0.02) < 0.002
    wz = l0.mamba.wz.double()
    assert abs(float(wz.std()) * np.sqrt(cfg.d_model) - 1) < 0.05
    ref_wz = tree["units"]["l0"]["mamba"]["wz"][0]
    assert abs(float(ref_wz.std()) * np.sqrt(cfg.d_model) - 1) < 0.05
