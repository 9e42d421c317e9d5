"""The port's LM layers and configs against the JAX package's, on the CPU:
every config field for field, every full config's parameter names, shapes
and dtypes with no allocation, and ``rms_norm``, ``rope``, the chunked
``_sdpa``, attention (self, cross, decode) and the MLP on the reference's
weights, f32 at rtol 1e-4, atol 1e-5 (bf16 at its rounding, stated
below)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import init_params as j_init_params
from repro.models import layers as JL
from repro_torch import configs as TC
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import init_params, layers as TL, param_count
from test_torch_lm_dense import reference_params

TOL = {"rtol": 1e-4, "atol": 1e-5}


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _attn_pair(arch, layer="l0", kind="attn"):
    """The reference's attention params of unit 0's layer and the port's
    module carrying the same weights."""
    _, tree = reference_params(arch)
    model = lm_params_from_numpy(TC.get_smoke(arch), tree, device="cpu")
    ref = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["units"][layer][kind])
    return ref, getattr(getattr(model.units[0], layer), kind)


# ---------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", JC.ARCHS)
def test_configs_equal_field_for_field(arch):
    assert TC.ARCHS == JC.ARCHS
    for getter in ("get_config", "get_smoke"):
        want = getattr(JC, getter)(arch)
        got = getattr(TC, getter)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), getter
        for prop in ("n_units", "vocab_pad", "d_inner", "conv_dim"):
            assert getattr(got, prop) == getattr(want, prop), prop
        for kind in ("attn", "xattn", "mamba", "mlp", "moe", "moe_dense"):
            assert got.has(kind) == want.has(kind), kind
        assert TC.runnable_shapes(got) == JC.runnable_shapes(want)


@pytest.mark.parametrize("alias", sorted(JC.ALIASES))
def test_aliases_resolve_to_the_same_config(alias):
    assert TC.ALIASES == JC.ALIASES
    assert dataclasses.asdict(TC.get_config(alias)) == dataclasses.asdict(
        JC.get_config(alias))
    assert dataclasses.asdict(TC.get_smoke(alias)) == dataclasses.asdict(
        JC.get_smoke(alias))


def test_shapes_and_unknown_arch():
    assert {k: dataclasses.asdict(v) for k, v in TC.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JC.SHAPES.items()}
    with pytest.raises(KeyError):
        TC.get_config("gpt-5")
    with pytest.raises(ValueError, match="not divisible"):
        TC.ModelConfig("x", "dense", 3, 8, 2, 2, 4, 8, 16,
                       pattern=(("attn", "mlp"),) * 2)


def _reference_shapes(cfg, dtype):
    """{port parameter name: (shape, dtype name)} from
    ``jax.eval_shape(init_params)``, the U axis unstacked."""
    tree = jax.eval_shape(lambda: j_init_params(cfg, jax.random.PRNGKey(0),
                                                dtype))
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [p.key for p in path]
        if keys[0] == "units":
            for u in range(leaf.shape[0]):
                name = ".".join(["units", str(u)] + keys[1:])
                out[name] = (tuple(leaf.shape[1:]), str(leaf.dtype))
        else:
            out[".".join(keys)] = (tuple(leaf.shape), str(leaf.dtype))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", JC.ARCHS)
def test_full_params_match_reference_eval_shape(arch, dtype):
    """Names, shapes and dtypes of every full config's parameters, built on
    the meta device (nothing allocated, nothing drawn)."""
    want = _reference_shapes(JC.get_config(arch), getattr(jnp, dtype))
    model = init_params(TC.get_config(arch), dtype=getattr(torch, dtype),
                        device="meta")
    got = {name: (tuple(p.shape), str(p.dtype).split(".")[-1])
           for name, p in model.named_parameters()}
    assert all(p.is_meta for p in model.parameters())
    assert got == want
    assert param_count(model) == sum(
        int(np.prod(s)) for s, _ in want.values())


def test_param_counts_of_the_two_served_configs():
    assert param_count(init_params(TC.get_config("internlm2-1.8b"),
                                   device="meta")) == 1_889_634_304
    assert param_count(init_params(TC.get_config("mamba2-1.3b"),
                                   device="meta")) == 1_447_336_960


# ---------------------------------------------------------------- basics

@pytest.mark.parametrize("d", [16, 64, 80])
def test_rms_norm_matches_reference(d):
    rng = np.random.default_rng(d)
    x = rng.standard_normal((2, 5, d)).astype(np.float32) * 3
    scale = rng.standard_normal(d).astype(np.float32)
    got = TL.rms_norm(_t(x), _t(scale), 1e-5).numpy()
    np.testing.assert_allclose(got, _np(JL.rms_norm(x, scale, 1e-5)), **TOL)


def test_rms_norm_bf16_follows_the_reference_order():
    """bf16: the statistics in f32, the products in bf16, as the reference.
    Measured: at most one bf16 spacing (2^-7 relative) apart."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 7, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    want = _np(JL.rms_norm(jnp.asarray(x, jnp.bfloat16),
                           jnp.asarray(scale, jnp.bfloat16)))
    got = TL.rms_norm(_t(x).bfloat16(), _t(scale).bfloat16()).float().numpy()
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("theta", [1e4, 5e5, 1e6])
def test_rope_matches_reference(theta):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    pos = np.array([0, 1, 2, 3, 100, 511, 2047, 2048, 4000], np.int32)
    got = TL.rope(_t(x), _t(pos), theta).numpy()
    np.testing.assert_allclose(got, _np(JL.rope(x, pos, theta)),
                               rtol=1e-4, atol=1e-5)


def test_rope_rotates_halves_not_pairs():
    x = torch.zeros(1, 1, 1, 8)
    x[..., 0] = 1.0  # first of the first half pairs with index 4
    out = TL.rope(x, torch.tensor([1]), 1e4)
    assert out[0, 0, 0, 4] == pytest.approx(np.sin(1.0))
    assert out[0, 0, 0, 1] == 0


# ---------------------------------------------------------------- attention

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("chunk", [8, 512, 12])
def test_sdpa_chunked_and_unchunked_match_reference(chunk, causal):
    """attn_chunk 8 at S = 32 runs four query chunks; 512 one; 12 does not
    divide 32 and falls back to one chunk, as the reference does."""
    cfg = dataclasses.replace(JC.get_smoke("qwen3_32b"), attn_chunk=chunk)
    tcfg = dataclasses.replace(TC.get_smoke("qwen3_32b"), attn_chunk=chunk)
    rng = np.random.default_rng(chunk)
    q = rng.standard_normal((2, 32, 8, 16)).astype(np.float32)
    k = rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
    pos = np.arange(32, dtype=np.int32)
    want = _np(JL._sdpa(cfg, q, k, v, pos, pos, causal))
    got = TL._sdpa(tcfg, _t(q), _t(k), _t(v), _t(pos), _t(pos), causal)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_sdpa_chunks_equal_one_chunk():
    tcfg = TC.get_smoke("internlm2_1_8b")
    rng = np.random.default_rng(5)
    q, k, v = (_t(rng.standard_normal((1, 32, n, 16)).astype(np.float32))
               for n in (4, 2, 2))
    pos = torch.arange(32)
    one = TL._sdpa(tcfg, q, k, v, pos, pos, True)
    four = TL._sdpa(dataclasses.replace(tcfg, attn_chunk=8), q, k, v, pos,
                    pos, True)
    np.testing.assert_allclose(four.numpy(), one.numpy(), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("arch", ["qwen25_14b", "qwen3_32b", "hubert_xlarge"])
def test_apply_attention_matches_reference(arch):
    """qkv bias (qwen2.5, hubert), qk norm (qwen3), non-causal (hubert)."""
    cfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
    ref, port = _attn_pair(arch)
    x = np.random.default_rng(3).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)
    pos = np.arange(32, dtype=np.int32)
    want = _np(JL.apply_attention(cfg, ref, x, pos, causal=cfg.causal))
    got = TL.apply_attention(tcfg, port, _t(x), _t(pos), causal=tcfg.causal)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_cross_attention_and_its_decode_match_reference():
    arch = "llama32_vision_90b"
    cfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
    ref, port = _attn_pair(arch, layer="l4", kind="xattn")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    vis = rng.standard_normal((2, 17, cfg.d_model)).astype(np.float32)
    pos = np.arange(8, dtype=np.int32)
    want = _np(JL.apply_attention(cfg, ref, x, pos, kv_source=vis))
    got = TL.apply_attention(tcfg, port, _t(x), _t(pos), kv_source=_t(vis))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    xk, xv = JL._project_kv(cfg, ref, vis)
    want_d, _ = JL.apply_cross_attention_decode(cfg, ref, x[:, :1],
                                                {"xk": xk, "xv": xv})
    cache = {"xk": _t(_np(xk)), "xv": _t(_np(xv))}
    got_d, same = TL.apply_cross_attention_decode(tcfg, port, _t(x[:, :1]),
                                                  cache)
    assert same is cache
    np.testing.assert_allclose(got_d.numpy(), _np(want_d), **TOL)


@pytest.mark.parametrize("pos", [0, 5, 31])
def test_attention_decode_matches_reference_and_writes_in_place(pos):
    arch = "qwen3_32b"
    cfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
    ref, port = _attn_pair(arch)
    rng = np.random.default_rng(pos)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    ck = rng.standard_normal((2, 40, cfg.n_kv, cfg.d_head)).astype(np.float32)
    cv = rng.standard_normal((2, 40, cfg.n_kv, cfg.d_head)).astype(np.float32)
    want, wc = JL.apply_attention_decode(
        cfg, ref, x, {"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
        jnp.int32(pos))
    cache = {"k": _t(ck.copy()), "v": _t(cv.copy())}
    k_buf = cache["k"]
    got, gc = TL.apply_attention_decode(tcfg, port, _t(x), cache, pos)
    assert gc is cache and gc["k"] is k_buf  # written in place
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    np.testing.assert_allclose(gc["k"].numpy(), _np(wc["k"]), **TOL)
    np.testing.assert_allclose(gc["v"].numpy(), _np(wc["v"]), **TOL)


def test_mlp_matches_reference():
    _, tree = reference_params("internlm2_1_8b")
    model = lm_params_from_numpy(TC.get_smoke("internlm2_1_8b"), tree,
                                 device="cpu")
    ref = jax.tree.map(lambda a: jnp.asarray(a[1]), tree["units"]["l0"]["mlp"])
    x = np.random.default_rng(6).standard_normal((2, 9, 64)).astype(
        np.float32)
    got = TL.apply_mlp(model.units[1].l0.mlp, _t(x)).numpy()
    np.testing.assert_allclose(got, _np(JL.apply_mlp(ref, x)), **TOL)


@pytest.mark.parametrize("which", ["attention", "mlp", "moe", "mamba"])
def test_init_functions_match_reference_shapes(which):
    """Each layer's ``init_*`` builds the reference's parameter names,
    shapes and dtypes (bf16 model; the router and the SSM's A_log, D and
    dt_bias f32), and draws the same way on a fixed generator."""
    arch = {"attention": "qwen25_14b", "mlp": "internlm2_1_8b",
            "moe": "arctic_480b", "mamba": "jamba15_large_398b"}[which]
    cfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
    key, bf = jax.random.PRNGKey(0), jnp.bfloat16
    want = jax.eval_shape({
        "attention": lambda: JL.init_attention(cfg, key, bf),
        "mlp": lambda: JL.init_mlp(key, cfg.d_model, cfg.d_ff, bf),
        "moe": lambda: JL.init_moe(cfg, key, bf),
        "mamba": lambda: JL.init_mamba(cfg, key, bf)}[which])

    def build(seed):
        gen = torch.Generator().manual_seed(seed)
        return {
            "attention": lambda: TL.init_attention(tcfg, gen, torch.bfloat16),
            "mlp": lambda: TL.init_mlp(gen, tcfg.d_model, tcfg.d_ff,
                                       torch.bfloat16),
            "moe": lambda: TL.init_moe(tcfg, gen, torch.bfloat16),
            "mamba": lambda: TL.init_mamba(tcfg, gen, torch.bfloat16)}[which]()

    got, again = build(1), build(1)
    assert {n: (tuple(p.shape), str(p.dtype).split(".")[-1])
            for n, p in got.named_parameters()} == {
        n: (tuple(s.shape), str(s.dtype)) for n, s in want.items()}
    for (n, p), (_, q) in zip(got.named_parameters(),
                              again.named_parameters()):
        assert torch.equal(p, q), n
