"""The port's AdamW against the JAX package's, on the CPU, on identical
gradients: ``init_opt_state``'s layout, ``schedule``, ``global_norm`` and
clipping, three ``apply_updates`` steps in both ``v_mode``s and both
``m_dtype``s on three smoke models (internlm2: U = 2, so each leaf that is
1-D in a unit is factored ACROSS the units; mamba2: ``A_log``, ``D`` and
``dt_bias`` likewise; jamba: U = 1, so a (1, D) leaf is not factorable and
a (1, E, D, F) one is), and the unguarded ``v`` of a poisoned step.

The reference runs ``apply_updates`` under ``jax.jit``; its compiled
arithmetic contracts some products and sums into FMAs, which eager PyTorch
does not. So ``m`` and ``v`` are held at rtol 2e-6 with an atol of 1e-6
times the leaf's largest magnitude (``b1 * m + (1 - b1) * g`` can cancel,
and an FMA rounds it once), a bf16 ``m`` at one bf16 unit in the last
place (rtol 2**-7: the f32 value it rounds can sit on a rounding boundary)
with an atol of 2**-8 times the leaf's largest magnitude (such a unit,
kept, carries into the next steps, where ``b1 * m + (1 - b1) * g`` can
cancel to a smaller value), and the parameters at rtol 2e-6 with an atol
of 1e-6 times the leaf's largest change over the run (2**-7 of it when
``m`` is bf16: one unit of ``m`` moves that element's update by up to
2**-8 of itself).
``gnorm`` is held at rtol 1e-6, ``lr`` at 1e-7; ``finite`` and the step
counter are exact.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as JA
from repro_torch.configs import get_smoke
from repro_torch.interop import (
    lm_params_from_numpy,
    lm_params_to_numpy,
    opt_state_from_numpy,
    opt_state_to_numpy,
)
from repro_torch.optim.adamw import (
    OptConfig,
    apply_updates,
    global_norm,
    init_opt_state,
    schedule,
)
from test_torch_lm_dense import reference_params

MODES = [(m, v) for m in ("float32", "bfloat16") for v in ("full", "factored")]
ARCHS = ("internlm2_1_8b", "mamba2_1_3b", "jamba15_large_398b")
RTOL, SHARE, BF16_RTOL = 2e-6, 1e-6, 2.0 ** -7


def j_cfg(cfg: OptConfig) -> JA.OptConfig:
    return JA.OptConfig(**{f: getattr(cfg, f)
                           for f in cfg.__dataclass_fields__})


@functools.lru_cache(maxsize=None)
def _j_apply(jcfg):
    return jax.jit(lambda p, g, s: JA.apply_updates(p, g, s, jcfg))


def _np(x):
    """numpy of a reference leaf; bf16 as f32 (exact)."""
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _port_np(x):
    """numpy of a port leaf (``opt_state_to_numpy``'s bf16 void records as
    f32, exact)."""
    if x.dtype == np.dtype("V2"):
        bits = x.view(np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32)
    return x


def _flat(tree):
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


def assert_tree_close(got, want, what, rtol=RTOL, share=SHARE, base=None):
    """Every leaf of two nested dicts (got: the port's numpy tree) within
    rtol and an atol of ``share`` times the leaf's largest magnitude, or
    its largest change from ``base`` (a tree like ``want``)."""
    got, want = _flat(got), _flat(want)
    base = None if base is None else _flat(base)
    assert got.keys() == want.keys(), what
    for path, w in want.items():
        g, w = _port_np(got[path]), _np(w)
        assert g.shape == w.shape, (what, path)
        ref = np.abs(w) if base is None else np.abs(w - _np(base[path]))
        scale = float(np.nanmax(ref)) if w.size else 0.0
        np.testing.assert_allclose(
            g, w, rtol=rtol, atol=share * scale,
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


def grads_tree(tree, seed, scale):
    """A seeded gradient for every leaf of a parameter tree."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (scale * rng.standard_normal(a.shape)).astype(a.dtype), tree)


def port_grads(cfg, tree):
    """The port's gradient dict (parameter name -> tensor) of a tree."""
    model = lm_params_from_numpy(cfg, tree, device="cpu")
    return {n: p.detach() for n, p in model.named_parameters()}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("m_dtype,v_mode", MODES)
def test_init_opt_state_has_the_reference_layout(arch, m_dtype, v_mode):
    cfg = OptConfig(m_dtype=m_dtype, v_mode=v_mode)
    _, tree = reference_params(arch)
    want = jax.eval_shape(lambda p: JA.init_opt_state(p, j_cfg(cfg)), tree)
    model = lm_params_from_numpy(get_smoke(arch), tree, device="cpu")
    got = opt_state_to_numpy(init_opt_state(model, cfg, device="cpu"))
    g_flat = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    w_flat = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert g_flat.keys() == w_flat.keys()
    for path, w in w_flat.items():
        g = g_flat[path]
        assert g.shape == w.shape, path
        want_dt = "V2" if str(w.dtype) == "bfloat16" else str(w.dtype)
        assert (g.dtype.str[1:] if g.dtype.kind == "V" else str(g.dtype)) \
            == want_dt, path
        raw = np.ascontiguousarray(g).reshape(-1).view(np.uint8)
        assert not raw.any(), path


def test_one_d_unit_leaves_factor_across_units():
    """The reference factorises the stacked (U, D) leaf: smoke internlm2's
    ``units/l0/norm1`` (2, 64) keeps vr (2,) and vc (64,); with U = 1
    (jamba) a (1, D) leaf keeps a full v and a (1, E, D, F) leaf is
    factored."""
    cfg = OptConfig(v_mode="factored")
    st = init_opt_state(lm_params_from_numpy(
        get_smoke("internlm2_1_8b"), reference_params("internlm2_1_8b")[1],
        device="cpu"), cfg, device="cpu")
    norm = st["v"]["units/l0/norm1"]
    assert norm["vr"].shape == (2,) and norm["vc"].shape == (64,)
    assert st["v"]["final_norm"].keys() == {"v"}
    st = init_opt_state(lm_params_from_numpy(
        get_smoke("jamba15_large_398b"),
        reference_params("jamba15_large_398b")[1], device="cpu"), cfg,
        device="cpu")
    assert st["v"]["units/l0/norm1"]["v"].shape == (1, 64)
    moe = [p for p in st["v"] if p.endswith("moe/wi")]
    assert moe and all(st["v"][p].keys() == {"vr", "vc"} for p in moe)


# jamba (U = 1; its reference compiles take the longest) in the factored
# modes, where U = 1 changes what is factorable
STEP_CASES = [(a, m, v) for a in ARCHS for m, v in MODES
              if a != "jamba15_large_398b" or v == "factored"]


@pytest.mark.parametrize("arch,m_dtype,v_mode", STEP_CASES)
def test_three_steps_match_reference(arch, m_dtype, v_mode):
    """Step 0 is clipped (gradient norm far above clip_norm), steps 1 and 2
    are not; the schedule is in warm-up at steps 0-1 and past it at 2."""
    cfg = OptConfig(lr=1e-2, warmup_steps=2, total_steps=10, m_dtype=m_dtype,
                    v_mode=v_mode)
    jcfg = j_cfg(cfg)
    tcfg = get_smoke(arch)
    params, tree = reference_params(arch)
    j_state = JA.init_opt_state(params, jcfg)
    model = lm_params_from_numpy(tcfg, tree, device="cpu")
    state = opt_state_from_numpy(cfg, jax.tree.map(np.asarray, j_state),
                                 model, device="cpu")
    bf16 = m_dtype == "bfloat16"
    for step, gscale in enumerate((1.0, 1e-3, 1e-3)):
        g = grads_tree(tree, seed=step, scale=gscale)
        params, j_state, j_stats = _j_apply(jcfg)(params, g, j_state)
        stats = apply_updates(model, port_grads(tcfg, g), state, cfg)
        assert bool(stats["finite"]) and bool(j_stats["finite"])
        np.testing.assert_allclose(float(stats["gnorm"]),
                                   float(j_stats["gnorm"]), rtol=1e-6)
        np.testing.assert_allclose(float(stats["lr"]), float(j_stats["lr"]),
                                   rtol=1e-7)
        assert int(state["step"]) == int(j_state["step"]) == step + 1
        what = f"step {step}"
        assert_tree_close(lm_params_to_numpy(model),
                          jax.tree.map(np.asarray, params), what,
                          share=BF16_RTOL if bf16 else SHARE, base=tree)
        got = opt_state_to_numpy(state)
        assert_tree_close(got["m"], j_state["m"], what + " m",
                          rtol=BF16_RTOL if bf16 else RTOL,
                          share=BF16_RTOL / 2 if bf16 else SHARE)
        assert_tree_close(got["v"], j_state["v"], what + " v")


@pytest.mark.parametrize("step", [0, 4, 9, 10, 11, 55, 99, 100, 150])
def test_schedule_matches_reference(step):
    """Warm-up, its last step, the cosine's start, middle and end, and past
    the end (held at min_lr_frac), in f32."""
    cfg = OptConfig(lr=3e-3, warmup_steps=10, total_steps=100)
    got = schedule(cfg, torch.tensor(step, dtype=torch.int32))
    want = JA.schedule(j_cfg(cfg), jnp.int32(step))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-7)


def test_global_norm_and_clip_scale():
    g = {"a": torch.full((4,), 100.0), "b": torch.zeros(3, 2)}
    assert float(global_norm(g.values())) == pytest.approx(200.0)
    want = JA.global_norm({"a": jnp.full((4,), 100.0),
                           "b": jnp.zeros((3, 2))})
    assert float(global_norm(g.values())) == float(want)


def test_nan_step_poisons_v_as_the_reference_does():
    """A NaN gradient leaves the parameters and ``m`` alone, writes NaN
    into ``v`` and advances ``step`` (in both packages); the next finite
    step then makes every parameter of the poisoned leaf NaN in both."""
    arch = "internlm2_1_8b"
    for v_mode in ("full", "factored"):
        cfg = OptConfig(v_mode=v_mode)
        jcfg = j_cfg(cfg)
        tcfg = get_smoke(arch)
        params, tree = reference_params(arch)
        j_state = JA.init_opt_state(params, jcfg)
        model = lm_params_from_numpy(tcfg, tree, device="cpu")
        state = init_opt_state(model, cfg, device="cpu")
        bad = grads_tree(tree, seed=7, scale=1e-3)
        bad["final_norm"] = bad["final_norm"].copy()
        bad["final_norm"][0] = np.nan
        params1, j_state, j_stats = _j_apply(jcfg)(params, bad, j_state)
        stats = apply_updates(model, port_grads(tcfg, bad), state, cfg)
        assert not bool(stats["finite"]) and not bool(j_stats["finite"])
        assert int(state["step"]) == int(j_state["step"]) == 1
        for name, p in model.named_parameters():  # unchanged, bit for bit
            p0 = lm_params_from_numpy(tcfg, tree, device="cpu") \
                .get_parameter(name)
            assert torch.equal(p, p0), name
        assert all(not bool(m.any()) for m in state["m"].values())
        v_port = state["v"]["final_norm"]["v"]
        v_ref = np.asarray(j_state["v"]["final_norm"]["v"])
        assert bool(torch.isnan(v_port[0])) and np.isnan(v_ref[0])
        assert not bool(torch.isnan(v_port[1:]).any())
        good = grads_tree(tree, seed=8, scale=1e-3)
        params2, j_state, _ = _j_apply(jcfg)(params1, good, j_state)
        stats = apply_updates(model, port_grads(tcfg, good), state, cfg)
        assert bool(stats["finite"])
        assert bool(torch.isnan(model.final_norm[0]))
        assert np.isnan(np.asarray(params2["final_norm"])[0])
        assert not bool(torch.isnan(model.final_norm[1:]).any())
        assert_tree_close(lm_params_to_numpy(model),
                          jax.tree.map(np.asarray, params2), v_mode,
                          base=tree)


def test_entry_points_run_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model = lm_params_from_numpy(get_smoke("internlm2_1_8b"),
                                 reference_params("internlm2_1_8b")[1],
                                 device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_opt_state(model, OptConfig())


def test_state_converter_refuses_another_layout():
    """``opt_state_from_numpy`` takes only the layout ``init_opt_state``
    gives, as a checkpoint's restore does: a full ``v`` where the config
    factors it (a missing leaf), an f32 ``m`` where it is bf16 (a dtype),
    a leaf of another shape."""
    cfg = OptConfig(m_dtype="bfloat16", v_mode="factored")
    params, tree = reference_params("internlm2_1_8b")
    model = lm_params_from_numpy(get_smoke("internlm2_1_8b"), tree,
                                 device="cpu")
    good = jax.tree.map(np.asarray, JA.init_opt_state(params, j_cfg(cfg)))
    assert opt_state_from_numpy(cfg, good, model, device="cpu")["m"][
        "embed"].dtype == torch.bfloat16
    full = jax.tree.map(np.asarray, JA.init_opt_state(
        params, j_cfg(OptConfig(m_dtype="bfloat16"))))
    with pytest.raises(KeyError, match="v/embed"):
        opt_state_from_numpy(cfg, full, model, device="cpu")
    f32 = jax.tree.map(np.asarray, JA.init_opt_state(
        params, j_cfg(OptConfig(v_mode="factored"))))
    with pytest.raises(TypeError, match="m/embed"):
        opt_state_from_numpy(cfg, f32, model, device="cpu")
    bad = jax.tree.map(lambda a: a, good)
    bad["m"]["final_norm"] = np.zeros(3, good["m"]["final_norm"].dtype)
    with pytest.raises(ValueError, match="m/final_norm"):
        opt_state_from_numpy(cfg, bad, model, device="cpu")
