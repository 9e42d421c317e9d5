"""The port's partition rules against the reference's, leaf for leaf, on
the CPU: ``param_specs``, ``add_fsdp`` (sizes 2, 4, 16), ``batch_specs``,
``cache_specs`` and ``state_specs_for`` for all ten configs at full size
(shapes only: the reference's ``jax.eval_shape``, the port's meta device)
and at smoke size; ``plan_mesh`` and ``auto_microbatches`` on a grid of
counts; the FSDP "auto" byte count of ``build_step``.

The reference's rules read only ``mesh.shape``, so they run here on a
stand-in mesh of the sizes under test; so do the port's (a ``Mesh`` with
no groups). The reference's unit-stack axis is the port's ``Spec.unit``:
at size 2, 4 and 16, FSDP gives it to "data" in ``qwen25-14b``'s and
``hubert-xlarge``'s ``attn/bq``, ``bk``, ``bv`` (48, .) and ``mamba2-1.3b``'s
conv weights and biases and ``norm``; this file asserts that it does.
"""
import functools
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.configs import get_smoke as j_smoke
from repro.configs.base import SHAPES as J_SHAPES
from repro.launch import steps as JS
from repro.optim.adamw import OptConfig as JOpt
from repro.optim.adamw import state_specs_for as j_state_specs
from repro.runtime import elastic as JE
from repro.sharding import partition as JP
from repro_torch.configs import ARCHS, SHAPES, get_config, get_smoke
from repro_torch.launch import steps as PS
from repro_torch.launch.mesh import Mesh
from repro_torch.optim.adamw import OptConfig, state_specs_for
from repro_torch.runtime import elastic as PE
from repro_torch.sharding import partition as PP

SIZES = ("full", "smoke")
MESHES = [(1, 1), (2, 2), (4, 1), (1, 4), (16, 16), (3, 2)]


def _cfgs(arch, size):
    if size == "full":
        return j_config(arch), get_config(arch)
    return j_smoke(arch), get_smoke(arch)


def _norm(spec) -> tuple:
    """A spec as a tuple, 1-tuples of axes as the name (PartitionSpec's
    own normal form)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else
                 (tuple(e) if isinstance(e, tuple) else e) for e in spec)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _jflat(tree):
    """A reference tree of specs or shapes by '/'-joined path."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(str(p.key) for p in path): leaf for path, leaf in leaves}


@functools.lru_cache(maxsize=None)
def shapes(arch, size):
    jc, pc = _cfgs(arch, size)
    return JS.abstract_params(jc), PS.abstract_params(pc)


def port_mesh(dp, tp):
    return Mesh(shape={"data": dp, "model": tp}, rank=0,
                coords={"data": 0, "model": 0}, groups={}, world=None,
                device=torch.device("cpu"))


def ref_mesh(dp, tp):
    return SimpleNamespace(shape={"data": dp, "model": tp})


def _port_stacked(specs):
    return {path: PP.stacked(path, s) for path, s in specs.items()}


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_and_fsdp_match_reference(arch, size):
    jshape, pshape = shapes(arch, size)
    jc, pc = _cfgs(arch, size)
    jspecs = JP.param_specs(jc, jshape)
    pspecs = PP.param_specs(pc, pshape)
    want = {k: _norm(v) for k, v in _jflat(jspecs).items()}
    assert _port_stacked(pspecs) == want
    assert PP.leaf_shapes(pshape) == {
        k: tuple(v.shape) for k, v in _jflat(jshape).items()}
    for n in (2, 4, 16):
        jf = JP.add_fsdp(jspecs, jshape, axis="data", size=n)
        pf = PP.add_fsdp(pspecs, pshape, axis="data", size=n)
        assert _port_stacked(pf) == {
            k: _norm(v) for k, v in _jflat(jf).items()}, n
        for path, spec in pf.items():  # a stack axis lives in Spec.unit
            assert "data" not in spec.dims or spec.unit is None, path


def test_fsdp_gives_the_unit_axis_to_data_where_the_reference_does():
    for arch, leaves in {
            "qwen25_14b": {"attn/bq", "attn/bk", "attn/bv"},
            "hubert_xlarge": {"attn/bq", "attn/bk", "attn/bv"},
            "mamba2_1_3b": {"mamba/" + n for n in (
                "conv_wx", "conv_wb", "conv_wc", "conv_bx", "conv_bb",
                "conv_bc", "norm")}}.items():
        _, pshape = shapes(arch, "full")
        specs = PP.param_specs(get_config(arch), pshape)
        for n in (2, 4, 16):
            fsdp = PP.add_fsdp(specs, pshape, size=n)
            got = {p.split("/", 2)[2] for p, s in fsdp.items()
                   if s.unit == "data"}
            assert got == leaves, (arch, n, got)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_match_reference(arch, size):
    jc, pc = _cfgs(arch, size)
    for dp, tp in MESHES:
        jm, pm = ref_mesh(dp, tp), port_mesh(dp, tp)
        for name, spec in SHAPES.items():
            if size == "smoke":  # the smoke configs' own small cells
                spec = type(spec)(name, 64, 4 if spec.kind == "train" else 3,
                                  spec.kind)
            jspec = J_SHAPES[name].__class__(name, spec.seq_len,
                                             spec.global_batch, spec.kind)
            if spec.kind != "decode":
                jb = JS.abstract_batch(jc, jspec, spec.kind == "train")
                pb = PS.abstract_batch(pc, spec, spec.kind == "train")
                want = {k: _norm(v) for k, v in
                        JP.batch_specs(jc, jb, ("data",), jm).items()}
                got = {k: _norm(v) for k, v in
                       PP.batch_specs(pc, pb, ("data",), pm).items()}
                assert got == want, (name, dp, tp)
                continue
            if jc.encoder_only or (size == "full" and spec.seq_len > 40000):
                continue  # no decode cache; the 500k cache is the 32k's
            jcache = JS.abstract_cache(jc, spec.global_batch, spec.seq_len)
            pcache = PS.abstract_cache(pc, spec.global_batch, spec.seq_len)
            want = {k: _norm(v) for k, v in _jflat(
                JP.cache_specs(jc, jcache, ("data",), jm)).items()}
            got = {f"{ln}/{nm}": _norm((None,) + tuple(sp))
                   for ln, e in PP.cache_specs(
                       pc, pcache, ("data",), pm).items()
                   for nm, sp in e.items()}
            assert got == want, (name, dp, tp)
            jshapes = {k: tuple(v.shape) for k, v in _jflat(jcache).items()}
            assert {f"{ln}/{nm}": (len(pcache),) + tuple(t.shape)
                    for ln, e in pcache[0].items()
                    for nm, t in e.items()} == jshapes


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_state_specs_match_reference(arch, size):
    jshape, pshape = shapes(arch, size)
    jc, pc = _cfgs(arch, size)
    for v_mode in ("factored", "full"):
        jo = JOpt(m_dtype="bfloat16", v_mode=v_mode)
        po = OptConfig(m_dtype="bfloat16", v_mode=v_mode)
        jstate = JS.abstract_opt_state(jc, jo, jshape)
        pstate = PS.abstract_opt_state(pc, po, pshape)
        for fsdp in (None, 4):
            jspecs = JP.param_specs(jc, jshape)
            pspecs = PP.param_specs(pc, pshape)
            if fsdp:
                jspecs = JP.add_fsdp(jspecs, jshape, size=fsdp)
                pspecs = PP.add_fsdp(pspecs, pshape, size=fsdp)
            want = {k: _norm(v) for k, v in
                    _jflat(j_state_specs(jstate, jspecs)).items()}
            got = {k: _norm(v) for k, v in
                   _flat(state_specs_for(pstate, pspecs)).items()}
            assert got == want, (v_mode, fsdp)


def test_plan_mesh_matches_reference_on_a_grid():
    for n in range(1, 21):
        for want_tp in (1, 2, 4, 8, 16):
            for batch in (None, 1, 4, 6, 9, 256):
                j = JE.plan_mesh(n, want_tp, batch)
                p = PE.plan_mesh(n, want_tp, batch)
                assert (p.mesh_shape, p.axis_names, p.dp_degree, p.tp_degree,
                        p.dropped_devices) == (
                    j.mesh_shape, j.axis_names, j.dp_degree, j.tp_degree,
                    j.dropped_devices), (n, want_tp, batch)
    assert PE.plan_mesh(3, want_tp=2, global_batch=4).mesh_shape == (2, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_auto_microbatches_and_fsdp_bytes_match_reference(arch):
    jshape, pshape = shapes(arch, "full")
    assert PS._param_bytes(pshape) == JS._param_bytes(jshape)
    jc, pc = j_config(arch), get_config(arch)
    for name, spec in SHAPES.items():
        for dp in (1, 2, 3, 4, 16, 32):
            for tp in (1, 2, 16):
                assert PS.auto_microbatches(pc, spec, dp, tp) == \
                    JS.auto_microbatches(jc, J_SHAPES[name], dp, tp)
    assert (PS.FSDP_BYTES_PER_CHIP, PS.ACT_BUDGET_BYTES) == (
        JS.FSDP_BYTES_PER_CHIP, JS.ACT_BUDGET_BYTES)


def test_input_specs_match_reference():
    for arch in ("internlm2_1_8b", "llama32_vision_90b", "hubert_xlarge",
                 "jamba15_large_398b"):
        jc, pc = j_config(arch), get_config(arch)
        for name in SHAPES:
            if name == "long_500k" or (
                    jc.encoder_only and SHAPES[name].kind == "decode"):
                continue
            want = JS.input_specs(jc, name)
            got = PS.input_specs(pc, name)
            cache_w, cache_g = want.pop("cache", None), got.pop("cache", None)
            assert {k: tuple(v.shape) for k, v in got.items()} == {
                k: tuple(v.shape) for k, v in want.items()}
            if cache_w is not None:
                assert {f"{ln}/{nm}": (len(cache_g),) + tuple(t.shape)
                        for ln, e in cache_g[0].items()
                        for nm, t in e.items()} == {
                    k: tuple(v.shape) for k, v in _jflat(cache_w).items()}
            assert all(v.device.type == "meta" for v in got.values())
    np.testing.assert_equal(len(SHAPES), len(J_SHAPES))
