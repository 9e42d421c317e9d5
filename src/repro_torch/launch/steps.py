"""Entry-point builders for the sharded training and serving steps, and
abstract inputs (counterpart of ``repro.launch.steps``).

The ``abstract_*`` functions build shapes on the meta device (no storage),
as the reference's ``jax.eval_shape`` does. :func:`build_step` is the
counterpart of ``build_cell`` without the lowering: it returns the step
itself, a plain function over the placement it names, for the rank that
calls it. Where the reference lowers and compiles a cell for a mesh the
host does not hold, ``launch.dryrun`` runs this step once as one rank of
a fake world over fake tensors (``make_production_mesh``), which counts
the same things without storage.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec
from repro_torch.launch.mesh import Mesh
from repro_torch.models import (
    decode_step,
    forward_logits,
    init_params,
    prefill,
)
from repro_torch.models.layers import ShardingCtx
from repro_torch.models.transformer import cache_pad
from repro_torch.optim.adamw import OptConfig, apply_updates, init_opt_state
from repro_torch.runtime.train_loop import data_axes, value_and_grad
from repro_torch.sharding.partition import add_fsdp, param_specs

BF16 = torch.bfloat16

# params whose TP-sharded residency exceeds this use FSDP over the data axis
FSDP_BYTES_PER_CHIP = 6 << 30
ACT_BUDGET_BYTES = 6 << 30  # per-chip activation budget driving microbatching


def _param_bytes(params_shape) -> int:
    return sum(p.numel() * p.element_size() for p in params_shape.parameters())


def abstract_params(cfg: ModelConfig, dtype=BF16):
    """The model's shapes on the meta device."""
    return init_params(cfg, dtype=dtype, device="meta")


def abstract_opt_state(cfg: ModelConfig, opt_cfg: OptConfig, params_shape):
    return init_opt_state(params_shape, opt_cfg, device="meta")


def _meta(*shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def abstract_batch(cfg: ModelConfig, spec: ShapeSpec, with_labels: bool):
    B, S = spec.global_batch, spec.seq_len
    batch: dict[str, Any] = {}
    if cfg.embeddings_in:
        batch["embeds"] = _meta(B, S, cfg.d_model, dtype=BF16)
    else:
        batch["tokens"] = _meta(B, S, dtype=torch.int32)
    if cfg.n_vision_tokens:
        batch["vision"] = _meta(B, cfg.n_vision_tokens, cfg.d_model,
                                dtype=BF16)
    if with_labels:
        batch["labels"] = _meta(B, S, dtype=torch.int32)
    return batch


def abstract_cache(cfg: ModelConfig, batch: int, prefix_len: int):
    """The port's decode cache (one dict a unit) on the meta device."""
    smax = prefix_len + cache_pad(cfg)
    unit = {}
    for j, (mixer, _ffn) in enumerate(cfg.pattern):
        if mixer == "attn":
            unit[f"l{j}"] = {nm: _meta(batch, smax, cfg.n_kv, cfg.d_head,
                                       dtype=BF16) for nm in ("k", "v")}
        elif mixer == "xattn":
            unit[f"l{j}"] = {nm: _meta(batch, cfg.n_vision_tokens, cfg.n_kv,
                                       cfg.d_head, dtype=BF16)
                             for nm in ("xk", "xv")}
        elif mixer == "mamba":
            k, gn = cfg.ssm_conv - 1, cfg.ssm_groups * cfg.ssm_state
            unit[f"l{j}"] = {
                "convx": _meta(batch, k, cfg.d_inner, dtype=BF16),
                "convb": _meta(batch, k, gn, dtype=BF16),
                "convc": _meta(batch, k, gn, dtype=BF16),
                "ssm": _meta(batch, cfg.ssm_heads, cfg.ssm_state,
                             cfg.ssm_head_dim, dtype=torch.float32)}
    return [dict(unit) for _ in range(cfg.n_units)]


def input_specs(cfg: ModelConfig, shape_name: str):
    """Meta stand-ins for every model input of the given shape cell."""
    spec = SHAPES[shape_name]
    if spec.kind == "train":
        return abstract_batch(cfg, spec, with_labels=True)
    if spec.kind == "prefill":
        return abstract_batch(cfg, spec, with_labels=False)
    return {"tokens": _meta(spec.global_batch, 1, dtype=torch.int32),
            "cache": abstract_cache(cfg, spec.global_batch, spec.seq_len),
            "pos": _meta(dtype=torch.int32)}


def auto_microbatches(cfg: ModelConfig, spec: ShapeSpec, dp_size: int,
                      tp_size: int) -> int:
    """Smallest power-of-two accumulation count whose per-microbatch residual
    stack (+ transient factor 3x) fits the activation budget."""
    b_loc = max(spec.global_batch // dp_size, 1)
    act = cfg.n_layers * b_loc * spec.seq_len * cfg.d_model * 2 * 3 // tp_size
    a = 1
    while act // a > ACT_BUDGET_BYTES and a < max(spec.global_batch // dp_size, 1):
        a *= 2
    return a


@dataclasses.dataclass
class Step:
    """One (arch x shape x mesh) step: ``fn`` as the reference's jitted
    function takes its arguments (the model placed by ``param_specs``
    first: ``partition.place_params``), with the placement it runs on."""

    name: str
    fn: Callable
    param_specs: dict
    fsdp: bool
    microbatches: int = 1
    opt_cfg: OptConfig | None = None


def build_step(cfg: ModelConfig, shape_name: str, mesh: Mesh,
               opt_cfg: OptConfig | None = None, remat: bool = True,
               fsdp: bool | str = "auto", microbatches: int | str = "auto",
               remat_policy: str = "full") -> Step:
    """The step of one cell on this rank of ``mesh``. Train:
    ``fn(params, opt_state, batch) -> (loss, gnorm)``, the loss and
    gradients over A microbatches (an f32 accumulator, ``loss / A``, the
    gradients cast back to the parameters' dtype), then one AdamW step in
    place; prefill: ``fn(params, batch)`` (an encoder's forward logits);
    decode: ``fn(params, tokens, cache, pos)``. FSDP ``"auto"`` shards over
    "data" when the bf16 parameters over the model axis exceed
    ``FSDP_BYTES_PER_CHIP``."""
    spec = SHAPES[shape_name]
    dp = data_axes(mesh)
    shd = ShardingCtx(dp=dp, tp="model", mesh=mesh)
    pshape = abstract_params(cfg)
    pspecs = param_specs(cfg, pshape)
    tp_size = mesh.shape["model"]
    if fsdp == "auto":
        fsdp = _param_bytes(pshape) // tp_size > FSDP_BYTES_PER_CHIP
    if fsdp:
        pspecs = add_fsdp(pspecs, pshape, axis="data", size=mesh.shape["data"])
    name = f"{cfg.name}/{shape_name}"

    if spec.kind == "train":
        opt_cfg = opt_cfg or OptConfig(
            m_dtype="bfloat16", v_mode="factored", total_steps=10000)
        if microbatches == "auto":
            microbatches = auto_microbatches(cfg, spec, mesh.size(dp),
                                             tp_size)
        A = max(int(microbatches), 1)

        def step(params, opt_state, batch):
            if A == 1:
                loss, grads = value_and_grad(cfg, params, batch, shd, remat,
                                             remat_policy)
            else:
                # gradient accumulation over A microbatches (f32)
                rows = next(iter(batch.values())).shape[0] // A
                loss, gsum = 0.0, None
                for i in range(A):
                    mb = {k: v[i * rows:(i + 1) * rows]
                          for k, v in batch.items()}
                    lo, g = value_and_grad(cfg, params, mb, shd, remat,
                                           remat_policy)
                    loss = loss + lo
                    if gsum is None:
                        gsum = {k: x.to(torch.float32) for k, x in g.items()}
                    else:
                        for k, x in g.items():
                            gsum[k] += x.to(torch.float32)
                loss = loss / A
                grads = {k: (gsum[k] / A).to(p.dtype)
                         for k, p in params.named_parameters()}
            stats = apply_updates(params, grads, opt_state, opt_cfg)
            return loss, stats["gnorm"]

        return Step(name, step, pspecs, bool(fsdp), A, opt_cfg)

    if spec.kind == "prefill":
        if cfg.encoder_only:
            # encoders have no KV cache: "prefill" = batched encode forward
            def pre(params, batch):
                return forward_logits(cfg, params, batch, shd)
        else:
            def pre(params, batch):
                return prefill(cfg, params, batch, shd)
        return Step(name, pre, pspecs, bool(fsdp))

    def serve_step(params, tokens, cache, pos):
        return decode_step(cfg, params, tokens, cache, pos, shd)

    return Step(name, serve_step, pspecs, bool(fsdp))

