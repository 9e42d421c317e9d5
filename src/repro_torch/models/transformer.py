"""Model assembly and the serving entry points for every assigned
architecture family (dense, MoE, SSM, hybrid, VLM-backbone, encoder):
counterpart of ``repro.models.transformer``.

The model is ``n_units`` repetitions of ``cfg.pattern``. The reference scans
over stacked unit parameters; here the units are an ``nn.ModuleList`` run by
a Python loop, each unit holding its layers as ``l0``, ``l1``, ... as the
reference's unit dict does. Heterogeneous stacks (jamba's 7:1 mamba:attn
with interleaved MoE, llama-vision's every-5th cross-attention) are
expressed inside the unit.

Serving: ``prefill`` runs the prompt and returns the decode cache, a list
with one dict per unit (``cache[u]["l{j}"]``), each attention layer's K / V
preallocated as (B, S + cache_pad, K, dh) in the activation dtype;
``decode_step`` writes slot ``pos`` of it in place. ``interop``'s
``lm_cache_to_numpy`` / ``lm_cache_from_numpy`` convert it to and from the
reference's stacked (U, B, ...) layout.

Training: ``train_loss`` runs the units with per-unit rematerialisation
(``torch.utils.checkpoint``; ``REMAT_POLICIES``) and computes the LM head
and the cross-entropy in sequence chunks under remat
(``chunked_ce_loss``), so the (B, S, V) logits never exist. The reference
also checkpoints each layer of a multi-layer unit (jamba, llama-vision)
inside the unit's remat; that changes only peak memory, and the port
does not nest.

On a mesh (``shd``, a ``layers.ShardingCtx``; the model placed by
``sharding.partition.place_params``) every entry point takes the global
batch and computes the rank's block of it (``batch_specs``): a unit
gathers its weights' blocks before use and frees them after (each
weight's gradient lands back on its block, summed over "data"); the
activations between units are held as the rank's S / tp slice of the
sequence (the reference's sequence-parallel carry), gathered at a unit's
start and sliced at its end, so remat saves the slice only; the loss is
the mean over "data" of the blocks' means; the MoE takes the
expert-parallel path where the reference's gate lets it. Logits come back
whole; a decode cache is a :class:`PlacedCache` of the rank's blocks
(``cache_specs``). ``shd=None`` is the single-device path.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.config import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.layers import ShardingCtx
from repro_torch.sharding import comm
from repro_torch.sharding.partition import Gathered, batch_specs, cache_specs


class Layer(nn.Module):
    """One (mixer, ffn) entry of the pattern: ``norm1`` and the mixer under
    its name (``attn``, ``xattn`` or ``mamba``); with an FFN, ``norm2`` and
    ``mlp``, ``moe``, or ``moe`` and ``dense`` (arctic's dense residual)."""

    def __init__(self, cfg: ModelConfig, mixer: str, ffn: str,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.mixer, self.ffn = mixer, ffn
        self.norm1 = L._param((cfg.d_model,), dtype, device)
        if mixer in ("attn", "xattn"):
            setattr(self, mixer, L.Attention(cfg, dtype, device))
        elif mixer == "mamba":
            self.mamba = L.Mamba(cfg, dtype, device)
        else:
            raise ValueError(mixer)
        if ffn != "none":
            self.norm2 = L._param((cfg.d_model,), dtype, device)
            if ffn == "mlp":
                self.mlp = L.MLP(cfg.d_model, cfg.d_ff, dtype, device)
            elif ffn == "moe":
                self.moe = L.MoE(cfg, dtype, device)
            elif ffn == "moe_dense":
                self.moe = L.MoE(cfg, dtype, device)
                self.dense = L.MLP(cfg.d_model, cfg.dense_d_ff, dtype, device)
            else:
                raise ValueError(ffn)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        self.norm1.fill_(1)
        if self.ffn != "none":
            self.norm2.fill_(1)
        for m in self.children():
            m.reset_parameters(gen)


class LM(nn.Module):
    """``embed`` (vocab_pad, D) unless the input is embeddings; ``units``;
    ``final_norm``; ``lm_head`` (D, vocab_pad) unless tied to the embedding."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        D = cfg.d_model
        if not cfg.embeddings_in:
            self.embed = L._param((cfg.vocab_pad, D), dtype, device)
        self.units = nn.ModuleList(
            _init_unit(cfg, dtype, device) for _ in range(cfg.n_units))
        self.final_norm = L._param((D,), dtype, device)
        if not cfg.tie_embeddings or cfg.embeddings_in:
            self.lm_head = L._param((D, cfg.vocab_pad), dtype, device)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        cfg = self.cfg
        if not cfg.embeddings_in:
            L._dense_(self.embed, gen, scale=0.02)
        for unit in self.units:
            for layer in unit.children():
                layer.reset_parameters(gen)
        self.final_norm.fill_(1)
        if hasattr(self, "lm_head"):
            L._dense_(self.lm_head, gen)  # / sqrt(d_model)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _init_layer(cfg: ModelConfig, mixer: str, ffn: str, dtype,
                device) -> Layer:
    return Layer(cfg, mixer, ffn, dtype, device)


def _init_unit(cfg: ModelConfig, dtype, device) -> nn.Module:
    unit = nn.Module()
    for j, (mixer, ffn) in enumerate(cfg.pattern):
        unit.add_module(f"l{j}", _init_layer(cfg, mixer, ffn, dtype, device))
    return unit


def init_params(cfg: ModelConfig, *, generator: torch.Generator | None = None,
                seed: int = 0, dtype=torch.float32, device=None) -> LM:
    """The model with random weights, from the reference's distributions:
    projections normal / sqrt(fan-in) drawn in f32 then cast, conv weights
    normal * 0.5, ``A_log = log U(1, 16)``, norms and ``D`` ones, biases
    zero, the embedding normal * 0.02 and the LM head normal / sqrt(D). The
    router, ``A_log``, ``D`` and ``dt_bias`` stay f32 in every dtype.

    ``generator`` (a ``torch.Generator`` on ``device``) or ``seed`` gives the
    draws; they cannot equal JAX's threefry bits, so tests carry the
    reference's weights across with ``interop.lm_params_from_numpy``.
    ``device=None`` means the CUDA card (raises without one); ``"meta"``
    builds the shapes with no storage and draws nothing.
    """
    if str(device) == "meta":
        return LM(cfg, dtype, torch.device("meta"))
    dev = resolve_device(device)
    model = LM(cfg, dtype, dev)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    model.reset_parameters(gen)
    return model


def param_count(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())


def leaf_paths(params: nn.Module) -> dict[str, list[str]]:
    """The reference's parameter leaves, in the port's names: ``{leaf
    path: [parameter names]}``. A leaf path is the reference's
    ``'/'``-joined key (``units/l0/attn/wq``, ``embed``); a ``units/...``
    leaf is stacked over the units by the reference's vmap, so it maps to
    ``units.<u>.l0.attn.wq`` for every unit u in order, and any other leaf
    to its one parameter."""
    paths: dict[str, list[str]] = {}
    for name, _ in params.named_parameters():
        parts = name.split(".")
        if parts[0] == "units":
            parts = ["units"] + parts[2:]
        paths.setdefault("/".join(parts), []).append(name)
    return paths


# --------------------------------------------------------------------------
# unit application (full sequence)
# --------------------------------------------------------------------------

def _apply_layer(cfg: ModelConfig, mixer: str, ffn: str, lp: Layer, x,
                 positions, vision, collect_cache: bool,
                 shd: ShardingCtx | None = None):
    cache = None
    h = L.rms_norm(x, lp.norm1, cfg.rms_eps)
    if mixer == "attn":
        if collect_cache:
            q = L._project_q(cfg, lp.attn, h)
            k, v = L._project_kv(cfg, lp.attn, h)
            cache = {"k": L.rope(k, positions, cfg.rope_theta), "v": v}
            q = L.rope(q, positions, cfg.rope_theta)
            o = L._sdpa(cfg, q, cache["k"], v, positions, positions,
                        cfg.causal)
            mx = o @ lp.attn.wo
        else:
            mx = L.apply_attention(cfg, lp.attn, h, positions,
                                   causal=cfg.causal)
    elif mixer == "xattn":
        if collect_cache:
            xk, xv = L._project_kv(cfg, lp.xattn, vision)
            cache = {"xk": xk, "xv": xv}
        mx = L.apply_attention(cfg, lp.xattn, h, positions, kv_source=vision)
    elif mixer == "mamba":
        if collect_cache:
            mx, cache = _mamba_with_state(cfg, lp.mamba, h)
        else:
            mx = L.apply_mamba(cfg, lp.mamba, h)
    else:
        raise ValueError(mixer)
    x = x + mx
    if ffn != "none":
        x = x + _apply_ffn(cfg, ffn, lp, L.rms_norm(x, lp.norm2, cfg.rms_eps),
                           shd)
    return x, cache


def _apply_ffn(cfg: ModelConfig, ffn: str, lp: Layer, h2,
               shd: ShardingCtx | None = None):
    if ffn == "mlp":
        return L.apply_mlp(lp.mlp, h2)
    if ffn == "moe":
        return L.apply_moe(cfg, lp.moe, h2, shd)
    # moe_dense: arctic's dense residual in parallel with the MoE
    return L.apply_moe(cfg, lp.moe, h2, shd) + L.apply_mlp(lp.dense, h2)


def _apply_unit(cfg: ModelConfig, up: nn.Module, x, positions, vision,
                collect_cache: bool, shd: ShardingCtx | None = None):
    caches = {}
    for j, (mixer, ffn) in enumerate(cfg.pattern):
        x, cache = _apply_layer(cfg, mixer, ffn, getattr(up, f"l{j}"), x,
                                positions, vision, collect_cache, shd)
        if cache is not None:
            caches[f"l{j}"] = cache
    return x, caches


def _mamba_with_state(cfg, p, h):
    """Full-sequence mamba that also returns the decode-ready state: the
    last ssm_conv - 1 PRE-conv inputs of each segment and the final SSM
    state (one pass; the reference reruns the projections for them)."""
    S = h.shape[1]
    k = cfg.ssm_conv - 1
    out, (x0, B0, C0), state = L._ssd(cfg, p, h)
    return out, {"convx": x0[:, S - k:, :].clone(),
                 "convb": B0[:, S - k:, :].clone(),
                 "convc": C0[:, S - k:, :].clone(), "ssm": state}


def _mamba_final_state(cfg, p, h):
    """Final SSM state (B, H, N, P) after the full sequence."""
    return L._ssd(cfg, p, h)[2]


# --------------------------------------------------------------------------
# forward passes
# --------------------------------------------------------------------------

def _embed_in(cfg, params: LM, batch, shd: ShardingCtx | None = None):
    """The input activations; on a mesh (``batch`` already the rank's
    block, ``params`` the model's gathered view) held as the rank's slice
    of the sequence (:func:`_seq_block`)."""
    if cfg.embeddings_in:
        x = torch.as_tensor(batch["embeds"], device=params.final_norm.device)
    else:
        tokens = torch.as_tensor(batch["tokens"], device=params.embed.device)
        x = _embed_tokens(params, tokens)
    return _seq_block(x, shd)


def _sequence_parallel(shd: ShardingCtx | None, seq: int) -> bool:
    """Whether activations between units are held as the rank's slice of
    the sequence: the reference pins them to (dp, tp, None) when S is a
    multiple of 16."""
    return (shd is not None and shd.tp_size > 1 and seq % 16 == 0
            and seq % shd.tp_size == 0)


def _seq_block(x, shd: ShardingCtx | None):
    if not _sequence_parallel(shd, x.shape[1]):
        return x
    return comm.slice_block(shd.mesh, shd.tp, x, 1)


def _seq_whole(x, shd: ShardingCtx | None, seq: int):
    if not _sequence_parallel(shd, seq):
        return x
    return comm.gather_blocks(shd.mesh, shd.tp, x, 1)


def _local(shd: ShardingCtx | None, batch: dict):
    """(shd with ``split`` set, the rank's block of ``batch`` as
    ``batch_specs`` places it) for the global ``batch``."""
    if shd is None:
        return None, batch
    specs = batch_specs(None, batch, shd.dp, shd.mesh)
    lead = next(iter(batch.values())).shape[0]
    split = lead % shd.dp_size == 0
    mesh = shd.mesh
    out = {}
    for name, leaf in batch.items():
        leaf = torch.as_tensor(leaf, device=mesh.device)
        out[name] = comm.place(mesh, leaf, specs[name]) if split and any(
            specs[name]) else leaf
    return dataclasses.replace(shd, split=split), out


def _gather_batch(x, shd: ShardingCtx | None):
    """The whole batch of a per-block output (logits)."""
    if shd is None or not shd.split:
        return x
    return comm.all_gather(shd.mesh, "data", x, 0)


def _embed_tokens(params: LM, tokens):
    flat = torch.index_select(params.embed, 0, tokens.reshape(-1))
    return flat.reshape(*tokens.shape, params.embed.shape[1])


def _vision(params: LM, batch):
    vision = batch.get("vision")
    if vision is None:
        return None
    return torch.as_tensor(vision, device=params.final_norm.device)


def _weights(params: LM, shd: ShardingCtx | None):
    """What the forward reads the model's own leaves through: the model,
    or on a mesh its gathered view."""
    return params if shd is None else Gathered(params, shd.mesh)


def _lm_head(cfg, params: LM):
    if hasattr(params, "lm_head"):
        return params.lm_head
    return params.embed.T


def _save_products(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep the output of every ``aten.mm`` and
    recompute the rest. A product ``x @ W`` of activations and a weight
    (the projections, the MLP, the router) reaches ``mm`` with its batch
    and sequence axes folded into rows: the reference's dot with no batch
    dimensions. The attention einsums, the SSD's chunk products and the
    experts' products carry batch dimensions and reach ``bmm``, which the
    reference's ``dots_with_no_batch_dims_saveable`` recomputes too."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


# the ``context_fn`` of each unit's checkpoint
REMAT_POLICIES = {
    # full: keep each unit's input only and recompute the unit in the
    # backward pass (4/3 of the forward products)
    "full": noop_context_fn,
    # dots: also keep the products with no batch dimensions, recompute the
    # elementwise work and the batched products
    "dots": functools.partial(create_selective_checkpoint_contexts,
                              _save_products),
}


def _stack(cfg, params: LM, x, positions, vision, remat: bool = False,
           remat_policy: str = "full", shd: ShardingCtx | None = None):
    """The units in order, no cache (the reference's ``_stack_scan``); with
    ``remat`` each unit runs under ``torch.utils.checkpoint`` with
    ``REMAT_POLICIES[remat_policy]``. On a mesh ``x`` comes and goes as
    the rank's slice of the sequence, and each unit gathers it and its
    weights at its start (so remat keeps the slice and no weight)."""
    context_fn = REMAT_POLICIES[remat_policy]
    seq = positions.shape[0]
    for up in params.units:
        def unit_fn(h, up=up):
            if shd is None:
                return _apply_unit(cfg, up, h, positions, vision, False)[0]
            h = _seq_whole(h, shd, seq)
            y = _apply_unit(cfg, Gathered(up, shd.mesh), h, positions,
                            vision, False, shd)[0]
            return _seq_block(y, shd)

        x = (checkpoint(unit_fn, x, use_reentrant=False,
                        context_fn=context_fn) if remat else unit_fn(x))
    return _seq_whole(x, shd, seq)


def _ce_chunk(cfg, hc, lm_head, lc):
    """Sum over one chunk of logsumexp - gold, the logits (B, chunk, V) in
    f32 with the vocabulary padding masked."""
    logits = (hc @ lm_head).to(torch.float32)
    if logits.shape[-1] != cfg.vocab:  # mask vocab padding
        pad = torch.arange(logits.shape[-1], device=logits.device) >= cfg.vocab
        logits = logits.masked_fill(pad, L.MASKED)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc[..., None])[..., 0]
    return torch.sum(logz - gold)


def chunked_ce_loss(cfg, h, lm_head, labels, shd: ShardingCtx | None = None,
                    chunk: int | None = None):
    """Mean next-token cross-entropy; the logits are computed a sequence
    chunk at a time (``cfg.ce_chunk`` positions, one chunk when S is no
    multiple of it) under remat, so the (B, S, V) tensor never exists. On
    a mesh ``h`` and ``labels`` are the rank's batch block, and the loss
    is the mean over "data" of the blocks' means."""
    B, S, _ = h.shape
    chunk = chunk or cfg.ce_chunk
    if S % chunk != 0:
        chunk = S
    labels = torch.as_tensor(labels, device=h.device).long()
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(0, S, chunk):
        total = total + checkpoint(_ce_chunk, cfg, h[:, c:c + chunk], lm_head,
                                   labels[:, c:c + chunk],
                                   use_reentrant=False)
    if shd is None:
        return total / (B * S)
    return comm.mean_over(shd.mesh, "data", total / (B * S))


def train_loss(cfg: ModelConfig, params: LM, batch,
               shd: ShardingCtx | None = None, remat: bool = True,
               remat_policy: str = "full"):
    """The mean next-token cross-entropy of ``batch`` ({"tokens" or
    "embeds", "labels"[, "vision"]}), differentiable in the parameters that
    require a gradient (``make_train_step`` turns them on). On a mesh
    ``batch`` is the global batch and the loss the global mean, the same
    on every rank."""
    shd, batch = _local(shd, batch)
    # on a mesh the gathered embedding lives for the lookup only; the head
    # is gathered where the loss needs it
    x = _embed_in(cfg, _weights(params, shd), batch, shd)
    S = batch["labels"].shape[1]
    positions = torch.arange(S, device=x.device)
    x = _stack(cfg, params, x, positions, _vision(params, batch), remat,
               remat_policy, shd)
    w = _weights(params, shd)
    x = L.rms_norm(x, w.final_norm, cfg.rms_eps)
    return chunked_ce_loss(cfg, x, _lm_head(cfg, w), batch["labels"], shd)


@torch.no_grad()
def forward_logits(cfg: ModelConfig, params: LM, batch,
                   shd: ShardingCtx | None = None):
    """Full logits (B, S, vocab) — smoke tests/small evals only."""
    shd, batch = _local(shd, batch)
    w = _weights(params, shd)
    x = _embed_in(cfg, w, batch, shd)
    S = (batch["embeds"] if cfg.embeddings_in else batch["tokens"]).shape[1]
    positions = torch.arange(S, device=x.device)
    x = _stack(cfg, params, x, positions, _vision(params, batch), shd=shd)
    x = L.rms_norm(x, w.final_norm, cfg.rms_eps)
    return _gather_batch((x @ _lm_head(cfg, w))[..., : cfg.vocab], shd)


# --------------------------------------------------------------------------
# prefill + decode (serving)
# --------------------------------------------------------------------------

def cache_pad(cfg: ModelConfig) -> int:
    return 64  # decode slots appended after the prefilled prefix


class PlacedCache(list):
    """A decode cache on a mesh: the port's cache (one dict a unit), each
    leaf the rank's block; ``specs`` its ``cache_specs`` (the batch entry
    of each leaf's spec is already the rank's block)."""

    def __init__(self, units, specs: dict):
        super().__init__(units)
        self.specs = specs


def _seq_only(spec: tuple) -> tuple:
    """A cache spec without its batch entry (the leaf holds the batch
    block already)."""
    return (None,) + tuple(spec[1:])


@torch.no_grad()
def prefill(cfg: ModelConfig, params: LM, batch,
            shd: ShardingCtx | None = None):
    """Forward the prompt; returns (last-token logits (B, vocab), cache, pos)
    with ``pos`` = S, a Python int.

    Each attention layer's K / V cache is preallocated as (B, S + cache_pad,
    K, dh) in the activation dtype, the prompt's keys (after RoPE) and values
    in its first S slots. On a mesh the cache is a :class:`PlacedCache` of
    the rank's blocks.
    """
    if cfg.encoder_only:
        raise ValueError("encoder-only model has no prefill/decode")
    shd, batch = _local(shd, batch)
    w = _weights(params, shd)
    x = _embed_in(cfg, w, batch)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)
    vision = _vision(params, batch)
    pad = cache_pad(cfg)
    caches = []
    for up in params.units:
        uw = up if shd is None else Gathered(up, shd.mesh)
        x, unit_cache = _apply_unit(cfg, uw, x, positions, vision, True, shd)
        for entry in unit_cache.values():
            for name in ("k", "v"):
                if name in entry:
                    kv = entry[name]
                    padded = kv.new_zeros((B, S + pad) + kv.shape[2:])
                    padded[:, :S] = kv
                    entry[name] = padded
        caches.append(unit_cache)
    x = L.rms_norm(x, w.final_norm, cfg.rms_eps)
    logits = x[:, -1, :] @ _lm_head(cfg, w)
    if shd is not None:
        # the leaves hold the batch block already: its entry is dp exactly
        # where the batch divides dp (cache_specs' rule, on the global B)
        bdp = shd.dp if shd.split else None
        specs = {ln: {nm: (bdp,) + sp[1:] for nm, sp in e.items()}
                 for ln, e in cache_specs(cfg, caches, shd.dp,
                                          shd.mesh).items()}
        caches = PlacedCache(
            [{ln: {nm: comm.place(shd.mesh, t, _seq_only(specs[ln][nm]))
                   for nm, t in entry.items()}
              for ln, entry in unit.items()} for unit in caches], specs)
    return _gather_batch(logits[:, : cfg.vocab], shd), caches, S


def init_cache(cfg: ModelConfig, batch: int, prefix_len: int,
               dtype=torch.bfloat16, device=None):
    """Shape-only cache (zeros) in the port's layout: one dict per unit."""
    dev = resolve_device(device)
    smax = prefix_len + cache_pad(cfg)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    caches = []
    for _ in range(cfg.n_units):
        unit = {}
        for j, (mixer, _ffn) in enumerate(cfg.pattern):
            if mixer == "attn":
                unit[f"l{j}"] = {
                    "k": zeros(batch, smax, cfg.n_kv, cfg.d_head),
                    "v": zeros(batch, smax, cfg.n_kv, cfg.d_head),
                }
            elif mixer == "xattn":
                shape = (batch, cfg.n_vision_tokens, cfg.n_kv, cfg.d_head)
                unit[f"l{j}"] = {"xk": zeros(*shape), "xv": zeros(*shape)}
            elif mixer == "mamba":
                unit[f"l{j}"] = L.mamba_state_init(cfg, batch, dtype, dev)
        caches.append(unit)
    return caches


def _cache_whole(shd, entry: dict, specs: dict) -> dict:
    """A layer's cache leaves whole over "model" (their batch block kept)."""
    return {nm: comm.gather_whole(shd.mesh, t, _seq_only(specs[nm]))
            for nm, t in entry.items()}


def _cache_write(shd, entry: dict, whole: dict, specs: dict, pos: int):
    """Write a decode step's cache back into the rank's blocks: slot
    ``pos`` of K / V into the block that holds it, a Mamba state's block."""
    mesh = shd.mesh
    for nm, t in whole.items():
        spec = _seq_only(specs[nm])
        if nm in ("k", "v"):
            if spec[1] is None:
                entry[nm][:, pos] = t[:, pos]
                continue
            n = entry[nm].shape[1]
            lo = mesh.coord(spec[1]) * n
            if lo <= pos < lo + n:
                entry[nm][:, pos - lo] = t[:, pos]
        elif nm not in ("xk", "xv"):
            entry[nm] = comm.place(mesh, t, spec)


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: LM, tokens, cache, pos: int,
                shd: ShardingCtx | None = None):
    """One autoregressive step. tokens (B, 1) int; ``pos`` (a Python int) is
    the slot this token writes. Writes slot ``pos`` of each attention cache
    in place and replaces each Mamba layer's state in its dict, so the
    returned cache is the one passed in; returns (logits (B, vocab), cache,
    pos + 1). On a mesh ``cache`` is a :class:`PlacedCache`: each layer
    gathers its leaves over "model" before use, and slot ``pos`` is written
    into the block that holds it."""
    shd, batch = _local(shd, {"tokens": tokens})
    w = _weights(params, shd)
    tokens = torch.as_tensor(batch["tokens"], device=w.embed.device)
    y = _embed_tokens(w, tokens)
    for up, uc in zip(params.units, cache):
        uw = up if shd is None else Gathered(up, shd.mesh)
        for j, (mixer, ffn) in enumerate(cfg.pattern):
            lp = getattr(uw, f"l{j}")
            entry = uc[f"l{j}"]
            if shd is not None:
                specs = cache.specs[f"l{j}"]
                entry = _cache_whole(shd, entry, specs)
            h = L.rms_norm(y, lp.norm1, cfg.rms_eps)
            if mixer == "attn":
                mx, new = L.apply_attention_decode(cfg, lp.attn, h, entry,
                                                   pos)
            elif mixer == "xattn":
                mx, new = L.apply_cross_attention_decode(cfg, lp.xattn, h,
                                                         entry)
            else:  # mamba
                mx, new = L.apply_mamba_decode(cfg, lp.mamba, h, entry)
            if shd is not None:
                _cache_write(shd, uc[f"l{j}"], new, specs, pos)
            elif mixer == "mamba":
                uc[f"l{j}"] = new
            y = y + mx
            if ffn != "none":
                y = y + _apply_ffn(cfg, ffn, lp,
                                   L.rms_norm(y, lp.norm2, cfg.rms_eps), shd)
    x = L.rms_norm(y, w.final_norm, cfg.rms_eps)
    logits = x[:, -1, :] @ _lm_head(cfg, w)
    return _gather_batch(logits[:, : cfg.vocab], shd), cache, pos + 1
