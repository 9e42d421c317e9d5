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
batch and computes the rank's block of it (``batch_specs``), and the
weights stay on their blocks: the reference's partition rules, computed.
With more than one model rank:

  * TP: each unit runs its heads, FFN columns and experts on the rank's
    blocks (``layers.apply_attention_tp``, ``apply_mamba_tp``, the MLP and
    the MoE; Megatron column -> row pairs); FSDP's blocks over "data" are
    joined before use, as the reference's XLA does;
  * SP: the carry between units is the rank's S / tp slice of the
    sequence, gathered at a unit's products and reduce-scattered after
    them (``layers.enter`` / ``leave``), so remat saves the slice only;
    where the sequence does not split (decode) the carry is replicated
    and a row-parallel product's partial sums are all-reduced;
  * EP: the MoE takes the expert-parallel path where the reference's gate
    lets it, on the rank's slice;
  * the vocabulary: the lookup reads the rank's block of ``embed`` and the
    partial rows are summed into the carry; the cross-entropy takes its
    log-sum-exp from the blocks' maxima and sums (:func:`_ce_chunk_tp`);
    logits come back whole from one all-gather.

The loss is the mean over "data" of the blocks' means. A decode cache is a
:class:`PlacedCache` of the rank's blocks (``cache_specs``): prefill
writes each rank's slots of every K / V head (an all-to-all over
"model"), decode attends every head over the rank's slots and combines
the blocks by log-sum-exp. With one model rank each unit runs the
single-device layers on the rank's weights. ``shd=None`` is the
single-device path.
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
from repro_torch.kernels.embed_grad import EmbedLookup
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
                 shd: ShardingCtx | None = None, seq_split: bool = False,
                 t_cache: int = 0):
    if _tp(shd):
        return _apply_layer_tp(cfg, mixer, ffn, lp, x, positions, vision,
                               collect_cache, shd, seq_split, t_cache)
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


def _tp(shd: ShardingCtx | None) -> bool:
    """Whether the units run in their tensor-parallel forms: a mesh whose
    model axis has more than one rank."""
    return shd is not None and shd.tp_size > 1


def _apply_layer_tp(cfg: ModelConfig, mixer: str, ffn: str, lp, x, positions,
                    vision, collect_cache: bool, shd: ShardingCtx,
                    seq_split: bool, t_cache: int):
    """One layer on a mesh of tp > 1: ``x`` the carry (the rank's block of
    the sequence with ``seq_split``, else replicated over "model"); each
    norm on the carry, the mixer and the FFN on the rank's heads, columns
    or experts between :func:`layers.enter` and :func:`layers.leave`.
    With ``collect_cache`` the rank's blocks of the decode cache (its
    slots of a ``t_cache``-slot K / V cache, ``cache_specs``)."""
    norm = ((lambda w: L.shared(shd, w)) if seq_split else (lambda w: w))
    cache = None
    xw = L.enter(shd, L.rms_norm(x, norm(lp.norm1), cfg.rms_eps), seq_split)
    if mixer == "attn":
        mx = L.apply_attention_tp(cfg, lp.attn, xw, positions, shd,
                                  causal=cfg.causal)
        if collect_cache:
            cache = L.kv_cache_blocks(cfg, lp.attn, xw, shd, t_cache,
                                      _splits(shd, t_cache), rotate=True)
    elif mixer == "xattn":
        mx = L.apply_attention_tp(cfg, lp.xattn, xw, positions, shd,
                                  kv_source=vision)
        if collect_cache:
            T = vision.shape[1]
            kv = L.kv_cache_blocks(cfg, lp.xattn, vision, shd, T,
                                   _splits(shd, T), rotate=False)
            cache = {"xk": kv["k"], "xv": kv["v"]}
    elif mixer == "mamba":
        mx, cache = L.apply_mamba_tp(cfg, lp.mamba, xw, shd, collect_cache)
    else:
        raise ValueError(mixer)
    x = x + L.leave(shd, mx, seq_split)
    if ffn != "none":
        h2 = L.rms_norm(x, norm(lp.norm2), cfg.rms_eps)
        x = x + _apply_ffn_tp(cfg, ffn, lp, h2, shd, seq_split)
    return x, cache


def _apply_ffn_tp(cfg: ModelConfig, ffn: str, lp, h2, shd: ShardingCtx,
                  seq_split: bool):
    """The FFN on a mesh of tp > 1 from the normed carry ``h2``: the MLP
    column -> row parallel; the MoE expert parallel on the rank's block of
    the sequence where the reference's gate lets it, else the global view
    on the rank's experts (arctic's dense residual beside it)."""
    if ffn == "mlp":
        return L.leave(shd, L.apply_mlp(lp.mlp, L.enter(shd, h2, seq_split)),
                       seq_split)
    B, S = h2.shape[0], h2.shape[1] * (shd.tp_size if seq_split else 1)
    batch = B * shd.dp_size if shd.split else B
    if seq_split and L.ep_gate(cfg, batch, S, shd.dp_size, shd.tp_size):
        y = L.moe_ep_block(cfg, lp.moe, h2, shd)
        if ffn == "moe_dense":
            y = y + L.leave(shd, L.apply_mlp(
                lp.dense, L.enter(shd, h2, seq_split)), seq_split)
        return y
    xw = L.enter(shd, h2, seq_split)
    y = L.moe_tp_core(cfg, lp.moe, xw, shd)
    if ffn == "moe_dense":
        y = y + L.apply_mlp(lp.dense, xw)
    return L.leave(shd, y, seq_split)


def _splits(shd: ShardingCtx, length: int) -> bool:
    """Whether a cache sequence of ``length`` slots lies over "model"
    (``cache_specs``' rule)."""
    return length % shd.tp_size == 0


def _apply_unit(cfg: ModelConfig, up: nn.Module, x, positions, vision,
                collect_cache: bool, shd: ShardingCtx | None = None,
                seq_split: bool = False, t_cache: int = 0):
    caches = {}
    for j, (mixer, ffn) in enumerate(cfg.pattern):
        x, cache = _apply_layer(cfg, mixer, ffn, getattr(up, f"l{j}"), x,
                                positions, vision, collect_cache, shd,
                                seq_split, t_cache)
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

def _embed_in(cfg, params: LM, batch, shd: ShardingCtx | None = None,
              seq_split: bool = False):
    """The input activations; on a mesh (``batch`` already the rank's
    block, ``params`` the model's view) the carry: with ``seq_split`` the
    rank's block of the sequence. On a mesh of tp > 1 the lookup is
    vocabulary parallel: each rank reads the ids in its block of ``embed``
    and gives zeros for the rest, and the sum over "model" lands in the
    carry (:func:`layers.leave`)."""
    if cfg.embeddings_in:
        x = torch.as_tensor(batch["embeds"], device=params.final_norm.device)
        if not seq_split:
            return x
        return comm.slice_block(shd.mesh, shd.tp, x, 1)
    tokens = torch.as_tensor(batch["tokens"], device=params.embed.device)
    if not _tp(shd):
        return _embed_tokens(params, tokens)
    table = params.embed
    row0 = shd.mesh.coord(shd.tp) * table.shape[0]
    return L.leave(shd, EmbedLookup.apply(table, tokens, row0), seq_split)


def _sequence_parallel(shd: ShardingCtx | None, seq: int) -> bool:
    """Whether activations between units are held as the rank's slice of
    the sequence: the reference pins them to (dp, tp, None) when S is a
    multiple of 16."""
    return (shd is not None and shd.tp_size > 1 and seq % 16 == 0
            and seq % shd.tp_size == 0)


def _seq_whole(x, shd: ShardingCtx | None, seq_split: bool):
    """The whole sequence of a carry, no gradient (the logits' input)."""
    if not seq_split:
        return x
    return comm.all_gather(shd.mesh, shd.tp, x, 1)


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
    return comm.all_gather(shd.mesh, shd.dp, x, 0)


def _embed_tokens(params: LM, tokens):
    """The embedding's rows of ``tokens``; the gradient sums them back in
    a fixed order (``kernels.embed_grad``), so it has the same bits on
    every run."""
    return EmbedLookup.apply(params.embed, tokens)


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
    ``REMAT_POLICIES[remat_policy]``. On a mesh ``x`` is the carry, the
    rank's slice of the sequence where it splits (returned so), and each
    unit reads its weights' blocks at its start (so remat keeps the slice
    and no weight)."""
    context_fn = REMAT_POLICIES[remat_policy]
    seq_split = _sequence_parallel(shd, positions.shape[0])
    for up in params.units:
        def unit_fn(h, up=up):
            if shd is None:
                return _apply_unit(cfg, up, h, positions, vision, False)[0]
            return _apply_unit(cfg, Gathered(up, shd.mesh), h, positions,
                               vision, False, shd, seq_split)[0]

        x = (checkpoint(unit_fn, x, use_reentrant=False,
                        context_fn=context_fn) if remat else unit_fn(x))
    return x


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


def _ce_chunk_tp(cfg, hc, lm_head, lc, shd: ShardingCtx):
    """:func:`_ce_chunk` over this rank's block of the vocabulary
    (``lm_head`` its (D, V / tp) columns): the log-sum-exp from the
    maximum over "model" and the sum of the blocks' exponentials, the gold
    logit from the rank that holds it (both sums all-reduced, their
    gradient the identity)."""
    mesh = shd.mesh
    logits = (hc @ lm_head).to(torch.float32)
    vb = logits.shape[-1]
    lo = mesh.coord(shd.tp) * vb
    cols = lo + torch.arange(vb, device=logits.device)
    if cfg.vocab_pad != cfg.vocab:
        logits = logits.masked_fill(cols >= cfg.vocab, L.MASKED)
    m = comm.all_max(mesh, shd.tp, logits.detach().amax(dim=-1))
    se = comm.sum_over(mesh, shd.tp,
                       torch.exp(logits - m[..., None]).sum(dim=-1))
    local = lc - lo
    mine = (local >= 0) & (local < vb)
    gold = torch.gather(logits, -1, local.clamp(0, vb - 1)[..., None])[..., 0]
    gold = comm.sum_over(mesh, shd.tp, torch.where(mine, gold, 0.0))
    return torch.sum(m + torch.log(se) - gold)


def chunked_ce_loss(cfg, h, lm_head, labels, shd: ShardingCtx | None = None,
                    chunk: int | None = None):
    """Mean next-token cross-entropy; the logits are computed a sequence
    chunk at a time (``cfg.ce_chunk`` positions, one chunk when S is no
    multiple of it) under remat, so the (B, S, V) tensor never exists. On
    a mesh ``h`` and ``labels`` are the rank's batch block, and the loss
    is the mean over "data" of the blocks' means; on a mesh of tp > 1
    ``h`` is the whole sequence, replicated over "model", and ``lm_head``
    the rank's block of the vocabulary (:func:`_ce_chunk_tp`)."""
    B, S, _ = h.shape
    chunk = chunk or cfg.ce_chunk
    if S % chunk != 0:
        chunk = S
    labels = torch.as_tensor(labels, device=h.device).long()
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(0, S, chunk):
        args = (cfg, h[:, c:c + chunk], lm_head, labels[:, c:c + chunk])
        total = total + (checkpoint(_ce_chunk_tp, *args, shd,
                                    use_reentrant=False) if _tp(shd) else
                         checkpoint(_ce_chunk, *args, use_reentrant=False))
    if shd is None:
        return total / (B * S)
    return comm.mean_over(shd.mesh, shd.dp, total / (B * S))


def _final(cfg, w, x, shd: ShardingCtx | None, seq_split: bool):
    """The final norm of the carry ``x`` (its scale's gradient summed over
    "model" where the carry is the rank's block of the sequence)."""
    scale = w.final_norm
    if seq_split:
        scale = L.shared(shd, scale)
    return L.rms_norm(x, scale, cfg.rms_eps)


def _vocab_whole(logits, shd: ShardingCtx | None):
    """Logits over the whole vocabulary from each rank's block over
    "model" (one all-gather at the end; no gradient)."""
    if not _tp(shd):
        return logits
    return comm.all_gather(shd.mesh, shd.tp, logits, logits.dim() - 1)


def train_loss(cfg: ModelConfig, params: LM, batch,
               shd: ShardingCtx | None = None, remat: bool = True,
               remat_policy: str = "full"):
    """The mean next-token cross-entropy of ``batch`` ({"tokens" or
    "embeds", "labels"[, "vision"]}), differentiable in the parameters that
    require a gradient (``make_train_step`` turns them on). On a mesh
    ``batch`` is the global batch and the loss the global mean, the same
    on every rank."""
    shd, batch = _local(shd, batch)
    S = batch["labels"].shape[1]
    seq_split = _sequence_parallel(shd, S)
    x = _embed_in(cfg, _weights(params, shd), batch, shd, seq_split)
    positions = torch.arange(S, device=x.device)
    x = _stack(cfg, params, x, positions, _vision(params, batch), remat,
               remat_policy, shd)
    w = _weights(params, shd)
    x = _final(cfg, w, x, shd, seq_split)
    if _tp(shd):
        x = L.enter(shd, x, seq_split)
    return chunked_ce_loss(cfg, x, _lm_head(cfg, w), batch["labels"], shd)


@torch.no_grad()
def forward_logits(cfg: ModelConfig, params: LM, batch,
                   shd: ShardingCtx | None = None):
    """Full logits (B, S, vocab) — smoke tests/small evals only."""
    shd, batch = _local(shd, batch)
    w = _weights(params, shd)
    S = (batch["embeds"] if cfg.embeddings_in else batch["tokens"]).shape[1]
    seq_split = _sequence_parallel(shd, S)
    x = _embed_in(cfg, w, batch, shd, seq_split)
    positions = torch.arange(S, device=x.device)
    x = _stack(cfg, params, x, positions, _vision(params, batch), shd=shd)
    x = _seq_whole(_final(cfg, w, x, shd, seq_split), shd, seq_split)
    logits = _vocab_whole(x @ _lm_head(cfg, w), shd)
    return _gather_batch(logits[..., : cfg.vocab], shd)


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


@torch.no_grad()
def prefill(cfg: ModelConfig, params: LM, batch,
            shd: ShardingCtx | None = None):
    """Forward the prompt; returns (last-token logits (B, vocab), cache, pos)
    with ``pos`` = S, a Python int.

    Each attention layer's K / V cache is preallocated as (B, S + cache_pad,
    K, dh) in the activation dtype, the prompt's keys (after RoPE) and values
    in its first S slots. On a mesh the cache is a :class:`PlacedCache` of
    the rank's blocks, which each layer writes as it runs: a rank's slots
    of every K / V head (``layers.kv_cache_blocks``), its channels' conv
    windows and its heads' SSM state.
    """
    if cfg.encoder_only:
        raise ValueError("encoder-only model has no prefill/decode")
    shd, batch = _local(shd, batch)
    w = _weights(params, shd)
    S = batch["tokens"].shape[1]
    seq_split = _sequence_parallel(shd, S)
    x = _embed_in(cfg, w, batch, shd, seq_split)
    B = x.shape[0]
    positions = torch.arange(S, device=x.device)
    vision = _vision(params, batch)
    pad = cache_pad(cfg)
    caches = []
    for up in params.units:
        uw = up if shd is None else Gathered(up, shd.mesh)
        x, unit_cache = _apply_unit(cfg, uw, x, positions, vision, True, shd,
                                    seq_split, S + pad)
        if not _tp(shd):
            for entry in unit_cache.values():
                for name in ("k", "v"):
                    if name in entry:
                        kv = entry[name]
                        padded = kv.new_zeros((B, S + pad) + kv.shape[2:])
                        padded[:, :S] = kv
                        entry[name] = padded
        caches.append(unit_cache)
    last = x[:, -1:]
    if seq_split:  # the last position is the last model rank's
        last = comm.all_gather(shd.mesh, shd.tp, last, 1)[:, -1:]
    x = _final(cfg, w, last, None, False)
    logits = _vocab_whole(x[:, -1, :] @ _lm_head(cfg, w), shd)
    if shd is not None:
        # the leaves hold the batch block already: its entry is dp exactly
        # where the batch divides dp (cache_specs' rule, on the global B)
        bdp = shd.dp if shd.split else None
        whole = [{ln: {nm: torch.empty(shape, device="meta")
                       for nm, shape in e.items()}
                  for ln, e in _cache_layout(cfg, B, S + pad)[0].items()}]
        specs = {ln: {nm: (bdp,) + sp[1:] for nm, sp in e.items()}
                 for ln, e in cache_specs(cfg, whole, shd.dp,
                                          shd.mesh).items()}
        if not _tp(shd):
            caches = [{ln: {nm: comm.place(shd.mesh, t,
                                           (None,) + specs[ln][nm][1:])
                            for nm, t in entry.items()}
                       for ln, entry in unit.items()} for unit in caches]
        caches = PlacedCache(caches, specs)
    return _gather_batch(logits[:, : cfg.vocab], shd), caches, S


def _cache_layout(cfg: ModelConfig, batch: int, smax: int) -> list:
    """The shape of every leaf of a decode cache of ``smax`` K / V slots:
    one dict a unit, ``{layer: {leaf: shape}}``."""
    k, gn = cfg.ssm_conv - 1, cfg.ssm_groups * cfg.ssm_state
    unit = {}
    for j, (mixer, _ffn) in enumerate(cfg.pattern):
        if mixer == "attn":
            kv = (batch, smax, cfg.n_kv, cfg.d_head)
            unit[f"l{j}"] = {"k": kv, "v": kv}
        elif mixer == "xattn":
            kv = (batch, cfg.n_vision_tokens, cfg.n_kv, cfg.d_head)
            unit[f"l{j}"] = {"xk": kv, "xv": kv}
        elif mixer == "mamba":
            unit[f"l{j}"] = {
                "convx": (batch, k, cfg.d_inner), "convb": (batch, k, gn),
                "convc": (batch, k, gn),
                "ssm": (batch, cfg.ssm_heads, cfg.ssm_state,
                        cfg.ssm_head_dim)}
    return [unit] * cfg.n_units


def init_cache(cfg: ModelConfig, batch: int, prefix_len: int,
               dtype=torch.bfloat16, device=None):
    """Shape-only cache (zeros) in the port's layout: one dict per unit
    (a Mamba layer's SSM state in f32)."""
    dev = resolve_device(device)
    return [{ln: {nm: torch.zeros(shape, dtype=torch.float32 if nm == "ssm"
                                  else dtype, device=dev)
                  for nm, shape in e.items()} for ln, e in unit.items()}
            for unit in _cache_layout(cfg, batch,
                                      prefix_len + cache_pad(cfg))]


def _decode_layer_tp(cfg: ModelConfig, mixer: str, ffn: str, lp, y, entry,
                     specs: dict, pos: int, shd: ShardingCtx):
    """One layer of a decode step on a mesh of tp > 1, the carry ``y``
    replicated: the mixer on the rank's blocks of the cache (``entry``,
    written in place; ``specs`` its ``cache_specs``), its partial sums
    all-reduced over "model", then the FFN."""
    h = L.rms_norm(y, lp.norm1, cfg.rms_eps)
    if mixer == "mamba":
        mx, new = L.apply_mamba_decode_tp(cfg, lp.mamba, h, entry, shd)
        entry.update(new)
    else:
        split = specs["xk" if mixer == "xattn" else "k"][1] is not None
        if mixer == "attn":
            mx = L.apply_attention_decode_tp(cfg, lp.attn, h, entry, pos,
                                             shd, split)
        else:
            mx = L.apply_cross_attention_decode_tp(cfg, lp.xattn, h, entry,
                                                   shd, split)
    y = y + comm.sum_over(shd.mesh, shd.tp, mx)
    if ffn != "none":
        y = y + _apply_ffn_tp(cfg, ffn, lp, L.rms_norm(y, lp.norm2,
                                                       cfg.rms_eps),
                              shd, False)
    return y


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: LM, tokens, cache, pos: int,
                shd: ShardingCtx | None = None):
    """One autoregressive step. tokens (B, 1) int; ``pos`` (a Python int) is
    the slot this token writes. Writes slot ``pos`` of each attention cache
    in place and replaces each Mamba layer's state in its dict, so the
    returned cache is the one passed in; returns (logits (B, vocab), cache,
    pos + 1). On a mesh ``cache`` is a :class:`PlacedCache`, whose blocks
    stay where they are: on a mesh of tp > 1 each rank attends every head
    over its slots and the blocks' partials are combined by log-sum-exp
    (``layers.apply_attention_decode_tp``), slot ``pos`` written by the
    rank that holds it, and each Mamba layer steps the rank's heads on its
    blocks of the state; with tp = 1 the blocks are the whole sequence."""
    shd, batch = _local(shd, {"tokens": tokens})
    w = _weights(params, shd)
    if _tp(shd):
        y = _embed_in(cfg, w, batch, shd)
    else:
        y = _embed_tokens(w, torch.as_tensor(batch["tokens"],
                                             device=w.embed.device))
    for up, uc in zip(params.units, cache):
        uw = up if shd is None else Gathered(up, shd.mesh)
        for j, (mixer, ffn) in enumerate(cfg.pattern):
            lp = getattr(uw, f"l{j}")
            entry = uc[f"l{j}"]
            if _tp(shd):
                y = _decode_layer_tp(cfg, mixer, ffn, lp, y, entry,
                                     cache.specs[f"l{j}"], pos, shd)
                continue
            h = L.rms_norm(y, lp.norm1, cfg.rms_eps)
            if mixer == "attn":
                mx, _ = L.apply_attention_decode(cfg, lp.attn, h, entry, pos)
            elif mixer == "xattn":
                mx, _ = L.apply_cross_attention_decode(cfg, lp.xattn, h,
                                                       entry)
            else:  # mamba
                mx, new = L.apply_mamba_decode(cfg, lp.mamba, h, entry)
                uc[f"l{j}"] = new
            y = y + mx
            if ffn != "none":
                y = y + _apply_ffn(cfg, ffn, lp,
                                   L.rms_norm(y, lp.norm2, cfg.rms_eps), shd)
    x = L.rms_norm(y, w.final_norm, cfg.rms_eps)
    logits = _vocab_whole(x[:, -1, :] @ _lm_head(cfg, w), shd)
    return _gather_batch(logits[:, : cfg.vocab], shd), cache, pos + 1
