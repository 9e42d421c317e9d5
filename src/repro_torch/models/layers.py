"""Model layers of the LM substrate (counterpart of ``repro.models.layers``):
RMSNorm, RoPE, query-chunked GQA attention (self and cross, full sequence
and one-token decode), the SwiGLU MLP, top-k MoE with sort-based capacity
dispatch, and the Mamba2 SSD mixer (chunked scan and an O(1) decode step).

Conventions, as the reference's:
  * every ``init_*`` returns an ``nn.Module`` whose parameters keep the
    reference's names and ``(in, out)`` layouts, so a converted weight is a
    copy and each product reads like the reference's einsum; every
    ``apply_*`` takes that module as ``p``;
  * shapes: x (B, S, D); attention heads H query / K kv heads, head dim dh;
  * compute follows the input dtype (bf16 when serving); softmax and norm
    statistics, RoPE, the router and the SSM recurrence in f32.

Every op is the reference's plain arithmetic in the reference's order: no
fused attention or other library kernel stands in for it. The reference has
no Pallas kernel on this path, so neither has the port. Parameters are
built frozen (``requires_grad=False``), which serving and the layer-level
checks read directly; the training step turns on the gradients of the
model it trains (``runtime.train_loop.make_train_step``).

``shd`` (:class:`ShardingCtx`) carries the mesh of a sharded run; with it,
``p`` is a placed module's view (``sharding.partition.Gathered``: each
weight the rank's block over "model"). Where the model axis has more than
one rank, ``models.transformer`` runs each unit in the tensor-parallel
forms at the end of this module (Megatron column -> row pairs: q / k / v,
``wi`` / ``wg``, ``wz`` / ``wx`` / ``wdt`` column-parallel, ``wo`` and
``out_proj`` row-parallel; :func:`enter` and :func:`leave` at a region's
edges), and the MoE runs the rank's experts: the reference's
expert-parallel path where its gate lets it (:func:`moe_ep_block`: two
``all_to_all_single``s over the model group), else the global view
(:func:`moe_tp_core`). ``shd=None`` is the single-device path.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding import comm

MASKED = -1e30  # the reference's mask value: finite, so a fully masked row
                # stays finite through the softmax


@dataclasses.dataclass(frozen=True)
class ShardingCtx:
    """The mesh of a sharded run, as the layers read it: ``dp`` the data
    axes, ``tp`` the model axis, ``mesh`` the rank's
    :class:`~repro_torch.launch.mesh.Mesh` (its groups, sizes and
    coordinates). ``split`` says whether activations hold the rank's block
    of the batch (the batch divides the data axes, ``batch_specs``) or the
    whole batch; the entry points set it."""

    dp: tuple
    tp: str
    mesh: Any = None
    split: bool = True

    @property
    def tp_size(self) -> int:
        return self.mesh.size(self.tp) if self.mesh is not None else 1

    @property
    def dp_size(self) -> int:
        return self.mesh.size(self.dp) if self.mesh is not None else 1


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def _dense_(w: torch.Tensor, gen: torch.Generator, scale=None) -> None:
    """Fill ``w`` as the reference's ``_dense``: a standard normal drawn in
    f32, times ``scale`` (1/sqrt(shape[0]) by default), cast to w's dtype."""
    scale = scale if scale is not None else 1.0 / math.sqrt(w.shape[0])
    draw = torch.randn(w.shape, generator=gen, dtype=torch.float32,
                       device=w.device)
    w.copy_(draw.mul_(scale))


# --------------------------------------------------------------------------
# basics
# --------------------------------------------------------------------------

def rms_norm(x, scale, eps=1e-5):
    """The variance is an f32-accumulated sum of squares; its rsqrt is cast
    to x's dtype and the product taken in x's dtype, as the reference does."""
    xf = x.float()
    var = (xf * xf).sum(-1) / x.shape[-1]
    inv = torch.rsqrt(var + eps)[..., None].to(x.dtype)
    return x * inv * scale.to(x.dtype)


def rope(x, positions, theta):
    """x: (..., S, H, Dh); positions: (S,) int. Rotates first/second halves
    (not interleaved pairs), in f32."""
    dh = x.shape[-1]
    half = dh // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[:, None].to(torch.float32) * freq  # (S, half)
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]
    x1, x2 = torch.split(x.to(torch.float32), half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention (self / cross), full-sequence chunked + decode
# --------------------------------------------------------------------------

class Attention(nn.Module):
    """wq (D, H*dh), wk / wv (D, K*dh), wo (H*dh, D); bq / bk / bv with
    ``qkv_bias``; q_norm / k_norm (dh,) with ``qk_norm``."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32, device=None):
        super().__init__()
        D, H, K, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head
        self.wq = _param((D, H * dh), dtype, device)
        self.wk = _param((D, K * dh), dtype, device)
        self.wv = _param((D, K * dh), dtype, device)
        self.wo = _param((H * dh, D), dtype, device)
        if cfg.qkv_bias:
            self.bq = _param((H * dh,), dtype, device)
            self.bk = _param((K * dh,), dtype, device)
            self.bv = _param((K * dh,), dtype, device)
        if cfg.qk_norm:
            self.q_norm = _param((dh,), dtype, device)
            self.k_norm = _param((dh,), dtype, device)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            _dense_(w, gen)
        for name, p in self.named_parameters():
            if name in ("bq", "bk", "bv"):
                p.zero_()
            elif name in ("q_norm", "k_norm"):
                p.fill_(1)


def init_attention(cfg: ModelConfig, gen: torch.Generator,
                   dtype=torch.float32) -> Attention:
    p = Attention(cfg, dtype, gen.device)
    p.reset_parameters(gen)
    return p


def _project_q(cfg, p, x):
    B, S, _ = x.shape
    q = x @ p.wq
    if cfg.qkv_bias:
        q = q + p.bq
    q = q.reshape(B, S, cfg.n_heads, cfg.d_head)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.rms_eps)
    return q


def _project_kv(cfg, p, x):
    B, T, _ = x.shape
    k = x @ p.wk
    v = x @ p.wv
    if cfg.qkv_bias:
        k, v = k + p.bk, v + p.bv
    k = k.reshape(B, T, cfg.n_kv, cfg.d_head)
    v = v.reshape(B, T, cfg.n_kv, cfg.d_head)
    if cfg.qk_norm:
        k = rms_norm(k, p.k_norm, cfg.rms_eps)
    return k, v


def _sdpa(cfg, q, k, v, q_pos, k_pos, causal):
    """Grouped-query attention, query-chunked so no (S, S) score tensor is
    ever materialised (the transient is (B, K, G, chunk, T) f32 a chunk).
    ``scale`` multiplies after the f32 cast; masked scores are -1e30."""
    B, S, H, dh = q.shape
    K = k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(dh)
    qg = q.reshape(B, S, K, G, dh)

    def attend(qc, qp):  # qc: (B, C, K, G, dh); qp: (C,)
        s = torch.einsum("bckgd,btkd->bkgct", qc, k).to(torch.float32) * scale
        if causal:
            mask = qp[:, None] >= k_pos[None, :]  # (C, T)
            s = s.masked_fill(~mask, MASKED)
        a = torch.softmax(s, dim=-1).to(v.dtype)
        return torch.einsum("bkgct,btkd->bckgd", a, v)

    chunk = min(cfg.attn_chunk, S)
    if S % chunk != 0:
        chunk = S  # fall back to one chunk for odd shapes, as the reference
    o = torch.cat([attend(qg[:, c:c + chunk], q_pos[c:c + chunk])
                   for c in range(0, S, chunk)], dim=1)
    return o.reshape(B, S, H * dh)


def apply_attention(cfg, p, x, positions, kv_source=None, causal=True):
    """Full-sequence attention. kv_source != None => cross-attention (no RoPE
    on the cross branch; keys come from the vision/frontend embeddings)."""
    q = _project_q(cfg, p, x)
    cross = kv_source is not None
    src = kv_source if cross else x
    k, v = _project_kv(cfg, p, src)
    if not cross:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        k_pos = positions
    else:
        k_pos = torch.arange(src.shape[1], device=x.device)
        causal = False
    o = _sdpa(cfg, q, k, v, positions, k_pos, causal)
    return o @ p.wo


def apply_attention_decode(cfg, p, x, cache, pos: int):
    """One-token step. cache: {'k','v'}: (B, Smax, K, dh), preallocated;
    pos: the slot this token writes (a Python int). Writes slot ``pos`` of
    the cache IN PLACE and returns (out (B, 1, D), the same cache)."""
    B = x.shape[0]
    q = _project_q(cfg, p, x)  # (B, 1, H, dh)
    k_new, v_new = _project_kv(cfg, p, x)
    pos_arr = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    q = rope(q, pos_arr, cfg.rope_theta)
    k_new = rope(k_new, pos_arr, cfg.rope_theta)
    ck, cv = cache["k"], cache["v"]
    ck[:, pos] = k_new[:, 0].to(ck.dtype)
    cv[:, pos] = v_new[:, 0].to(cv.dtype)
    smax = ck.shape[1]
    K = cfg.n_kv
    G = cfg.n_heads // K
    qg = q.reshape(B, 1, K, G, cfg.d_head)
    s = torch.einsum("bckgd,btkd->bkgct", qg, ck).to(torch.float32)
    s = s / math.sqrt(cfg.d_head)
    mask = torch.arange(smax, device=x.device) <= pos
    s = s.masked_fill(~mask, MASKED)
    a = torch.softmax(s, dim=-1).to(cv.dtype)
    o = torch.einsum("bkgct,btkd->bckgd", a, cv).reshape(
        B, 1, cfg.n_heads * cfg.d_head)
    return o @ p.wo, cache


def apply_cross_attention_decode(cfg, p, x, cache):
    """Decode-time cross-attention: keys/values precomputed from the vision
    embeddings at prefill and carried in the cache (static)."""
    B = x.shape[0]
    q = _project_q(cfg, p, x)
    K = cfg.n_kv
    G = cfg.n_heads // K
    qg = q.reshape(B, 1, K, G, cfg.d_head)
    s = torch.einsum("bckgd,btkd->bkgct", qg, cache["xk"]).to(torch.float32)
    s = s / math.sqrt(cfg.d_head)
    a = torch.softmax(s, dim=-1).to(cache["xv"].dtype)
    o = torch.einsum("bkgct,btkd->bckgd", a, cache["xv"])
    o = o.reshape(B, 1, cfg.n_heads * cfg.d_head)
    return o @ p.wo, cache


# --------------------------------------------------------------------------
# FFNs: SwiGLU MLP / MoE (+ optional arctic-style dense residual)
# --------------------------------------------------------------------------

class MLP(nn.Module):
    """SwiGLU: wi, wg (d_model, d_ff), wo (d_ff, d_model)."""

    def __init__(self, d_model: int, d_ff: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.wi = _param((d_model, d_ff), dtype, device)
        self.wg = _param((d_model, d_ff), dtype, device)
        self.wo = _param((d_ff, d_model), dtype, device)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        for w in (self.wi, self.wg, self.wo):
            _dense_(w, gen)


def init_mlp(gen: torch.Generator, d_model, d_ff, dtype=torch.float32) -> MLP:
    p = MLP(d_model, d_ff, dtype, gen.device)
    p.reset_parameters(gen)
    return p


def apply_mlp(p, x):
    h = x @ p.wi
    g = x @ p.wg
    return (F.silu(g) * h) @ p.wo


class MoE(nn.Module):
    """router (D, E) in f32 (router math in f32), experts wi / wg (E, D, F)
    and wo (E, F, D) in the model dtype."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32, device=None):
        super().__init__()
        E, D, Fh = cfg.n_experts, cfg.d_model, cfg.d_expert
        self.router = _param((D, E), torch.float32, device)
        self.wi = _param((E, D, Fh), dtype, device)
        self.wg = _param((E, D, Fh), dtype, device)
        self.wo = _param((E, Fh, D), dtype, device)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        # the reference's _dense scales every one by 1/sqrt(shape[0]), so
        # the expert weights by 1/sqrt(E)
        for w in (self.router, self.wi, self.wg, self.wo):
            _dense_(w, gen)


def init_moe(cfg: ModelConfig, gen: torch.Generator,
             dtype=torch.float32) -> MoE:
    p = MoE(cfg, dtype, gen.device)
    p.reset_parameters(gen)
    return p


def moe_capacity(cfg: ModelConfig, tokens: int) -> int:
    cap = math.ceil(cfg.capacity_factor * tokens * cfg.top_k / cfg.n_experts)
    return max(8, -(-cap // 8) * 8)


def _top_k(probs, k):
    """``lax.top_k``: the k largest, in descending order, ties to the lower
    index (a stable descending sort; ``torch.topk`` promises no tie order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _moe_dispatch_compute(cfg: ModelConfig, router, xt, capacity: int,
                          expert_fn, before=None):
    """Routing + sort-based capacity dispatch on a flat (T, D) token block.

    Tokens are ranked within their expert by a stable sort of expert ids; the
    first ``capacity`` per expert are scattered into an (E, C, D) buffer and
    run through ``expert_fn(buf) -> (E, C, D)``; results are gathered back
    weighted by the (renormalised) router probabilities. The reference's
    out-of-capacity drop (scatter mode='drop', gather fill 0) is one extra
    row, E*C, that dropped assignments write to and read as zeros.
    ``before`` (None: zeros) maps this block's per-expert assignment counts
    (E,) to those of the blocks that precede it in a larger batch, whose
    ranks within each expert come first.
    """
    T, D = xt.shape
    E, k = cfg.n_experts, cfg.top_k
    C = capacity
    logits = xt.to(torch.float32) @ router
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = _top_k(probs, k)  # (T, k)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)

    eid = top_i.reshape(-1)  # (T*k,)
    order = torch.argsort(eid, stable=True)
    eid_sorted = eid[order]
    seg_start = torch.searchsorted(eid_sorted, eid_sorted, side="left")
    rank_sorted = torch.arange(T * k, device=xt.device) - seg_start
    ranks = torch.empty_like(rank_sorted)
    ranks[order] = rank_sorted
    if before is not None:
        # per-expert counts (a bincount of length exactly E: eid < E)
        counts = torch.zeros(E, dtype=torch.int64, device=eid.device)
        counts.scatter_add_(0, eid.long(),
                            torch.ones_like(eid, dtype=torch.int64))
        ranks = ranks + before(counts)[eid]
    keep = ranks < C
    dest = torch.where(keep, eid * C + ranks, E * C)  # E*C => dropped

    buf = xt.new_zeros((E * C + 1, D))
    buf[dest] = xt.repeat_interleave(k, dim=0)  # row t*k + j holds token t
    yb = expert_fn(buf[:E * C].reshape(E, C, D))
    ya = torch.cat([yb.reshape(E * C, D), yb.new_zeros((1, D))])[dest]
    y = ya * (top_p.reshape(T * k, 1) * keep[:, None]).to(ya.dtype)
    return y.reshape(T, k, D).sum(dim=1)


def _expert_ffn(p, buf):
    h = torch.bmm(buf, p.wi)
    g = torch.bmm(buf, p.wg)
    return torch.bmm(F.silu(g) * h, p.wo)


def ep_gate(cfg: ModelConfig, batch: int, seq: int, dp: int, tp: int) -> bool:
    """The reference's gate of the expert-parallel path (``layers.py:322``)
    for a global (batch, seq) on a (dp, tp) mesh: the sequence divides
    16 tp, the experts tp and the batch dp. Decode (seq 1) never takes it."""
    return (seq % (16 * tp) == 0 and cfg.n_experts % tp == 0
            and batch % dp == 0)


def apply_moe(cfg: ModelConfig, p, x, shd: ShardingCtx | None = None):
    """Top-k MoE with sort-based capacity dispatch (dropping, static
    shapes), on activations ``x`` replicated over "model" (on a mesh, the
    rank's batch block). Two paths, as the reference's:

    * **expert parallel** (a mesh, and :func:`ep_gate`): each rank routes
      its own S / tp tokens of its batch block into a local (E, c_loc, D)
      buffer, one all-to-all over the model group sends them to the ranks
      that hold their experts, and the reverse one brings the results back
      (:func:`_apply_moe_ep`);
    * **global view** (no mesh, decode, shapes the gate refuses): every
      token of the batch ranked within its expert, capacity
      ``moe_capacity`` of all B * S tokens. On a mesh whose activations
      hold the rank's batch block, each data rank dispatches its own tokens
      with the ranks they have among the whole batch's (the per-expert
      counts of the blocks before it, gathered over the data axes); each
      model rank runs its own E / tp experts and the outputs are summed
      over "model" (:func:`moe_tp_core`).
    """
    B, S, D = x.shape
    if shd is None or shd.mesh is None:
        T = B * S
        y = _moe_dispatch_compute(cfg, p.router, x.reshape(T, D),
                                  moe_capacity(cfg, T),
                                  lambda buf: _expert_ffn(p, buf))
        return y.reshape(B, S, D)
    batch = B * shd.dp_size if shd.split else B
    if ep_gate(cfg, batch, S, shd.dp_size, shd.tp_size):
        return _apply_moe_ep(cfg, p, x, shd)
    if shd.tp_size > 1:
        mesh = shd.mesh
        return comm.sum_over(mesh, shd.tp, moe_tp_core(
            cfg, p, comm.copy_to(mesh, shd.tp, x), shd))
    T = B * S
    y = _moe_dispatch_compute(cfg, p.router, x.reshape(T, D),
                              moe_capacity(cfg, batch * S),
                              lambda buf: _expert_ffn(p, buf),
                              _before(shd))
    return y.reshape(B, S, D)


def _before(shd: ShardingCtx):
    """The global view's per-expert counts of the data blocks before this
    rank's (None where the batch is whole on every data rank)."""
    if not (shd.split and shd.dp_size > 1):
        return None
    mesh = shd.mesh

    def before(counts):
        every = comm.all_gather(mesh, shd.dp, counts[None], 0)
        return every[:mesh.coord(shd.dp)].sum(dim=0)
    return before


def moe_tp_core(cfg: ModelConfig, p, x, shd: ShardingCtx):
    """The global view on a mesh of tp > 1 for this rank's own experts:
    ``x`` (B, S, D), the rank's batch block, whole over "model"; every
    rank routes every token the same way, runs the E / tp experts it holds
    on their rows of the buffer and gives zeros for the others' rows. The
    result is this rank's partial sum of the output (``comm.sum_over`` or
    ``comm.scatter_seq`` completes it); the router's gradient is partial
    too, so it is summed over "model"."""
    B, S, D = x.shape
    E = cfg.n_experts
    e_loc = E // shd.tp_size
    e0 = shd.mesh.coord(shd.tp) * e_loc
    batch = B * shd.dp_size if shd.split else B
    router = comm.copy_to(shd.mesh, shd.tp, p.router)

    def expert_fn(buf):  # (E, C, D): run rows [e0, e0 + e_loc) only
        y = _expert_ffn(p, buf[e0:e0 + e_loc])
        return torch.cat([y.new_zeros((e0,) + y.shape[1:]), y,
                          y.new_zeros((E - e0 - e_loc,) + y.shape[1:])])

    y = _moe_dispatch_compute(cfg, router, x.reshape(B * S, D),
                              moe_capacity(cfg, batch * S), expert_fn,
                              _before(shd))
    return y.reshape(B, S, D)


def ep_capacity(cfg: ModelConfig, tokens: int) -> int:
    """``c_loc``, a block's capacity on the expert-parallel path: the
    reference truncates (``int``) where ``moe_capacity`` rounds up."""
    k, E = cfg.top_k, cfg.n_experts
    return max(8, -(-int(cfg.capacity_factor * tokens * k / E) // 8) * 8)


def _apply_moe_ep(cfg: ModelConfig, p, x, shd: ShardingCtx):
    """The expert-parallel MoE on the rank's (B / dp, S, D) activations,
    the same on every rank of its model group: this rank's S / tp tokens
    through :func:`moe_ep_block`, the blocks' outputs joined over the
    sequence."""
    xb = comm.slice_block(shd.mesh, shd.tp, x, 1)  # (B/dp, S/tp, D)
    return comm.gather_blocks(shd.mesh, shd.tp, moe_ep_block(cfg, p, xb, shd),
                              1)


def moe_ep_block(cfg: ModelConfig, p, xb, shd: ShardingCtx):
    """The expert-parallel MoE on this rank's (B / dp, S / tp, D) block of
    tokens (the sequence-parallel carry): route them (a block-local
    ``c_loc``), send each expert's rows to the rank that holds it, run the
    local E / tp experts, send the rows back. The router sees only the
    block's tokens, so its gradient is summed over "model" (and, as every
    weight's, over "data"); the experts' come back through the reverse
    all-to-all and are summed over "data" only."""
    D = xb.shape[-1]
    E = cfg.n_experts
    mesh, tp = shd.mesh, shd.tp_size
    e_loc = E // tp
    c_loc = ep_capacity(cfg, xb.shape[0] * xb.shape[1])
    router = comm.copy_to(mesh, shd.tp, p.router)
    wi, wg, wo = p.wi, p.wg, p.wo

    def expert_fn(buf):  # (E, c_loc, D): this block's rows for every expert
        recv = comm.all_to_all(mesh, shd.tp, buf)
        # block j of recv holds peer j's rows for OUR experts
        mine = recv.reshape(tp, e_loc, c_loc, D).transpose(0, 1).reshape(
            e_loc, tp * c_loc, D)
        h = torch.bmm(mine, wi)
        g = torch.bmm(mine, wg)
        yb = torch.bmm(F.silu(g) * h, wo)
        yb = yb.reshape(e_loc, tp, c_loc, D).transpose(0, 1).reshape(
            E, c_loc, D)
        return comm.all_to_all(mesh, shd.tp, yb)

    y = _moe_dispatch_compute(cfg, router, xb.reshape(-1, D), c_loc,
                              expert_fn)
    return y.reshape(xb.shape)


def apply_moe_ep_plain(cfg: ModelConfig, p, x, dp: int, tp: int):
    """The expert-parallel MoE of a (dp, tp) mesh in one process, with no
    collective: the global (B, S, D) ``x`` cut into dp x tp blocks (batch
    over dp, sequence over tp), each block's tokens routed into its own
    (E, c_loc, D) buffer, the experts run over every block's buffer. The
    plain version that the sharded path is held against."""
    B, S, D = x.shape
    bl, sl = B // dp, S // tp
    c_loc = ep_capacity(cfg, bl * sl)
    rows = []
    for d in range(dp):
        cols = []
        for m in range(tp):
            xb = x[d * bl:(d + 1) * bl, m * sl:(m + 1) * sl]
            y = _moe_dispatch_compute(cfg, p.router, xb.reshape(-1, D), c_loc,
                                      lambda buf: _expert_ffn(p, buf))
            cols.append(y.reshape(bl, sl, D))
        rows.append(torch.cat(cols, dim=1))
    return torch.cat(rows, dim=0)


# --------------------------------------------------------------------------
# Mamba2 (SSD): chunked scan for sequences, O(1) state update for decode
# --------------------------------------------------------------------------

class Mamba(nn.Module):
    """Per-segment projections wz / wx (D, d_inner), wb / wc (D, G*N), wdt
    (D, H); depthwise conv weights (k, C) and biases per segment; A_log, D
    and dt_bias (H,) in f32; the gated norm (d_inner,) and out_proj."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32, device=None):
        super().__init__()
        D, H = cfg.d_model, cfg.ssm_heads
        d_in, gn, k = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state, cfg.ssm_conv
        self.wz = _param((D, d_in), dtype, device)
        self.wx = _param((D, d_in), dtype, device)
        self.wb = _param((D, gn), dtype, device)
        self.wc = _param((D, gn), dtype, device)
        self.wdt = _param((D, H), dtype, device)
        self.conv_wx = _param((k, d_in), dtype, device)
        self.conv_wb = _param((k, gn), dtype, device)
        self.conv_wc = _param((k, gn), dtype, device)
        self.conv_bx = _param((d_in,), dtype, device)
        self.conv_bb = _param((gn,), dtype, device)
        self.conv_bc = _param((gn,), dtype, device)
        self.A_log = _param((H,), torch.float32, device)
        self.D = _param((H,), torch.float32, device)
        self.dt_bias = _param((H,), torch.float32, device)
        self.norm = _param((d_in,), dtype, device)
        self.out_proj = _param((d_in, D), dtype, device)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        for w in (self.wz, self.wx, self.wb, self.wc, self.wdt):
            _dense_(w, gen)
        for w in (self.conv_wx, self.conv_wb, self.conv_wc):
            _dense_(w, gen, scale=0.5)
        for b in (self.conv_bx, self.conv_bb, self.conv_bc, self.dt_bias):
            b.zero_()
        a = torch.rand(self.A_log.shape, generator=gen, dtype=torch.float32,
                       device=self.A_log.device)
        self.A_log.copy_(torch.log(1.0 + 15.0 * a))  # log U(1, 16)
        self.D.fill_(1)
        self.norm.fill_(1)
        _dense_(self.out_proj, gen)


def init_mamba(cfg: ModelConfig, gen: torch.Generator,
               dtype=torch.float32) -> Mamba:
    p = Mamba(cfg, dtype, gen.device)
    p.reset_parameters(gen)
    return p


def _mamba_project(cfg, p, u):
    """Per-segment projections; returns z, x_pre, B_pre, C_pre, dt
    (pre-conv). The depthwise convolution is applied per segment by callers:
    the same math as convolving the concatenation."""
    return u @ p.wz, u @ p.wx, u @ p.wb, u @ p.wc, u @ p.wdt


def _causal_conv(xbc, w, b, window):
    """Depthwise causal conv over sequence: xbc (B,S,C), w (k,C)."""
    S = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, window - 1, 0))
    out = sum(pad[:, i:i + S, :] * w[i][None, None, :] for i in range(window))
    return F.silu(out + b[None, None, :])


def _mamba_conv_all(cfg, p, x, Bm, Cm):
    x = _causal_conv(x, p.conv_wx, p.conv_bx, cfg.ssm_conv)
    Bm = _causal_conv(Bm, p.conv_wb, p.conv_bb, cfg.ssm_conv)
    Cm = _causal_conv(Cm, p.conv_wc, p.conv_bc, cfg.ssm_conv)
    return x, Bm, Cm


def _softplus(x):
    """``jax.nn.softplus``, i.e. ``logaddexp(x, 0)`` written out:
    max(x, 0) + log1p(exp(-|x|)). (``F.softplus`` is log1p(exp(x)), and x
    above its threshold of 20: other roundings.)"""
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


def _chunk_scan(decay, st):
    """The running state after each chunk: s_c = s_{c-1} * decay_c + st_c
    over axis 1. The reference combines the same terms with an associative
    scan; a loop over chunks is the same math in another float order.
    decay (B, nc, H), st (B, nc, H, N, P) -> (B, nc, H, N, P)."""
    out = [st[:, 0]]
    for c in range(1, st.shape[1]):
        out.append(out[-1] * decay[:, c, :, None, None] + st[:, c])
    return torch.stack(out, dim=1)


def _ssd_core(cfg: ModelConfig, x, Bh, Ch, dt, A_log, Dv, dt_bias, dtype):
    """The chunked scan of the heads of ``x`` (B, S, h, P) with their B / C
    (B, S, h, N), raw dt (B, S, h) and per-head ``A_log``, ``D`` and
    ``dt_bias``: (y (B, S, h * P) in ``dtype``, before the gate, the final
    state (B, h, N, P)). Every head on its own: a mesh runs its heads."""
    B, S, H, Pd = x.shape
    N = Bh.shape[-1]
    f32 = torch.promote_types(dtype, torch.float32)  # f64 stays f64
    dt = _softplus(dt.to(f32) + dt_bias)  # (B,S,H)
    A = -torch.exp(A_log)  # (H,) negative
    la = dt * A[None, None, :]  # log decay per step (B,S,H), <= 0
    xdt = x * dt[..., None].to(x.dtype)  # fold dt into input

    Q = min(cfg.ssm_chunk, S)
    if S % Q != 0:
        Q = S
    nc = S // Q
    cum = torch.cumsum(la.reshape(B, nc, Q, H), dim=2)  # inclusive, f32
    tot = cum[:, :, -1, :]  # (B,nc,H)
    xq = xdt.reshape(B, nc, Q, H, Pd).to(f32)
    bq = Bh.reshape(B, nc, Q, H, N).to(f32)
    cq = Ch.reshape(B, nc, Q, H, N).to(f32)

    # intra-chunk: masked semiseparable matmul, decay(i,j) = exp(cum_i -
    # cum_j) for i >= j; the mask goes INSIDE the exp (dif > 0 above the
    # diagonal would overflow it)
    dif = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,Qi,Qj,H)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    dec = torch.exp(dif.masked_fill(~mask[None, None, :, :, None], MASKED))
    scores = torch.einsum("bcihn,bcjhn->bcijh", cq, bq)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores * dec, xq)

    # chunk states: S_c = sum_j exp(tot - cum_j) B_j x_j^T  (H, N, P)
    wj = torch.exp(tot[:, :, None, :] - cum)  # (B,nc,Q,H)
    st = torch.einsum("bcjhn,bcjhp->bchnp", bq * wj[..., None], xq)
    sscan = _chunk_scan(torch.exp(tot), st)
    # the state entering chunk c is sscan at c-1 (zero for c=0)
    s_in = torch.cat([torch.zeros_like(sscan[:, :1]), sscan[:, :-1]], dim=1)
    y_inter = torch.einsum("bcihn,bchnp->bcihp",
                           cq * torch.exp(cum)[..., None], s_in)

    y = (y_intra + y_inter).reshape(B, S, H, Pd)
    y = y + x.to(f32) * Dv[None, None, :, None]
    return y.reshape(B, S, H * Pd).to(dtype), sscan[:, -1]


def _ssd(cfg: ModelConfig, p, u):
    """The chunked SSD forward; returns (out, (x_pre, B_pre, C_pre), final
    SSM state (B, H, N, P) f32). ``apply_mamba`` keeps the output; prefill
    also keeps the pre-conv inputs and the state, which the reference gets
    by running the projections and the scan a second time on the same
    input."""
    B, S, _ = u.shape
    H, Pd, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    z, x_pre, B_pre, C_pre, dt = _mamba_project(cfg, p, u)
    x0, B0, C0 = _mamba_conv_all(cfg, p, x_pre, B_pre, C_pre)
    rep = H // G
    Bh = B0.reshape(B, S, G, N).repeat_interleave(rep, dim=2)  # (B,S,H,N)
    Ch = C0.reshape(B, S, G, N).repeat_interleave(rep, dim=2)
    y, state = _ssd_core(cfg, x0.reshape(B, S, H, Pd), Bh, Ch, dt, p.A_log,
                         p.D, p.dt_bias, u.dtype)
    y = y * F.silu(z)
    y = rms_norm(y, p.norm, cfg.rms_eps)
    return y @ p.out_proj, (x_pre, B_pre, C_pre), state


def apply_mamba(cfg: ModelConfig, p, u):
    """Chunked SSD (state-space duality) forward over a full sequence.

    Within chunks of length Q the semiseparable kernel is applied as a masked
    (Q, Q) matmul; across chunks the (H, N, P) states are carried chunk to
    chunk: O(S Q) + O(S/Q) work instead of a length-S recurrence.
    """
    return _ssd(cfg, p, u)[0]


def mamba_state_init(cfg: ModelConfig, batch, dtype=torch.float32,
                     device=None):
    H, Pd, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    k = cfg.ssm_conv - 1
    return {
        "convx": torch.zeros((batch, k, cfg.d_inner), dtype=dtype,
                             device=device),
        "convb": torch.zeros((batch, k, G * N), dtype=dtype, device=device),
        "convc": torch.zeros((batch, k, G * N), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, H, N, Pd), dtype=torch.float32,
                           device=device),
    }


def _conv_step(seg, state_seg, w, b, window):
    """One-token depthwise conv: returns (activated (B, C), new state)."""
    conv_in = torch.cat([state_seg, seg], dim=1)  # (B, k, C)
    out = sum(conv_in[:, i, :] * w[i][None, :] for i in range(window))
    return F.silu(out + b[None, :]), conv_in[:, 1:, :]


def _ssd_step(x, Bh, Ch, dt, A_log, Dv, dt_bias, ssm, dtype):
    """One token of the heads of ``x`` (B, h, P): s <- exp(dt A) s + dt B x;
    y = C s + D x. Returns (y (B, 1, h * P) in ``dtype``, before the gate,
    the new state (B, h, N, P))."""
    B, H, Pd = x.shape
    f32 = torch.float32
    dt1 = _softplus(dt.to(f32) + dt_bias)  # (B,H)
    A = -torch.exp(A_log)
    decay = torch.exp(dt1 * A[None, :])  # (B,H)
    xf = x.to(f32) * dt1[..., None]
    s_new = ssm * decay[..., None, None] \
        + Bh.to(f32)[..., :, None] * xf[..., None, :]
    y = torch.einsum("bhn,bhnp->bhp", Ch.to(f32), s_new)
    y = y + x.to(f32) * Dv[None, :, None]
    return y.reshape(B, 1, H * Pd).to(dtype), s_new


def apply_mamba_decode(cfg: ModelConfig, p, u, state):
    """Single-token SSD step: s <- exp(dt A) s + dt B x ; y = C s + D x.
    Returns (out (B, 1, D), the new state dict); ``state`` is not written."""
    B = u.shape[0]
    H, Pd, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    z, x0, B0, C0, dt = _mamba_project(cfg, p, u)  # (B,1,*)
    x1, new_cx = _conv_step(x0, state["convx"], p.conv_wx, p.conv_bx,
                            cfg.ssm_conv)
    B1, new_cb = _conv_step(B0, state["convb"], p.conv_wb, p.conv_bb,
                            cfg.ssm_conv)
    C1, new_cc = _conv_step(C0, state["convc"], p.conv_wc, p.conv_bc,
                            cfg.ssm_conv)

    rep = H // G
    Bh = B1.reshape(B, G, N).repeat_interleave(rep, dim=1)  # (B,H,N)
    Ch = C1.reshape(B, G, N).repeat_interleave(rep, dim=1)
    y, s_new = _ssd_step(x1.reshape(B, H, Pd), Bh, Ch, dt[:, 0, :], p.A_log,
                         p.D, p.dt_bias, state["ssm"], u.dtype)
    y = y * F.silu(z)
    y = rms_norm(y, p.norm, cfg.rms_eps)
    out = y @ p.out_proj
    return out, {"convx": new_cx, "convb": new_cb, "convc": new_cc,
                 "ssm": s_new}


# --------------------------------------------------------------------------
# tensor parallelism on a mesh (tp > 1): each rank computes its heads, its
# columns of the FFN and its experts on the rank's blocks of the weights;
# ``p`` is a placed module's view (``sharding.partition.Gathered``)
# --------------------------------------------------------------------------

def enter(shd: ShardingCtx, h, seq_split: bool):
    """The input of a unit's column-parallel products from the carry ``h``:
    the sequence-parallel block gathered whole (``comm.gather_seq``), or a
    replicated carry marked as entering partial work (``comm.copy_to``).
    Either way the backward sums the ranks' partial gradients."""
    if seq_split:
        return comm.gather_seq(shd.mesh, shd.tp, h, 1)
    return comm.copy_to(shd.mesh, shd.tp, h)


def leave(shd: ShardingCtx, y, seq_split: bool):
    """A row-parallel product's partial sums ``y`` back to the carry: this
    rank's block of their sum over the sequence (``comm.scatter_seq``), or
    their replicated sum (``comm.sum_over``: decode, a sequence the model
    axis does not split)."""
    if seq_split:
        return comm.scatter_seq(shd.mesh, shd.tp, y, 1)
    return comm.sum_over(shd.mesh, shd.tp, y)


def shared(shd: ShardingCtx, w):
    """A leaf the reference replicates (a norm's scale, ``A_log``), read by
    work that differs by model rank: its gradient is summed over
    "model"."""
    return comm.copy_to(shd.mesh, shd.tp, w)


@dataclasses.dataclass(frozen=True)
class HeadPlan:
    """Which attention heads each model rank computes. A rank's block of
    ``wq``'s columns (and of ``wo``'s rows) is H * dh / tp wide, which cuts
    a head where dh does not divide it (40 or 56 heads over 16 ranks): a
    head goes whole to the rank that holds its first column, so ranks
    compute different numbers of heads, and the cut half of a head's
    columns moves to that rank (``q_need``). Each rank also takes the K / V
    heads its q heads read (``kv_need``; 2-10 KV heads over 16 ranks cut
    them all). ``heads[r]`` / ``kv[r]``: rank r's q and KV heads;
    ``head_kv[r]``: the index in ``kv[r]`` of each of its q heads."""

    heads: tuple
    kv: tuple
    q_need: tuple
    kv_need: tuple
    head_kv: tuple


@functools.lru_cache(maxsize=None)
def head_plan(n_heads: int, n_kv: int, d_head: int, tp: int) -> HeadPlan:
    block = n_heads * d_head // tp
    heads = tuple(tuple(h for h in range(n_heads) if h * d_head // block == r)
                  for r in range(tp))
    group = n_heads // n_kv
    kv = tuple(tuple(sorted({h // group for h in hs})) for hs in heads)

    def cols(ids):
        return tuple(c for i in ids for c in range(i * d_head,
                                                   (i + 1) * d_head))

    return HeadPlan(heads, kv, tuple(cols(hs) for hs in heads),
                    tuple(cols(k) for k in kv),
                    tuple(tuple(kv[r].index(h // group) for h in heads[r])
                          for r in range(tp)))


def _rank_kv(k, v, head_kv: tuple):
    """K / V (B, T, k, dh) of a rank's KV heads as ``_sdpa`` reads them for
    its q heads: as they are where the q heads fall into equal consecutive
    groups, else one K / V head a q head."""
    nh, nk = len(head_kv), k.shape[2]
    if nh % nk == 0 and head_kv == tuple(i // (nh // nk) for i in range(nh)):
        return k, v
    idx = torch.tensor(head_kv, dtype=torch.int64, device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def apply_attention_tp(cfg, p, xw, positions, shd: ShardingCtx,
                       kv_source=None, causal=True):
    """:func:`apply_attention` for this rank's heads (:func:`head_plan`):
    ``xw`` (B, S, D), the whole sequence of the rank's batch block; q / k /
    v column-parallel on the rank's heads' columns, ``wo`` row-parallel on
    their rows. Returns this rank's partial sum of the output (B, S, D)."""
    plan = head_plan(cfg.n_heads, cfg.n_kv, cfg.d_head, shd.tp_size)
    r = shd.mesh.coord(shd.tp)
    B, S, _ = xw.shape
    nh, nk, dh = len(plan.heads[r]), len(plan.kv[r]), cfg.d_head
    # every rank takes its columns, with or without heads of its own: the
    # exchanges are collectives
    wq, wo = p.take("wq", 1, plan.q_need), p.take("wo", 0, plan.q_need)
    wk, wv = p.take("wk", 1, plan.kv_need), p.take("wv", 1, plan.kv_need)
    src = xw if kv_source is None else kv_source
    T = src.shape[1]
    q, k, v = xw @ wq, src @ wk, src @ wv
    if cfg.qkv_bias:
        q = q + p.take("bq", 0, plan.q_need)
        k = k + p.take("bk", 0, plan.kv_need)
        v = v + p.take("bv", 0, plan.kv_need)
    if nh == 0:  # no head of its own: zeros, with k and v on the graph so
        # that the backward runs every exchange's collective on every rank
        return q @ wo + 0 * (k.sum() + v.sum())
    q = q.reshape(B, S, nh, dh)
    k, v = k.reshape(B, T, nk, dh), v.reshape(B, T, nk, dh)
    if cfg.qk_norm:
        q = rms_norm(q, shared(shd, p.q_norm), cfg.rms_eps)
        k = rms_norm(k, shared(shd, p.k_norm), cfg.rms_eps)
    if kv_source is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        k_pos = positions
    else:
        k_pos = torch.arange(T, device=xw.device)
        causal = False
    k, v = _rank_kv(k, v, plan.head_kv[r])
    o = _sdpa(cfg, q, k, v, positions, k_pos, causal)
    return o @ wo


def kv_cache_blocks(cfg, p, src, shd: ShardingCtx, t_cache: int,
                    seq_split: bool, rotate: bool):
    """This rank's block of a K / V cache of ``t_cache`` slots whose first
    T hold the keys and values of ``src`` (B, T, D), the whole sequence of
    the rank's batch block: each rank projects its own block of wk / wv's
    columns, then an all-to-all over "model" turns (every position, my
    columns) into (my positions, every column) where the cache's sequence
    is over "model" (``seq_split``), else an all-gather gives every rank
    the whole. Then, per whole head, k_norm and (``rotate``) RoPE at the
    slots' positions. Returns {"k", "v"}: (B, t_cache / tp or t_cache, K,
    dh), zeros past T."""
    mesh, tp = shd.mesh, shd.tp_size
    K, dh = cfg.n_kv, cfg.d_head
    k, v = src @ p.wk, src @ p.wv
    if cfg.qkv_bias:
        k, v = k + p.bk, v + p.bv
    B, T, c = k.shape
    both = torch.stack([k, v], dim=2)  # (B, T, 2, c)
    if seq_split:
        n = t_cache // tp
        me = mesh.coord(shd.tp)
        cnt = [max(0, min((j + 1) * n, T) - j * n) for j in range(tp)]
        rows = comm.all_to_all_rows(mesh, shd.tp,
                                    both.transpose(0, 1).contiguous(), cnt,
                                    [cnt[me]] * tp)  # (tp * cnt, B, 2, c)
        whole = rows.reshape(tp, cnt[me], B, 2, c).permute(2, 1, 3, 0, 4)
        t0, t = me * n, cnt[me]
    else:
        n, t0, t = t_cache, 0, T
        whole = comm.all_gather(mesh, shd.tp, both[:, :, :, None], 3)
    whole = whole.reshape(B, t, 2, K, dh)
    k, v = whole[:, :, 0], whole[:, :, 1]
    if cfg.qk_norm:
        k = rms_norm(k, p.k_norm, cfg.rms_eps)
    if rotate:
        k = rope(k, t0 + torch.arange(t, device=src.device), cfg.rope_theta)
    out = {}
    for name, x in (("k", k), ("v", v)):
        out[name] = x.new_zeros((B, n, K, dh))
        out[name][:, :t] = x
    return out


def _decode_qkv(cfg, p, x, shd: ShardingCtx, kv: bool):
    """q (B, 1, H, dh) of every head, after q_norm, and (``kv``) the new k
    / v (B, 1, K, dh), after k_norm: each rank projects its own blocks of
    the columns and one all-gather (a few KB) joins them."""
    B = x.shape[0]
    H, K, dh = cfg.n_heads, cfg.n_kv, cfg.d_head
    parts = [x @ p.wq + (p.bq if cfg.qkv_bias else 0)]
    if kv:
        parts += [x @ p.wk + (p.bk if cfg.qkv_bias else 0),
                  x @ p.wv + (p.bv if cfg.qkv_bias else 0)]
    sizes = [t.shape[-1] for t in parts]
    every = comm.all_gather(shd.mesh, shd.tp, torch.cat(parts, -1)[:, :, None],
                            2)  # (B, 1, tp, sum of sizes)
    split = torch.split(every, sizes, dim=-1)
    q = split[0].reshape(B, 1, H, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.rms_eps)
    if not kv:
        return q, None, None
    k = split[1].reshape(B, 1, K, dh)
    v = split[2].reshape(B, 1, K, dh)
    if cfg.qk_norm:
        k = rms_norm(k, p.k_norm, cfg.rms_eps)
    return q, k, v


def _decode_attend(cfg, p, q, ck, cv, valid, shd: ShardingCtx,
                   seq_split: bool):
    """Every head of ``q`` (B, 1, H, dh) over this rank's slots of ``ck`` /
    ``cv`` (B, n, K, dh) (``valid``: the slots it may read, None for all),
    and this rank's rows of ``wo``: its partial sum of the output. Where
    the slots are the rank's block of the sequence, the blocks' softmax
    partials (the outputs unnormalised, maxima, sums) are all-gathered and
    combined by log-sum-exp in rank order; where every rank holds every
    slot, each computes the reference's softmax whole."""
    B, n, K, dh = ck.shape
    H = cfg.n_heads
    qg = q.reshape(B, 1, K, H // K, dh)
    s = torch.einsum("bckgd,btkd->bkgct", qg, ck).to(torch.float32)
    s = s / math.sqrt(dh)
    if valid is not None:
        s = s.masked_fill(~valid, MASKED)
    if not seq_split:
        a = torch.softmax(s, dim=-1).to(cv.dtype)
        o = torch.einsum("bkgct,btkd->bckgd", a, cv).reshape(B, 1, H * dh)
    else:
        m = s.amax(dim=-1, keepdim=True)
        e = torch.exp(s - m)
        part = torch.einsum("bkgct,btkd->bckgd", e.to(cv.dtype), cv)
        pack = torch.cat([part.to(torch.float32).reshape(B, H * dh),
                          m.reshape(B, H), e.sum(dim=-1).reshape(B, H)], -1)
        every = comm.all_gather(shd.mesh, shd.tp, pack[None], 0)
        o_r, m_r, l_r = torch.split(every, [H * dh, H, H], dim=-1)
        top = m_r.amax(dim=0)
        num = den = 0
        for j in range(every.shape[0]):  # fixed rank order
            w = torch.exp(m_r[j] - top)
            num = num + w.repeat_interleave(dh, dim=-1) * o_r[j]
            den = den + w * l_r[j]
        o = (num / den.repeat_interleave(dh, dim=-1)).to(cv.dtype)
        o = o.reshape(B, 1, H * dh)
    c = H * dh // shd.tp_size
    lo = shd.mesh.coord(shd.tp) * c
    return o[..., lo:lo + c] @ p.wo


def apply_attention_decode_tp(cfg, p, x, cache, pos: int,
                              shd: ShardingCtx, seq_split: bool):
    """:func:`apply_attention_decode` on this rank's block of the cache
    (``seq_split``: the slots [r * n, (r + 1) * n) of the sequence; else
    the whole): q of every head and the new K / V gathered, slot ``pos``
    written IN PLACE by the rank that holds it, every head attended over
    the rank's slots. Returns this rank's partial sum of the output."""
    q, k_new, v_new = _decode_qkv(cfg, p, x, shd, kv=True)
    pos_arr = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    q = rope(q, pos_arr, cfg.rope_theta)
    k_new = rope(k_new, pos_arr, cfg.rope_theta)
    ck, cv = cache["k"], cache["v"]
    n = ck.shape[1]
    lo = shd.mesh.coord(shd.tp) * n if seq_split else 0
    if lo <= pos < lo + n:
        ck[:, pos - lo] = k_new[:, 0].to(ck.dtype)
        cv[:, pos - lo] = v_new[:, 0].to(cv.dtype)
    valid = lo + torch.arange(n, device=x.device) <= pos
    return _decode_attend(cfg, p, q, ck, cv, valid, shd, seq_split)


def apply_cross_attention_decode_tp(cfg, p, x, cache, shd: ShardingCtx,
                                    seq_split: bool):
    """:func:`apply_cross_attention_decode` on this rank's block of the
    static cross-attention cache: this rank's partial sum of the output."""
    q, _, _ = _decode_qkv(cfg, p, x, shd, kv=False)
    return _decode_attend(cfg, p, q, cache["xk"], cache["xv"], None, shd,
                          seq_split)


def _gated_norm_tp(cfg, y, z, scale, shd: ShardingCtx):
    """``rms_norm(y * silu(z), norm)`` over the whole d_inner, of which this
    rank holds a block of channels: the sum of squares all-reduced over
    "model", the rest per channel. Every rank scales its own channels by
    the sum, so its gradient is summed over "model" too."""
    y = y * F.silu(z)
    yf = y.float()
    ss = comm.sum_over(shd.mesh, shd.tp, (yf * yf).sum(-1))
    var = shared(shd, ss) / cfg.d_inner
    inv = torch.rsqrt(var + cfg.rms_eps)[..., None].to(y.dtype)
    return y * inv * scale.to(y.dtype)


def _rank_heads(cfg, shd: ShardingCtx):
    """(first SSD head, heads) of this rank, and each one's B / C group
    (a tensor)."""
    hl = cfg.ssm_heads // shd.tp_size
    h0 = shd.mesh.coord(shd.tp) * hl
    per = cfg.ssm_heads // cfg.ssm_groups
    return h0, hl, [(h0 + i) // per for i in range(hl)]


def _group_rows(cfg, bc, groups, dim: int):
    """The rows of B / C ``bc`` (..., G * N) for heads in ``groups``: (...,
    h, N), inserted at ``dim``."""
    shape = bc.shape[:-1] + (cfg.ssm_groups, cfg.ssm_state)
    idx = torch.tensor(groups, dtype=torch.int64, device=bc.device)
    return bc.reshape(shape).index_select(dim, idx)


def apply_mamba_tp(cfg, p, u, shd: ShardingCtx, collect: bool = False):
    """:func:`apply_mamba` for this rank's SSD heads: ``u`` (B, S, D), the
    whole sequence of the rank's batch block; ``wz`` / ``wx`` / ``wdt`` and
    the convolutions on the rank's channels, ``wb`` / ``wc`` on its block
    of the B / C columns, whose convolved outputs are all-gathered (the
    heads read their group's, which a block may cut), the gated norm over
    the whole d_inner, ``out_proj`` row-parallel. Returns (this rank's
    partial sum of the output, and with ``collect`` its blocks of the
    decode state: the last ssm_conv - 1 pre-conv inputs of its channels,
    its heads' final state)."""
    B, S, _ = u.shape
    Pd, k = cfg.ssm_head_dim, cfg.ssm_conv
    z, x_pre, B_pre, C_pre, dt = _mamba_project(cfg, p, u)
    x0, B0, C0 = _mamba_conv_all(cfg, p, x_pre, B_pre, C_pre)
    bc = comm.gather_seq(shd.mesh, shd.tp, torch.stack([B0, C0], 2), 3)
    h0, hl, groups = _rank_heads(cfg, shd)
    bc = _group_rows(cfg, bc, groups, 3)  # (B, S, 2, h, N)
    sl = slice(h0, h0 + hl)
    y, state = _ssd_core(cfg, x0.reshape(B, S, hl, Pd), bc[:, :, 0],
                         bc[:, :, 1], dt, shared(shd, p.A_log)[sl],
                         shared(shd, p.D)[sl], shared(shd, p.dt_bias)[sl],
                         u.dtype)
    out = _gated_norm_tp(cfg, y, z, p.norm, shd) @ p.out_proj
    if not collect:
        return out, None
    return out, {"convx": x_pre[:, S - k + 1:].clone(),
                 "convb": B_pre[:, S - k + 1:].clone(),
                 "convc": C_pre[:, S - k + 1:].clone(), "ssm": state}


def apply_mamba_decode_tp(cfg, p, u, state, shd: ShardingCtx):
    """:func:`apply_mamba_decode` on this rank's blocks of the state (its
    channels' conv windows, its heads' SSM state): the new B / C columns
    all-gathered (a few KB). Returns (this rank's partial sum of the
    output, its new blocks of the state)."""
    B = u.shape[0]
    Pd, k = cfg.ssm_head_dim, cfg.ssm_conv
    z, x0, B0, C0, dt = _mamba_project(cfg, p, u)  # (B,1,*)
    x1, new_cx = _conv_step(x0, state["convx"], p.conv_wx, p.conv_bx, k)
    B1, new_cb = _conv_step(B0, state["convb"], p.conv_wb, p.conv_bb, k)
    C1, new_cc = _conv_step(C0, state["convc"], p.conv_wc, p.conv_bc, k)
    bc = comm.all_gather(shd.mesh, shd.tp, torch.stack([B1, C1], 1), 2)
    h0, hl, groups = _rank_heads(cfg, shd)
    bc = _group_rows(cfg, bc, groups, 2)  # (B, 2, h, N)
    sl = slice(h0, h0 + hl)
    y, s_new = _ssd_step(x1.reshape(B, hl, Pd), bc[:, 0], bc[:, 1],
                         dt[:, 0, :], p.A_log[sl], p.D[sl], p.dt_bias[sl],
                         state["ssm"], u.dtype)
    out = _gated_norm_tp(cfg, y, z, p.norm, shd) @ p.out_proj
    return out, {"convx": new_cx, "convb": new_cb, "convc": new_cc,
                 "ssm": s_new}
