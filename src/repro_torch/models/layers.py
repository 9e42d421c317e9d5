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
``p`` is a placed module's view (``sharding.partition.Gathered``) and the
MoE takes the reference's expert-parallel path where its gate lets it
(``_apply_moe_ep``: two ``all_to_all_single``s over the model group).
``shd=None`` is the single-device path.
"""
from __future__ import annotations

import dataclasses
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
        ranks = ranks + before(torch.bincount(eid, minlength=E))[eid]
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
    shapes). Two paths, as the reference's:

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
      counts of the blocks before it, gathered over "data").
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
    before = None
    if shd.split and shd.dp_size > 1:
        mesh = shd.mesh

        def before(counts):
            every = comm.all_gather(mesh, "data", counts[None], 0)
            return every[:mesh.coord("data")].sum(dim=0)
    T = B * S
    y = _moe_dispatch_compute(cfg, p.router, x.reshape(T, D),
                              moe_capacity(cfg, batch * S),
                              lambda buf: _expert_ffn(p, buf), before)
    return y.reshape(B, S, D)


def ep_capacity(cfg: ModelConfig, tokens: int) -> int:
    """``c_loc``, a block's capacity on the expert-parallel path: the
    reference truncates (``int``) where ``moe_capacity`` rounds up."""
    k, E = cfg.top_k, cfg.n_experts
    return max(8, -(-int(cfg.capacity_factor * tokens * k / E) // 8) * 8)


def _apply_moe_ep(cfg: ModelConfig, p, x, shd: ShardingCtx):
    """The expert-parallel MoE on the rank's (B / dp, S, D) activations,
    the same on every rank of its model group: route this rank's S / tp
    tokens (a block-local ``c_loc``), send each expert's rows to the rank
    that holds it, run the local E / tp experts, send the rows back, and
    join the blocks' outputs over the sequence. The router sees only the
    block's tokens, so its gradient is summed over "model" (and, as every
    weight's, over "data"); the experts' come back through the reverse
    all-to-all and are summed over "data" only."""
    B, S, D = x.shape
    E = cfg.n_experts
    mesh, tp = shd.mesh, shd.tp_size
    e_loc = E // tp
    xb = comm.slice_block(mesh, shd.tp, x, 1)  # (B/dp, S/tp, D)
    c_loc = ep_capacity(cfg, xb.shape[0] * xb.shape[1])
    router = comm.copy_to(mesh, shd.tp, p.router)
    wi, wg, wo = p.local("wi"), p.local("wg"), p.local("wo")

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
    return comm.gather_blocks(mesh, shd.tp, y.reshape(xb.shape), 1)


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


def _ssd(cfg: ModelConfig, p, u):
    """The chunked SSD forward; returns (out, (x_pre, B_pre, C_pre), final
    SSM state (B, H, N, P) f32). ``apply_mamba`` keeps the output; prefill
    also keeps the pre-conv inputs and the state, which the reference gets
    by running the projections and the scan a second time on the same
    input."""
    B, S, _ = u.shape
    H, Pd, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    d_in = cfg.d_inner
    f32 = torch.promote_types(u.dtype, torch.float32)  # f64 stays f64
    z, x_pre, B_pre, C_pre, dt = _mamba_project(cfg, p, u)
    x0, B0, C0 = _mamba_conv_all(cfg, p, x_pre, B_pre, C_pre)
    x = x0.reshape(B, S, H, Pd)
    rep = H // G
    Bh = B0.reshape(B, S, G, N).repeat_interleave(rep, dim=2)  # (B,S,H,N)
    Ch = C0.reshape(B, S, G, N).repeat_interleave(rep, dim=2)

    dt = _softplus(dt.to(f32) + p.dt_bias)  # (B,S,H)
    A = -torch.exp(p.A_log)  # (H,) negative
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
    mask = torch.ones((Q, Q), dtype=torch.bool, device=u.device).tril()
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
    y = y + x.to(f32) * p.D[None, None, :, None]
    y = y.reshape(B, S, d_in).to(u.dtype)
    y = y * F.silu(z)
    y = rms_norm(y, p.norm, cfg.rms_eps)
    return y @ p.out_proj, (x_pre, B_pre, C_pre), sscan[:, -1]


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


def apply_mamba_decode(cfg: ModelConfig, p, u, state):
    """Single-token SSD step: s <- exp(dt A) s + dt B x ; y = C s + D x.
    Returns (out (B, 1, D), the new state dict); ``state`` is not written."""
    B = u.shape[0]
    H, Pd, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    d_in = cfg.d_inner
    f32 = torch.float32
    z, x0, B0, C0, dt = _mamba_project(cfg, p, u)  # (B,1,*)
    x1, new_cx = _conv_step(x0, state["convx"], p.conv_wx, p.conv_bx,
                            cfg.ssm_conv)
    B1, new_cb = _conv_step(B0, state["convb"], p.conv_wb, p.conv_bb,
                            cfg.ssm_conv)
    C1, new_cc = _conv_step(C0, state["convc"], p.conv_wc, p.conv_bc,
                            cfg.ssm_conv)

    x = x1.reshape(B, H, Pd)
    rep = H // G
    Bh = B1.reshape(B, G, N).repeat_interleave(rep, dim=1)  # (B,H,N)
    Ch = C1.reshape(B, G, N).repeat_interleave(rep, dim=1)
    dt1 = _softplus(dt[:, 0, :].to(f32) + p.dt_bias)  # (B,H)
    A = -torch.exp(p.A_log)
    decay = torch.exp(dt1 * A[None, :])  # (B,H)
    xf = x.to(f32) * dt1[..., None]
    s_new = state["ssm"] * decay[..., None, None] \
        + Bh.to(f32)[..., :, None] * xf[..., None, :]
    y = torch.einsum("bhn,bhnp->bhp", Ch.to(f32), s_new)
    y = y + x.to(f32) * p.D[None, :, None]
    y = y.reshape(B, 1, d_in).to(u.dtype)
    y = y * F.silu(z)
    y = rms_norm(y, p.norm, cfg.rms_eps)
    out = y @ p.out_proj
    return out, {"convx": new_cx, "convb": new_cb, "convc": new_cc,
                 "ssm": s_new}
