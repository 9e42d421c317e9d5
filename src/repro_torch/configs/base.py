"""Model/config schema shared by all assigned architectures (the port's own
copy of ``repro.configs.base``; field for field the same).

A model is a repeating *unit* of layers (``pattern``) applied ``n_units``
times; the port runs the units as a Python loop over ``nn.Module``s. Each
pattern entry is ``(mixer, ffn)`` with mixer in {"attn", "xattn", "mamba"}
and ffn in {"mlp", "moe", "moe_dense", "none"}.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Mixer = Literal["attn", "xattn", "mamba"]
Ffn = Literal["mlp", "moe", "moe_dense", "none"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_head: int
    d_ff: int
    vocab: int
    pattern: tuple[tuple[str, str], ...] = (("attn", "mlp"),)
    # attention
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    causal: bool = True
    attn_chunk: int = 512  # query-chunked attention block
    ce_chunk: int = 512  # sequence-chunked cross-entropy block
    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    dense_d_ff: int = 0  # arctic-style always-on dense residual FFN
    capacity_factor: float = 1.25
    # Mamba2 / SSD
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 128
    # cross-attention (vision) — mixer "xattn" attends to stub patch embeddings
    n_vision_tokens: int = 0
    # encoder-only (no causal mask, no decode path, embeddings-in)
    encoder_only: bool = False
    embeddings_in: bool = False  # input is precomputed frame/patch embeddings
    rms_eps: float = 1e-5
    tie_embeddings: bool = False

    def __post_init__(self):
        if self.n_layers % len(self.pattern) != 0:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"pattern length {len(self.pattern)}"
            )

    @property
    def n_units(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def vocab_pad(self) -> int:
        """Vocab rounded up to a multiple of 256 so the embedding/LM-head can
        always shard 16-way (padded ids are real-but-unused logits)."""
        return -(-self.vocab // 256) * 256

    @property
    def d_inner(self) -> int:  # mamba inner width
        return self.ssm_heads * self.ssm_head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.ssm_groups * self.ssm_state

    def has(self, kind: str) -> bool:
        return any(kind in entry for layer in self.pattern for entry in layer)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def runnable_shapes(cfg: ModelConfig) -> dict[str, str]:
    """shape name -> '' if runnable else skip reason."""
    out: dict[str, str] = {}
    full_attention = cfg.has("attn") and not cfg.has("mamba")
    for s in SHAPES.values():
        reason = ""
        if s.kind == "decode" and cfg.encoder_only:
            reason = "encoder-only arch has no autoregressive decode step"
        elif s.name == "long_500k" and full_attention:
            reason = ("long_500k requires sub-quadratic attention; "
                      "arch is pure full-attention")
        out[s.name] = reason
    return out
