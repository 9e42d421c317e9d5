"""llama-3.2-vision-90b [vlm]: 100L d_model=8192 64H (kv=8) d_ff=28672
vocab=128256; cross-attention image layers every 5th layer
[hf:meta-llama/Llama-3.2-11B-Vision, scaled per assignment].

The vision encoder is a STUB: ``input_specs`` supplies precomputed patch
embeddings (B, n_vision_tokens, d_model) consumed by the xattn layers.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

_UNIT = (("attn", "mlp"),) * 4 + (("xattn", "mlp"),)

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    d_head=128,
    d_ff=28672,
    vocab=128256,
    pattern=_UNIT,
    rope_theta=500000.0,
    n_vision_tokens=1601,
)

SMOKE = dataclasses.replace(
    CONFIG, name="llama-vision-smoke", n_layers=5, d_model=64, n_heads=8,
    n_kv=2, d_head=8, d_ff=128, vocab=128, n_vision_tokens=17,
)
