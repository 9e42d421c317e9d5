"""hubert-xlarge [audio]: 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504.

Encoder-only (bidirectional), same backbone as wav2vec2 [arXiv:2106.07447].
The CNN feature extractor is a STUB: ``input_specs`` supplies precomputed
frame embeddings (B, S, d_model); the model predicts the 504 cluster units.
No decode shapes (no autoregressive step).
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv=16,
    d_ff=5120,
    d_head=80,
    vocab=504,
    pattern=(("attn", "mlp"),),
    qkv_bias=True,
    causal=False,
    encoder_only=True,
    embeddings_in=True,
)

SMOKE = dataclasses.replace(
    CONFIG, name="hubert-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=4,
    d_head=16, d_ff=128, vocab=32,
)
