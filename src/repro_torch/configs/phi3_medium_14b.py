"""phi3-medium-14b [dense]: 40L d_model=5120 40H (GQA kv=10) d_ff=17920
vocab=100352; RoPE + SwiGLU + GQA [arXiv:2404.14219]."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv=10,
    d_head=128,
    d_ff=17920,
    vocab=100352,
    pattern=(("attn", "mlp"),),
)

SMOKE = dataclasses.replace(
    CONFIG, name="phi3-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=2,
    d_head=16, d_ff=192, vocab=64,
)
