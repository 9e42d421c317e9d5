"""internlm2-1.8b [dense]: 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92544 [arXiv:2403.17297]."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv=8,
    d_head=128,
    d_ff=8192,
    vocab=92544,
    pattern=(("attn", "mlp"),),
    rope_theta=1e6,
)

SMOKE = dataclasses.replace(
    CONFIG, name="internlm2-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=2,
    d_head=16, d_ff=128, vocab=96,
)
