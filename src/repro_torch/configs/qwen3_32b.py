"""qwen3-32b [dense]: 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936; qk_norm + GQA [hf:Qwen/Qwen3 family]."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv=8,
    d_head=128,
    d_ff=25600,
    vocab=151936,
    pattern=(("attn", "mlp"),),
    qk_norm=True,
    rope_theta=1e6,
)

SMOKE = dataclasses.replace(
    CONFIG, name="qwen3-smoke", n_layers=2, d_model=64, n_heads=8, n_kv=2,
    d_head=16, d_ff=192, vocab=64,
)
