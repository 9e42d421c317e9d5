"""qwen2.5-14b [dense]: 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064; QKV bias [hf:Qwen/Qwen2.5 family]."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv=8,
    d_head=128,
    d_ff=13824,
    vocab=152064,
    pattern=(("attn", "mlp"),),
    qkv_bias=True,
    rope_theta=1e6,
)

SMOKE = dataclasses.replace(
    CONFIG, name="qwen25-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=2,
    d_head=16, d_ff=160, vocab=64,
)
