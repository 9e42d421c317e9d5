"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936; MoE 128 experts top-8; qk_norm [hf:Qwen/Qwen3-MoE family]."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv=4,
    d_head=128,
    d_ff=1536,
    vocab=151936,
    pattern=(("attn", "moe"),),
    qk_norm=True,
    n_experts=128,
    top_k=8,
    d_expert=1536,
    rope_theta=1e6,
)

SMOKE = dataclasses.replace(
    CONFIG, name="qwen3moe-smoke", n_layers=2, d_model=64, n_heads=8, n_kv=2,
    d_head=16, d_ff=96, vocab=64, n_experts=8, top_k=2, d_expert=96,
)
