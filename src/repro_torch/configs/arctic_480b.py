"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000;
MoE 128 experts top-2 PLUS an always-on dense residual FFN in parallel
[hf:Snowflake/snowflake-arctic-base]."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv=8,
    d_head=128,
    d_ff=4864,
    vocab=32000,
    pattern=(("attn", "moe_dense"),),
    n_experts=128,
    top_k=2,
    d_expert=4864,
    dense_d_ff=4864,
)

SMOKE = dataclasses.replace(
    CONFIG, name="arctic-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=2,
    d_head=16, d_ff=96, vocab=64, n_experts=8, top_k=2, d_expert=96,
    dense_d_ff=96,
)
