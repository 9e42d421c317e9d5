"""mamba2-1.3b [ssm]: 48L d_model=2048, attention-free, vocab=50280,
ssm_state=128 — SSD state-space duality [arXiv:2405.21060].

d_inner = 2*d_model = 4096, head_dim 64 -> 64 SSD heads.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=16,  # unused: attention-free
    n_kv=16,
    d_head=128,
    d_ff=0,
    vocab=50280,
    pattern=(("mamba", "none"),),
    ssm_state=128,
    ssm_heads=64,
    ssm_head_dim=64,
    ssm_groups=1,
)

SMOKE = dataclasses.replace(
    CONFIG, name="mamba2-smoke", n_layers=2, d_model=64, vocab=64,
    ssm_state=16, ssm_heads=8, ssm_head_dim=16, ssm_groups=1,
)
