"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536; MoE 16 experts top-2; Mamba:attention 1:7 interleave
[arXiv:2403.19887].

Unit = 8 layers: attention at index 3, Mamba elsewhere; MoE FFN on odd
layers, dense SwiGLU on even (16e top-2, expert hidden = d_ff). Like the JAX
package, the port uses the Mamba2/SSD mixer here: the SSD formulation
subsumes Mamba1's recurrence.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

_UNIT = tuple(
    ("attn" if j == 3 else "mamba", "moe" if j % 2 == 1 else "mlp")
    for j in range(8)
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    d_head=128,
    d_ff=24576,
    vocab=65536,
    pattern=_UNIT,
    n_experts=16,
    top_k=2,
    d_expert=24576,
    ssm_state=128,
    ssm_heads=256,  # d_inner = 2*d_model = 16384, head_dim 64
    ssm_head_dim=64,
    ssm_groups=8,
    ssm_chunk=64,
)

SMOKE = dataclasses.replace(
    CONFIG, name="jamba-smoke", n_layers=8, d_model=64, n_heads=4, n_kv=2,
    d_head=16, d_ff=128, vocab=64, n_experts=4, top_k=2, d_expert=128,
    ssm_state=16, ssm_heads=8, ssm_head_dim=16, ssm_groups=2,
)
