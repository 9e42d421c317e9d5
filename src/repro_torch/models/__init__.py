"""LM-family model substrate (dense / MoE / SSM / hybrid / VLM / encoder):
the serving path of ``repro.models`` on PyTorch. ``train_loss`` and the
sharding context come with the training and mesh slices."""
from repro_torch.models.transformer import (
    decode_step,
    forward_logits,
    init_cache,
    init_params,
    param_count,
    prefill,
)

__all__ = [
    "init_params", "forward_logits", "prefill", "decode_step", "init_cache",
    "param_count",
]
