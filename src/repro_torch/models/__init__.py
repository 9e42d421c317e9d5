"""LM-family model substrate (dense / MoE / SSM / hybrid / VLM / encoder):
the serving and training paths of ``repro.models`` on PyTorch, on one
device or, with a ``layers.ShardingCtx``, on a mesh."""
from repro_torch.models.layers import ShardingCtx
from repro_torch.models.transformer import (
    REMAT_POLICIES,
    chunked_ce_loss,
    decode_step,
    forward_logits,
    init_cache,
    init_params,
    leaf_paths,
    param_count,
    prefill,
    train_loss,
)

__all__ = [
    "ShardingCtx", "init_params", "forward_logits", "prefill", "decode_step", "init_cache",
    "param_count", "leaf_paths", "train_loss", "chunked_ce_loss",
    "REMAT_POLICIES",
]
