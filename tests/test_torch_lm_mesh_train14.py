"""The sharded training step against the reference's at (dp, tp) = (1, 4)
(the model axis over every rank): the loss, every gradient and one AdamW
step, as ``test_torch_lm_mesh_train.py`` checks them at (2, 2)."""
from test_torch_lm_mesh_train import check_step


def test_sharded_loss_gradients_and_adamw_match_reference_at_1x4(tmp_path):
    check_step(tmp_path, (1, 4))
