"""jamba's sharded loss and every gradient (Mamba and attention mixers,
MLP and expert-parallel MoE layers in one unit) against the reference's
at (dp, tp) = (2, 2), FSDP over "data", as ``test_torch_lm_mesh_train.py``
checks the other configs; its reference compile (~25 s) gets a file of
its own."""
from test_torch_lm_mesh_train import check_step


def test_jamba_sharded_loss_and_gradients_match_reference_at_2x2(tmp_path):
    check_step(tmp_path, (2, 2), archs=("jamba15_large_398b",), adam=False)
