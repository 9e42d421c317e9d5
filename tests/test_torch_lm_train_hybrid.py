"""The port's training loss and gradients against the JAX package's on the
MoE, SSM and hybrid smoke configs (the harness and the tolerances are
``test_torch_lm_train_loss.py``'s): every gradient leaf under each remat
choice, and the three choices against each other."""
import pytest

from test_torch_lm_train_loss import (
    check_loss_and_grads,
    check_remat_choices_agree,
)

HYBRID = ("arctic_480b", "qwen3_moe_235b", "jamba15_large_398b",
          "mamba2_1_3b")


@pytest.mark.parametrize("arch", HYBRID)
def test_loss_and_every_gradient_match_reference(arch):
    check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", ["qwen3_moe_235b", "jamba15_large_398b"])
def test_remat_choices_agree(arch):
    check_remat_choices_agree(arch)
