"""The tolerances that hold the port's f32 training loss and gradients to
another run of the same function: to the JAX package's on the CPU
(``test_torch_lm_train_loss.py``, ``test_torch_lm_train_hybrid.py``), and
the card's to the CPU's (``test_torch_cuda.py -k lm``, ``chip_smoke.py``
phase 28). One definition for all of them; this file imports no JAX, so
the card's machine reads it too.

``train_tol(cfg)`` is (loss rtol, gradient rtol, gradient atol as a share
of the leaf's largest magnitude): 1e-5, 1e-4, 1e-5; a model with Mamba
layers 1e-4, 1e-4, 1e-3 (the chunk scan sums in another float order than
the reference's associative scan; ``test_torch_lm_dense.MAMBA_TOL``).
"""
import pytest

from repro_torch.configs import ARCHS, get_smoke


def train_tol(cfg) -> tuple[float, float, float]:
    """(loss rtol, gradient rtol, gradient atol as a share of the leaf's
    largest magnitude) for ``cfg``."""
    return (1e-4, 1e-4, 1e-3) if cfg.has("mamba") else (1e-5, 1e-4, 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_only_models_with_mamba_layers_get_the_wider_tolerance(arch):
    cfg = get_smoke(arch)
    wide = arch in ("jamba15_large_398b", "mamba2_1_3b")
    assert cfg.has("mamba") == wide
    assert train_tol(cfg) == ((1e-4, 1e-4, 1e-3) if wide
                              else (1e-5, 1e-4, 1e-5))
