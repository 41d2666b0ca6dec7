"""The port's loss_fn (with the MoE router's aux loss) and every gradient
leaf against jax.value_and_grad of the reference on the MoE, hybrid Mamba
and xLSTM reduced architectures of tests/test_models.py."""
import pytest

from _train_grads import check_arch


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "granite-moe-3b-a800m",
                                  "xlstm-125m", "phi3.5-moe-42b-a6.6b"])
def test_loss_and_grads_equal_reference(arch):
    check_arch(arch)
