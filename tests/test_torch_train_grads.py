"""The port's loss_fn and every gradient leaf against jax.value_and_grad
of the reference on the dense, windowed, encoder-decoder and VLM reduced
architectures of tests/test_models.py (the MoE and recurrent ones are in
test_torch_train_grads_mixed.py)."""
import pytest

from _train_grads import check_arch


@pytest.mark.parametrize("arch", ["granite-8b", "h2o-danube-1.8b",
                                  "granite-20b", "paligemma-3b",
                                  "codeqwen1.5-7b", "whisper-base"])
def test_loss_and_grads_equal_reference(arch):
    check_arch(arch)
