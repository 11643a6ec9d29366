"""The port's training against the JAX package on the CPU at the published
configs' dtype, bfloat16: an attention config, xLSTM and the seamless
encoder-decoder — loss, metrics, every gradient leaf and its dtype from
converted weights, ``forward_train``'s dtypes — and the Trainer on
phi3 and on xlstm-350m, which ``chip_smoke.py`` trains whole in bfloat16.
The tolerances and why they are as loose as the JAX package's own jit
and op-by-op runs are far apart: ``torch_training_parity.py``; the casts
bit for bit: ``test_torch_training.py``."""
import pytest

torch = pytest.importorskip("torch")

import torch_training_parity as tp  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: several test workers on one
    machine would otherwise oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "xlstm-350m",
                                  "seamless-m4t-large-v2"])
def test_bf16_loss_and_grads_match(arch):
    """The attention arm's casts under autograd and the head's float32
    logits (phi3), the mLSTM/sLSTM casts (xLSTM), the frames cast to the
    model's dtype before the encoder (seamless)."""
    tp.check_loss_and_grads(arch, dtype="bfloat16")


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "xlstm-350m"])
def test_bf16_trainer_steps_match(arch):
    """AdamW's float32 math cast back to each bfloat16 leaf, five steps."""
    tp.check_trainer(arch, dtype="bfloat16")
