"""See the package docstring."""

from inverse_audio_synthesis_tpu_torch.train.optim import make_optimizer
from inverse_audio_synthesis_tpu_torch.train.runsetup import runsetup

__all__ = ["make_optimizer", "runsetup"]
