"""See the package docstring."""

from inverse_audio_synthesis_tpu_torch.ops.imgscale8 import scale8, unscale8
from inverse_audio_synthesis_tpu_torch.ops.pqmf import PQMF

__all__ = ["PQMF", "scale8", "unscale8"]
