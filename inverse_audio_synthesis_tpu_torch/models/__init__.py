"""See the package docstring."""

from inverse_audio_synthesis_tpu_torch.models.audio_to_params import AudioRepresentationToParams
from inverse_audio_synthesis_tpu_torch.models.audioembed import AudioEmbedding
from inverse_audio_synthesis_tpu_torch.models.mobilenetv3 import MobileNetV3Small
from inverse_audio_synthesis_tpu_torch.models.paramembed import ParamEmbed
from inverse_audio_synthesis_tpu_torch.models.vicreg import Projector, VICRegModule, vicreg_loss

__all__ = [
    "AudioRepresentationToParams",
    "AudioEmbedding",
    "MobileNetV3Small",
    "ParamEmbed",
    "Projector",
    "VICRegModule",
    "vicreg_loss",
]
