"""See the package docstring."""

from inverse_audio_synthesis_tpu_torch.models.ast import AST
from inverse_audio_synthesis_tpu_torch.models.audio_to_params import AudioRepresentationToParams
from inverse_audio_synthesis_tpu_torch.models.audioembed import AudioEmbedding
from inverse_audio_synthesis_tpu_torch.models.htsat import HTSAT
from inverse_audio_synthesis_tpu_torch.models.mobilenetv3 import MobileNetV3Small
from inverse_audio_synthesis_tpu_torch.models.paramembed import ParamEmbed
from inverse_audio_synthesis_tpu_torch.models.vicreg import Projector, VICRegModule, vicreg_loss

__all__ = [
    "AST",
    "AudioRepresentationToParams",
    "AudioEmbedding",
    "HTSAT",
    "MobileNetV3Small",
    "ParamEmbed",
    "Projector",
    "VICRegModule",
    "vicreg_loss",
]
