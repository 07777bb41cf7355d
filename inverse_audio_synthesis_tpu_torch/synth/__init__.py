"""The Voice synthesizer."""

from inverse_audio_synthesis_tpu_torch.synth.config import SynthConfig
from inverse_audio_synthesis_tpu_torch.synth.parameter import ParamSpec, from_0to1, to_0to1
from inverse_audio_synthesis_tpu_torch.synth.voice import VOICE_PARAM_SPECS, Voice

__all__ = ["SynthConfig", "ParamSpec", "from_0to1", "to_0to1", "Voice", "VOICE_PARAM_SPECS"]
