"""The Voice synthesizer."""

from inverse_audio_synthesis_tpu_torch.synth.config import SynthConfig

__all__ = ["SynthConfig"]
