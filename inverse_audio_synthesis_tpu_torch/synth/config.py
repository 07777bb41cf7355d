"""Synth global configuration.

Mirrors torchsynth's ``SynthConfig`` surface as used by the reference
(reference: vicreg_audio_params.py:86-94, audio_to_params.py:196-203):
``SynthConfig(batch_size, reproducible, sample_rate, buffer_size_seconds)``.
``control_rate`` is the rate envelopes/LFOs run at before linear upsampling to audio
rate (torchsynth default 441 Hz).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class SynthConfig:
    batch_size: int
    reproducible: bool = False
    sample_rate: int = 44100
    buffer_size_seconds: float = 4.0
    control_rate: int = 441
    # base seed folded with the batch number to derive per-batch parameter draws
    seed: int = 0
    # seed for the fixed noise buffer (torchsynth Voice uses a fixed-seed Noise module)
    noise_seed: int = 13

    def __post_init__(self):
        # torchsynth semantics: reproducible (synth1B1) mode requires the canonical
        # batch size of 128 so batch numbers index the same 128-voice batches
        if self.reproducible and self.batch_size != 128:
            raise ValueError(
                f"reproducible=True requires batch_size=128, got {self.batch_size}"
            )

    @property
    def buffer_size(self) -> int:
        return int(round(self.buffer_size_seconds * self.sample_rate))

    @property
    def control_buffer_size(self) -> int:
        return int(round(self.buffer_size_seconds * self.control_rate))
