"""Faults planted in the program underneath the timed path, each a context
manager that patches the port's classes while it is open. The CPU tests run
the harness under each and see ``correct`` come out false; ``calibrate.py
--fault <name>`` reads a fault's numbers on the card at a cell's own size.

- ``unchanged_state``: the optimizer returns the state unchanged;
- ``half_batch``: the task renders and trains on half of the batch (the
  mean over the rest; the outputs' shapes change);
- ``half_loss``: the loss takes its mean over half of the rows, and every
  shape stays as it was;
- ``flipped_head_grad``: the downstream head's first weight gets the
  negated gradient in the backward pass.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator


@contextlib.contextmanager
def _patched(patches) -> Iterator[None]:
    """patches: (owner, attribute name, value) -> set while open, restored after."""
    old = [(owner, name, owner.__dict__[name]) for owner, name, _ in patches]
    try:
        for owner, name, value in patches:
            setattr(owner, name, value)
        yield
    finally:
        for owner, name, value in old:
            setattr(owner, name, value)


def unchanged_state():
    from inverse_audio_synthesis_tpu_torch.train import optim

    return _patched([(optim._Guarded, "step", lambda self, grads: self.updates(grads))])


def half_batch():
    from inverse_audio_synthesis_tpu_torch.train.downstream import AudioToParamsTask
    from inverse_audio_synthesis_tpu_torch.train.pretrain import VicregPretrainTask

    def halved(original):
        def synthesize(self, batch_num):
            audio, params = original(self, batch_num)
            n = params.shape[0] // 2
            return audio[:n], params[:n]

        return synthesize

    return _patched([(cls, "synthesize", halved(cls.synthesize)) for cls in (VicregPretrainTask, AudioToParamsTask)])


def half_loss():
    from inverse_audio_synthesis_tpu_torch.train.downstream import AudioToParamsTask
    from inverse_audio_synthesis_tpu_torch.train.pretrain import VicregPretrainTask

    losses, mean = VicregPretrainTask._losses, AudioToParamsTask._mean

    def vicreg_half(self, x, y):
        n = x.shape[0] // 2
        return losses(self, x[:n], y[:n])

    def mean_half(self, x, dim=None):
        return mean(self, x[: x.shape[0] // 2], dim)

    return _patched([(VicregPretrainTask, "_losses", vicreg_half), (AudioToParamsTask, "_mean", mean_half)])


def flipped_head_grad():
    from inverse_audio_synthesis_tpu_torch.train.downstream import AudioToParamsTask

    init_state = AudioToParamsTask.init_state

    def flipped(self):
        state = init_state(self)
        first = next(p for p in state.model.parameters() if p.dim() >= 2)
        first.register_hook(lambda g: -g)
        return state

    return _patched([(AudioToParamsTask, "init_state", flipped)])


FAULTS: Dict[str, Callable] = {f.__name__: f for f in (unchanged_state, half_batch, half_loss, flipped_head_grad)}
