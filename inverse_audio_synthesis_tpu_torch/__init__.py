"""inverse_audio_synthesis_tpu_torch — the PyTorch/CUDA port of inverse_audio_synthesis_tpu.

Layer map (module names follow the JAX package, so each has its counterpart):

- ``synth``   — the Voice synthesizer: batch number -> parameters (threefry,
                bit-identical to JAX) -> control-rate graph -> audio.
- ``ops``     — DSP ops (PQMF analysis, phase/upsampling helpers, float32 math)
                and the fused forward render (``ops/render.py``), a hand-written
                CUDA kernel for Hopper in ``csrc/render_fwd.cu``.
- ``models``  — towers (AudioEmbedding, ParamEmbed, MobileNetV3-Small), the VICReg
                projector and loss, and ``jax_weights`` to carry JAX weights across.
- ``train``   — VICReg pretraining task, LARS and its schedule, the training loop.
- ``parallel``— the (data, model) mesh over ``torch.distributed``, collectives
                built on ``all_reduce``, the ``torchrun``/spawn launcher.
- ``utils``   — config tree (YAML composition with overrides), metrics logging.

The package imports torch and never JAX or the JAX package.
"""

__version__ = "0.1.0"
