"""inverse_audio_synthesis_tpu_torch — the PyTorch/CUDA port of inverse_audio_synthesis_tpu.

Layer map (module names follow the JAX package, so each has its counterpart):

- ``synth``   — the Voice synthesizer: batch number -> parameters (threefry,
                bit-identical to JAX) -> control-rate graph -> audio.
- ``ops``     — DSP ops (PQMF analysis and synthesis, STFT/mel and the MR-STFT
                loss, phase/upsampling helpers, float32 math, byte scaling) and
                the fused render (``ops/render.py``): two hand-written CUDA
                kernels for Hopper, the forward K1 in ``csrc/render_fwd.cu`` and
                its backward K2 in ``csrc/render_bwd.cu``.
- ``models``  — towers (AudioEmbedding, ParamEmbed, MobileNetV3-Small, AST,
                HTS-AT), the VICReg projector and loss, the inverse-synthesis
                head, ``jax_weights`` to carry JAX weights across and the
                torchvision trunk import.
- ``train``   — the VICReg pretraining task (with ``steps_per_dispatch`` as a
                CUDA graph), the downstream inverse-synthesis task and its
                grad-through-synth objectives, LARS/SGD and the schedule, the
                training loop, checkpoints and run setup.
- ``parallel``— the (data, model) mesh over ``torch.distributed``, collectives
                built on ``all_reduce``, the ``torchrun``/spawn launcher.
- ``eval``    — nearest-neighbour retrieval over synthesized candidates and the
                HEAR embedding API.
- ``serve``   — ``torch.export`` programs of the inference surfaces.
- ``utils``   — config tree (YAML composition with overrides), metrics logging,
                audio IO, profiling, the parameter summary.

The CLIs beside them: ``pretrain``, ``downstream``,
``evaluate_audio_representations``, ``heareval`` and ``export_model``. The package
imports torch and never JAX or the JAX package; the names of the JAX package
that have no counterpart here are listed, each with its reason, in
``tests/test_torch_port_surface.py``.
"""

__version__ = "0.1.0"
