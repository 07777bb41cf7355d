"""Data and tensor parallelism over ``torch.distributed``: the (data, model) mesh,
the collectives built on ``all_reduce``, and the launcher of a world of ranks."""

from inverse_audio_synthesis_tpu_torch.parallel.mesh import create_mesh

__all__ = ["create_mesh"]
