"""Evaluation surfaces: nearest-neighbour retrieval and the HEAR embedding API."""

from inverse_audio_synthesis_tpu_torch.eval.retrieval import RetrievalEvaluator

__all__ = ["RetrievalEvaluator"]
