"""Serving export of the inference surfaces (``torch.export`` programs)."""

from inverse_audio_synthesis_tpu_torch.serve.export import (
    export_embed_audio,
    export_predict_params,
    export_render,
    load_exported,
    model_weights,
    save_exported,
    write_manifest,
)

__all__ = [
    "export_embed_audio",
    "export_predict_params",
    "export_render",
    "load_exported",
    "model_weights",
    "save_exported",
    "write_manifest",
]
