"""See the package docstring."""

from inverse_audio_synthesis_tpu_torch.utils.config import Config, load_config
from inverse_audio_synthesis_tpu_torch.utils.utils import git_sha, utcstr

__all__ = ["Config", "load_config", "git_sha", "utcstr"]
