"""Hydra-like YAML config tree with defaults composition and dotted CLI overrides.

The reference uses hydra + omegaconf (reference: pretrain.py:51, conf/config.yaml:33-35);
neither is available here, so this is a small self-contained equivalent that supports
the subset the pipeline needs:

- a root config (``conf/config.yaml``) with a ``defaults`` list that composes group
  configs (``conf/vicreg/full.yaml`` → ``cfg.vicreg``),
- dotted overrides ``vicreg.optim.name=sgd`` with YAML-typed values, including
  selecting a different group file via ``vicreg=fast``,
- attribute access (``cfg.vicreg.batch_size``) and ``to_yaml()`` round-tripping.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Union

import yaml

DEFAULT_CONFIG_DIR = Path(__file__).resolve().parent.parent / "conf"


class Config(dict):
    """A dict with attribute access, nested-Config coercion, and YAML dump."""

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        super().__init__()
        if data:
            for k, v in data.items():
                self[k] = v

    def __setitem__(self, key: str, value: Any) -> None:
        if isinstance(value, dict) and not isinstance(value, Config):
            value = Config(value)
        super().__setitem__(key, value)

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def set_dotted(self, dotted_key: str, value: Any) -> None:
        node = self
        parts = dotted_key.split(".")
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], Config):
                node[p] = Config()
            node = node[p]
        node[parts[-1]] = value

    def get_dotted(self, dotted_key: str, default: Any = None) -> Any:
        node: Any = self
        for p in dotted_key.split("."):
            if not isinstance(node, dict) or p not in node:
                return default
            node = node[p]
        return node

    def has_dotted(self, dotted_key: str) -> bool:
        node: Any = self
        for p in dotted_key.split("."):
            if not isinstance(node, dict) or p not in node:
                return False
            node = node[p]
        return True

    def merge(self, other: Dict[str, Any]) -> None:
        for k, v in other.items():
            if k in self and isinstance(self[k], Config) and isinstance(v, dict):
                self[k].merge(v)
            else:
                self[k] = copy.deepcopy(v)

    def to_dict(self) -> Dict[str, Any]:
        return {k: (v.to_dict() if isinstance(v, Config) else v) for k, v in self.items()}

    def to_yaml(self) -> str:
        return yaml.safe_dump(self.to_dict(), sort_keys=False)


def _load_yaml(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        data = yaml.safe_load(f)
    return data or {}


def _parse_override(s: str) -> tuple[str, Any, bool]:
    """Returns (key, value, append). A leading ``+`` (hydra's append syntax) marks
    the override as allowed to CREATE a key absent from the composed tree."""
    if "=" not in s:
        raise ValueError(f"override {s!r} must look like key=value")
    key, _, raw = s.partition("=")
    key = key.strip()
    append = key.startswith("+")
    if append:
        key = key[1:]
    return key, yaml.safe_load(raw) if raw != "" else None, append


def load_config(
    config_name: str = "config",
    config_dir: Union[str, Path, None] = None,
    overrides: Optional[Iterable[str]] = None,
) -> Config:
    """Compose a config like hydra: root yaml + defaults groups + CLI overrides."""
    config_dir = Path(config_dir) if config_dir is not None else DEFAULT_CONFIG_DIR
    overrides = list(overrides or [])

    root = _load_yaml(config_dir / f"{config_name}.yaml")
    defaults: List[Any] = root.pop("defaults", [])

    # group selection overrides (e.g. "vicreg=fast") apply to the defaults list
    group_choices: Dict[str, str] = {}
    for entry in defaults:
        if isinstance(entry, dict):
            for group, choice in entry.items():
                group_choices[str(group)] = str(choice)
    value_overrides: List[str] = []
    for s in overrides:
        key, val, append = _parse_override(s)
        if not append and key in group_choices and isinstance(val, str):
            group_choices[key] = val
        else:
            value_overrides.append(s)

    cfg = Config()
    for group, choice in group_choices.items():
        cfg[group] = Config(_load_yaml(config_dir / group / f"{choice}.yaml"))
    cfg.merge(root)

    # strict like hydra: an override naming a key absent from the composed tree is
    # an ERROR (a typo like vicreg.batchsize=64 must not silently train at the
    # default batch size — reference surface: pretrain.py:51, README.harmonai:32-33);
    # prefix with "+" (hydra's append syntax) to create a new key deliberately
    for s in value_overrides:
        key, val, append = _parse_override(s)
        if not append and not cfg.has_dotted(key):
            raise KeyError(
                f"override {key!r} does not match any key in the composed config "
                f"(use '+{key}={s.partition('=')[2]}' to add a new key)"
            )
        cfg.set_dotted(key, val)
    return cfg
