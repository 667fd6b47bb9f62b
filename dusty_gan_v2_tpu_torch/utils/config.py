"""Configs with attribute access, read from and written to YAML with PyYAML
(counterpart of dusty_gan_v2_tpu/utils/config.py)."""

from __future__ import annotations

import copy
from typing import Any, Dict

import yaml

__all__ = ["Config", "load_config", "save_config"]


class Config(dict):
    """dict with attribute access, recursively wrapping nested dicts."""

    def __init__(self, data: Dict[str, Any] | None = None, **kwargs):
        super().__init__()
        for k, v in dict(data or {}, **kwargs).items():
            self[k] = v

    @staticmethod
    def _wrap(v):
        if isinstance(v, dict) and not isinstance(v, Config):
            return Config(v)
        if isinstance(v, list):
            return [Config._wrap(x) for x in v]
        return v

    def __setitem__(self, k, v):
        super().__setitem__(k, Config._wrap(v))

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    def get_path(self, path: str, default=None):
        node = self
        for part in path.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def to_dict(self) -> Dict[str, Any]:
        def unwrap(v):
            if isinstance(v, dict):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, list):
                return [unwrap(x) for x in v]
            return v

        return unwrap(self)

    def copy(self) -> "Config":
        return Config(copy.deepcopy(self.to_dict()))


def load_config(path: str) -> Config:
    with open(path) as f:
        return Config(yaml.safe_load(f))


def save_config(cfg, path: str) -> None:
    with open(path, "w") as f:
        yaml.safe_dump(cfg.to_dict() if isinstance(cfg, Config) else cfg, f, sort_keys=False)
