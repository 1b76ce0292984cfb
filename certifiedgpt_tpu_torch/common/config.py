"""YAML experiment configuration of the PyTorch port.

A copy of ``certifiedgpt_tpu/common/config.py`` (PyYAML only):

- ``Config(path_or_dict)`` loads a YAML file and exposes ``.model``,
  ``.datasets``, ``.run``, ``.arch``, ``.evaluate_only``, and registers
  itself as ``configuration`` in the port's registry (the dataset builders
  read their block from there).
- ``${env:VAR}`` and ``${env:VAR,default}`` interpolation anywhere in the
  tree, resolved when a value is read, so a changed ``os.environ`` is seen.
- attribute *and* item access with ``.get(key, default)``.
"""

from __future__ import annotations

import copy
import os
import re
from typing import Any, Dict, Iterator, Mapping, Optional, Union

import yaml

from certifiedgpt_tpu_torch.common.registry import registry

_ENV_PATTERN = re.compile(r"\$\{env:([A-Za-z_][A-Za-z0-9_]*)(?:,([^}]*))?\}")


def _resolve_env(value: str) -> str:
    def sub(match: "re.Match[str]") -> str:
        var, default = match.group(1), match.group(2)
        if var in os.environ:
            return os.environ[var]
        if default is not None:
            return default
        raise KeyError(
            f"Config interpolation '${{env:{var}}}' references an unset "
            f"environment variable"
        )

    return _ENV_PATTERN.sub(sub, value)


class ConfigNode(Mapping):
    """A read-mostly mapping with attribute access and env interpolation."""

    __slots__ = ("_data",)

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        object.__setattr__(self, "_data", dict(data or {}))

    # -- access --------------------------------------------------------
    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, ConfigNode):
            return value
        if isinstance(value, dict):
            return ConfigNode(value)
        if isinstance(value, list):
            return [ConfigNode._wrap(v) for v in value]
        if isinstance(value, str):
            return _resolve_env(value)
        return value

    def __getitem__(self, key: str) -> Any:
        return self._wrap(self._data[key])

    def __getattr__(self, key: str) -> Any:
        try:
            value = self._data[key]
        except KeyError as exc:
            raise AttributeError(key) from exc
        return self._wrap(value)

    def get(self, key: str, default: Any = None) -> Any:
        if key in self._data:
            return self._wrap(self._data[key])
        return default

    def __setattr__(self, key: str, value: Any) -> None:
        self._data[key] = value

    def __setitem__(self, key: str, value: Any) -> None:
        self._data[key] = value

    def __contains__(self, key: object) -> bool:
        return key in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def keys(self):
        return self._data.keys()

    def items(self):
        return [(k, self._wrap(v)) for k, v in self._data.items()]

    def to_dict(self) -> Dict[str, Any]:
        """Deep plain-dict copy with env interpolation applied."""

        def unwrap(value: Any) -> Any:
            if isinstance(value, ConfigNode):
                value = value._data
            if isinstance(value, dict):
                return {k: unwrap(v) for k, v in value.items()}
            if isinstance(value, list):
                return [unwrap(v) for v in value]
            if isinstance(value, str):
                return _resolve_env(value)
            return value

        return unwrap(self._data)

    def merge(self, other: Union["ConfigNode", Dict[str, Any]]) -> "ConfigNode":
        """Deep merge: ``other`` wins on conflicts; returns a new node."""
        base = copy.deepcopy(self._data)

        def rec(dst: Dict[str, Any], src: Mapping) -> None:
            for key, value in src.items():
                if isinstance(value, ConfigNode):
                    value = value._data
                if (
                    key in dst
                    and isinstance(dst[key], dict)
                    and isinstance(value, Mapping)
                ):
                    rec(dst[key], value)
                else:
                    dst[key] = copy.deepcopy(
                        value._data if isinstance(value, ConfigNode) else value
                    )

        rec(base, other)
        return ConfigNode(base)

    def __repr__(self) -> str:
        return f"ConfigNode({self._data!r})"


def load_yaml(path: str) -> ConfigNode:
    with open(path, "r") as handle:
        data = yaml.safe_load(handle) or {}
    return ConfigNode(data)


class Config:
    """Top-level experiment config (model / datasets / run blocks).

    Registers itself in the port's registry under ``configuration`` and
    exposes ``.datasets`` / ``.run`` / ``.model`` / ``.arch`` /
    ``.evaluate_only``.
    """

    def __init__(self, config: Union[str, Dict[str, Any], ConfigNode]):
        if isinstance(config, str):
            self.config = load_yaml(config)
        elif isinstance(config, ConfigNode):
            self.config = config
        else:
            self.config = ConfigNode(config)
        registry.register("configuration", self)

    # ``or ConfigNode()``: a YAML block that is PRESENT but empty
    # ("run:" with every key commented out) loads as None — the
    # key-missing default alone would hand callers a None and crash the
    # launcher on run.get(...)
    @property
    def datasets(self) -> ConfigNode:
        return self.config.get("datasets", None) or ConfigNode()

    @property
    def run(self) -> ConfigNode:
        return self.config.get("run", None) or ConfigNode()

    @property
    def model(self) -> ConfigNode:
        return self.config.get("model", None) or ConfigNode()

    @property
    def arch(self) -> str:
        return self.model.get("arch", "minigpt4")

    @property
    def evaluate_only(self) -> bool:
        return bool(self.run.get("evaluate", False))

    def to_dict(self) -> Dict[str, Any]:
        return self.config.to_dict()

    def pretty(self) -> str:
        return yaml.safe_dump(self.to_dict(), sort_keys=False)
