"""One config system for every recipe: recursive YAML with ``_base_``
inheritance (mmcv style, with ``_delete_`` semantics), attribute access and
``key=value`` overrides from the command line.

Port of ``metatransformer_tpu/configs/config.py``. The recipe YAMLs stay in
``metatransformer_tpu/configs/`` and are read from there as data files
(:data:`CONFIG_DIR`); nothing of the JAX package is imported. Parsing is
PyYAML's ``safe_load``, as in the reference.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, List, Optional

import yaml

# The shipped recipe YAMLs, read in place beside the reference package.
CONFIG_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "metatransformer_tpu", "configs",
)


class Config(dict):
    """dict with attribute access, recursive."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @classmethod
    def wrap(cls, obj: Any) -> Any:
        if isinstance(obj, dict):
            return cls({k: cls.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [cls.wrap(v) for v in obj]
        return obj

    def to_dict(self) -> Dict[str, Any]:
        def unwrap(o):
            if isinstance(o, dict):
                return {k: unwrap(v) for k, v in o.items()}
            if isinstance(o, list):
                return [unwrap(v) for v in o]
            return o

        return unwrap(self)


def _merge(base: Dict, override: Dict) -> Dict:
    """Recursive merge; ``_delete_: true`` in override replaces the subtree
    wholesale (mmcv semantics)."""
    out = copy.deepcopy(base)
    for key, value in override.items():
        if key == "_delete_":
            continue
        if (
            isinstance(value, dict)
            and isinstance(out.get(key), dict)
            and not value.get("_delete_", False)
        ):
            out[key] = _merge(out[key], value)
        else:
            if isinstance(value, dict):
                value = {k: v for k, v in value.items() if k != "_delete_"}
            out[key] = copy.deepcopy(value)
    return out


def _parse_value(text: str) -> Any:
    return yaml.safe_load(text)


def load_config(path: str, overrides: Optional[List[str]] = None) -> Config:
    """Load YAML with its ``_base_`` chain (paths relative to the file) and
    ``a.b.c=value`` overrides (values parsed as YAML scalars)."""
    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    bases = cfg.pop("_base_", [])
    if isinstance(bases, str):
        bases = [bases]
    merged: Dict[str, Any] = {}
    for base in bases:
        base_path = os.path.join(os.path.dirname(path), base)
        merged = _merge(merged, load_config(base_path).to_dict())
    merged = _merge(merged, cfg)

    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} is not key=value")
        key, value = ov.split("=", 1)
        node = merged
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _parse_value(value)
    return Config.wrap(merged)
