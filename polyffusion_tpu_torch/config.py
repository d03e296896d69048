"""Model presets: ``params/<model>.yaml`` into an attribute dict, and the run
directory's ``params.yaml`` (a copy of the JAX package's ``config.py``:
``Params``, ``load_params``, ``save_params``, ``params_differ``, over the port's
own presets)."""

from __future__ import annotations

import os
from typing import Any, Dict

import yaml

PARAMS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "params")


class Params(dict):
    """Dict with attribute access and None for missing optional keys via .get."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value


def load_params(path_or_model: str) -> Params:
    """Load params from a preset name ('sdf_chd8bar') or explicit yaml path."""
    path = path_or_model
    if not os.path.exists(path):
        path = os.path.join(PARAMS_DIR, f"{path_or_model}.yaml")
    with open(path) as f:
        return Params(yaml.safe_load(f))


def save_params(params: Dict, path: str) -> None:
    with open(path, "w") as f:
        yaml.safe_dump(dict(params), f, sort_keys=False)


def params_differ(a: Dict, b: Dict) -> list:
    """Return list of (key, a_val, b_val) that differ (for resume drift warnings)."""
    diffs = []
    for k in sorted(set(a) | set(b)):
        if a.get(k) != b.get(k):
            diffs.append((k, a.get(k), b.get(k)))
    return diffs
