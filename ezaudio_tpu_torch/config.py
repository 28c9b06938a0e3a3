"""Configs: JSON copies of the model configs plus the reference YAML format.

The packaged configs (``configs/*.json``) are JSON so that no YAML parser
is needed at run time.  A user's reference-format ``.yml`` (with the
``!include`` constructor of reference ``src/utils/utils.py:7-17``) still
loads: PyYAML is imported only then.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict


class ConfigDict(dict):
    """A dict with attribute access, recursively wrapping nested dicts."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @staticmethod
    def wrap(obj: Any) -> Any:
        if isinstance(obj, dict):
            return ConfigDict({k: ConfigDict.wrap(v) for k, v in obj.items()})
        if isinstance(obj, (list, tuple)):
            return type(obj)(ConfigDict.wrap(v) for v in obj)
        return obj

    def to_dict(self) -> Dict[str, Any]:
        def unwrap(obj):
            if isinstance(obj, dict):
                return {k: unwrap(v) for k, v in obj.items()}
            if isinstance(obj, (list, tuple)):
                return type(obj)(unwrap(v) for v in obj)
            return obj

        return unwrap(self)


def _load_yaml_with_includes(yaml_file: str):
    import yaml

    class _Loader(yaml.FullLoader):
        pass

    def _include(loader, node):
        path = os.path.join(os.path.dirname(yaml_file), loader.construct_scalar(node))
        with open(path, "r") as f:
            return yaml.load(f, Loader=_Loader)

    _Loader.add_constructor("!include", _include)
    with open(yaml_file, "r") as f:
        return yaml.load(f, Loader=_Loader)


def load_config(path: str) -> ConfigDict:
    """Load a ``.json`` config, or a reference-format ``.yml``/``.yaml``."""
    if path.endswith((".yml", ".yaml")):
        return ConfigDict.wrap(_load_yaml_with_includes(path))
    with open(path, "r") as f:
        return ConfigDict.wrap(json.load(f))


CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")

MODEL_REGISTRY: Dict[str, Dict[str, str]] = {
    "s3_xl": {"config": os.path.join(CONFIG_DIR, "ezaudio-xl.json")},
    "s3_l": {"config": os.path.join(CONFIG_DIR, "ezaudio-l.json")},
    "energy": {"config": os.path.join(CONFIG_DIR, "energy-l.json")},
    "vae": {"config": os.path.join(CONFIG_DIR, "vae.json")},
}


def get_model_config(name: str) -> ConfigDict:
    return load_config(MODEL_REGISTRY[name]["config"])
