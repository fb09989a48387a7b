"""Config, paths and scene-manifest files, with PyYAML when it is there.

``read_tpu`` loads its experiment configs, the paths registry and scene
manifests with ``yaml.safe_load`` and dumps ``args.yaml`` with
``yaml.safe_dump`` (``read_tpu/train.py:198-236``,
``read_tpu/data/scenes.py:152-154``). The port reads through
:func:`load`: ``yaml.safe_load`` where PyYAML imports, else the file is
parsed as JSON, which is a subset of YAML; a file that is not JSON then
raises an error that names it. :func:`dump` writes JSON, which stays a
valid YAML file under a ``.yaml`` name.
"""

from __future__ import annotations

import json

__all__ = ["load", "dump", "ConfigFormatError"]


class ConfigFormatError(ValueError):
    """A YAML-only file read where PyYAML is not installed."""


def _yaml():
    try:
        import yaml
    except ImportError:
        return None
    return yaml


def load(path: str):
    """The file's content (``None`` for an empty file)."""
    with open(path) as f:
        text = f.read()
    yaml = _yaml()
    if yaml is not None:
        return yaml.safe_load(text)
    if not text.strip():
        return None
    try:
        return json.loads(text)
    except json.JSONDecodeError as e:
        raise ConfigFormatError(
            f"{path}: PyYAML is not installed and the file is not JSON "
            f"({e}); write it as JSON (a subset of YAML) or install "
            "PyYAML") from None


def dump(obj, path: str) -> None:
    """Write ``obj`` as indented JSON (readable as YAML too); tuples
    become lists, as ``yaml.safe_dump`` writes them."""
    with open(path, "w") as f:
        json.dump(obj, f, indent=1, sort_keys=True)
        f.write("\n")
