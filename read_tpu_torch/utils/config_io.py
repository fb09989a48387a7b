"""Config, paths and scene-manifest files, with PyYAML when it is there.

``read_tpu`` loads its experiment configs, the paths registry and scene
manifests with ``yaml.safe_load`` and dumps ``args.yaml`` with
``yaml.safe_dump`` (``read_tpu/train.py:198-236``,
``read_tpu/data/scenes.py:152-154``). The port reads through
:func:`load`: ``yaml.safe_load`` where PyYAML imports; else a JSON file,
or one in the block-style subset of YAML that the repo's configs, paths
files and scene manifests are written in (:func:`parse_yaml_subset`:
nested mappings by indentation, ``- item`` and flow lists, ``{}``,
comments, plain and quoted scalars resolved as PyYAML's ``safe_load``
resolves them: what ``yaml.safe_dump`` writes of a config).
Anything else raises an error that names the file. :func:`dump` writes
JSON, which stays a valid YAML file under a ``.yaml`` name.
"""

from __future__ import annotations

import json
import re

__all__ = ["load", "dump", "parse_yaml_subset", "ConfigFormatError"]


class ConfigFormatError(ValueError):
    """A file neither JSON nor in the YAML subset, read where PyYAML is
    not installed."""


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
    except json.JSONDecodeError:
        pass
    try:
        return parse_yaml_subset(text)
    except ConfigFormatError as e:
        raise ConfigFormatError(
            f"{path}: PyYAML is not installed and the file is neither JSON "
            f"nor block-style YAML of mappings, scalars and flow lists "
            f"({e}); write it as JSON or install PyYAML") from None


def dump(obj, path: str) -> None:
    """Write ``obj`` as indented JSON (readable as YAML too); tuples
    become lists, as ``yaml.safe_dump`` writes them."""
    with open(path, "w") as f:
        json.dump(obj, f, indent=1, sort_keys=True)
        f.write("\n")


# PyYAML's (YAML 1.1) implicit resolvers for plain scalars, decimal only
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")
_BOOL = {"yes": True, "true": True, "on": True, "no": False,
         "false": False, "off": False}
# a mapping line: a plain or quoted key, ':', then its value or nothing
_KEY = re.compile(r"('[^']*'|\"[^\"]*\"|[^:]+?)\s*:(\s+|$)(.*)$")
_SPECIAL_FLOAT = {".inf": float("inf"), "+.inf": float("inf"),
                  "-.inf": float("-inf"), ".nan": float("nan")}


def _scalar(tok: str):
    if len(tok) >= 2 and tok[0] == tok[-1] and tok[0] in "'\"":
        body = tok[1:-1]
        return (body.replace("''", "'") if tok[0] == "'"
                else json.loads(tok))
    if tok in ("", "~") or tok.lower() == "null":
        return None
    if tok.lower() in _BOOL:
        return _BOOL[tok.lower()]
    if tok.lower() in _SPECIAL_FLOAT:
        return _SPECIAL_FLOAT[tok.lower()]
    if _INT.match(tok):
        return int(tok.replace("_", ""))
    if _FLOAT.match(tok) and tok not in (".", "+.", "-."):
        return float(tok.replace("_", ""))
    if tok[0] in "[]{},&*!|>%@`" or ": " in tok or tok[:2] == "- ":
        raise ConfigFormatError(f"unsupported scalar {tok!r}")
    return tok


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _flow_list(text: str, pos: int):
    """The flow list opening at ``text[pos]`` (``[a, 'b', [c]]``) and the
    position after it."""
    out, pos = [], pos + 1
    while True:
        while text[pos] in " ,":
            pos += 1
        if text[pos] == "]":
            return out, pos + 1
        if text[pos] == "[":
            item, pos = _flow_list(text, pos)
        else:
            start = pos
            if text[pos] in "'\"":
                pos = text.index(text[pos], pos + 1) + 1
            else:
                while text[pos] not in ",]":
                    pos += 1
            item = _scalar(text[start:pos].strip())
        out.append(item)


def _value(text: str):
    """A value after ``key:``: a flow list, ``{}`` or a scalar."""
    if text == "{}":
        return {}
    if text[:1] != "[":
        return _scalar(text)
    try:
        out, end = _flow_list(text, 0)
    except (IndexError, ValueError):
        raise ConfigFormatError(
            f"unterminated flow list {text!r}") from None
    if text[end:].strip():
        raise ConfigFormatError(f"text after a flow list {text!r}")
    return out


def parse_yaml_subset(text: str):
    """Block-style YAML as ``yaml.safe_load`` reads it: mappings nested by
    indentation whose values are plain or quoted scalars, flow lists,
    ``{}`` or ``- item`` lists of those (at the key's indentation or
    deeper), with comments. Raises :class:`ConfigFormatError` for
    anything else (sequences of mappings, flow mappings with entries,
    anchors, multi-line strings, document markers)."""
    lines = []
    for raw in text.splitlines():
        if raw.strip() in ("---", "..."):
            raise ConfigFormatError("document markers")
        line = _strip_comment(raw)
        if line.strip():
            if "\t" in line[:len(line) - len(line.lstrip())]:
                raise ConfigFormatError("tab indentation")
            lines.append((len(line) - len(line.lstrip()), line.strip()))
    pos = 0

    def item(line):
        return line[1] == "-" or line[1].startswith("- ")

    def sequence(indent):
        nonlocal pos
        out = []
        while pos < len(lines) and lines[pos][0] == indent \
                and item(lines[pos]):
            body = lines[pos][1][1:].strip()
            if _KEY.match(body):
                raise ConfigFormatError(f"a sequence of mappings {body!r}")
            out.append(_value(body))
            pos += 1
        return out

    def mapping(indent):
        nonlocal pos
        out = {}
        while pos < len(lines) and lines[pos][0] == indent:
            body = lines[pos][1]
            m = _KEY.match(body)
            if m is None or item(lines[pos]):
                raise ConfigFormatError(f"line {body!r}")
            key, rest = _scalar(m.group(1)), m.group(3)
            pos += 1
            nxt = lines[pos] if pos < len(lines) else None
            if rest:
                out[key] = _value(rest)
            elif nxt and item(nxt) and nxt[0] >= indent:
                out[key] = sequence(nxt[0])
            elif nxt and nxt[0] > indent:
                out[key] = mapping(nxt[0])
            else:
                out[key] = None
        return out

    if not lines:
        return None
    out = mapping(lines[0][0])
    if pos != len(lines):
        raise ConfigFormatError(f"indentation at {lines[pos][1]!r}")
    return out
