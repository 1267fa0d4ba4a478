"""Experiment configuration: one YAML per experiment, four sections.

The port's own copy of affectgpt_tpu/config.py (reference:
my_affectgpt/common/config.py:9-173): a YAML file with `model` / `datasets`
/ `run` / `inference` sections, CLI dot-list overrides (`--options
a.b.c=value`), an experiment name from the YAML basename, and an optional
`paths:` section that feeds `paths.update_from_dict`.

PyYAML is imported by `Config.from_file` alone, for a YAML file: a caller
that builds its config with `Config.from_dict` (a dict literal, as
`chip_smoke.py` does on a machine without PyYAML) or reads a `.json` config
needs no YAML parser. Override values are typed by
`parse_scalar`, which resolves a plain scalar as PyYAML's `safe_load` does
(YAML 1.1: `yes`/`on` are booleans, `1e-5` without a dot stays a string)
and reads flow lists `[a, b]` and quoted strings.
"""

from __future__ import annotations

import copy
import datetime
import json
import math
import os
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from affectgpt_tpu_torch import paths

# PyYAML's implicit resolvers (yaml/resolver.py); its sexagesimal forms and
# timestamps with a time of day are left out
_BOOL = {**{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")},
         **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF")}}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"^[-+]?(?:0b[0-1_]+|0[0-7_]+|0|[1-9][0-9_]*|0x[0-9a-fA-F_]+)$")
_DATE = re.compile(r"^[0-9]{4}-[0-9]{2}-[0-9]{2}$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)


def _split_flow(body: str) -> List[str]:
    """Split a flow collection's body on its top-level commas."""
    items, depth, quote, start = [], 0, None, 0
    for i, ch in enumerate(body):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == "," and depth == 0:
            items.append(body[start:i])
            start = i + 1
    tail = body[start:]
    if tail.strip() or items:
        items.append(tail)
    return [item.strip() for item in items]


def _int(text: str) -> int:
    sign = -1 if text[0] == "-" else 1
    digits = text.lstrip("+-").replace("_", "")
    if digits.startswith("0b"):
        return sign * int(digits[2:], 2)
    if digits.startswith("0x"):
        return sign * int(digits[2:], 16)
    if len(digits) > 1 and digits[0] == "0":
        return sign * int(digits, 8)
    return sign * int(digits)


def _float(text: str) -> float:
    lowered = text.replace("_", "").lower()
    if lowered.endswith(".inf"):
        return -math.inf if lowered[0] == "-" else math.inf
    if lowered.endswith(".nan"):
        return math.nan
    return float(lowered)


def parse_scalar(text: str) -> Any:
    """One override value → the Python value `yaml.safe_load` gives it: a
    flow list or map, a quoted string, null, a bool, an int, a float, a
    date, or the string itself (a timestamp with a time of day stays a
    string)."""
    text = text.strip()
    if text.startswith("[") and text.endswith("]"):
        return [parse_scalar(item) for item in _split_flow(text[1:-1])]
    if text.startswith("{") and text.endswith("}"):
        out = {}
        for item in _split_flow(text[1:-1]):
            key, _, value = item.partition(":")
            out[parse_scalar(key)] = parse_scalar(value)
        return out
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        body = text[1:-1]
        return body.replace("''", "'") if text[0] == "'" else json.loads(text)
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return _int(text)
    if _FLOAT.match(text):
        return _float(text)
    if _DATE.match(text):
        return datetime.date.fromisoformat(text)
    return text


def _deep_merge(base: dict, override: dict) -> dict:
    out = dict(base)
    for key, value in (override or {}).items():
        if key in out and isinstance(out[key], dict) and isinstance(value, dict):
            out[key] = _deep_merge(out[key], value)
        else:
            out[key] = value
    return out


def parse_dot_overrides(options: Optional[List[str]]) -> dict:
    """Parse ['a.b=1', 'c=[x,y]'] into a nested dict of typed values."""
    tree: dict = {}
    for opt in options or []:
        if "=" not in opt:
            raise ValueError(f"Override must look like key.path=value, got: {opt}")
        key_path, raw_value = opt.split("=", 1)
        value = parse_scalar(raw_value)
        node = tree
        parts = key_path.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
            if not isinstance(node, dict):
                raise ValueError(f"Override path conflict at {part} in {opt}")
        node[parts[-1]] = value
    return tree


class ConfigNode(dict):
    """Dict with attribute access and a default-aware get, for YAML subtrees."""

    def __getattr__(self, name: str) -> Any:
        try:
            value = self[name]
        except KeyError:
            raise AttributeError(name) from None
        return ConfigNode(value) if isinstance(value, dict) else value

    def get(self, key, default=None):
        value = super().get(key, default)
        return ConfigNode(value) if isinstance(value, dict) else value

    def to_dict(self) -> dict:
        return copy.deepcopy(dict(self))


@dataclass
class Config:
    """Merged experiment config: cfg.model / cfg.datasets / cfg.run /
    cfg.inference mirror the four YAML sections; cfg.name is the YAML
    basename and names the output and result directories."""

    model: ConfigNode = field(default_factory=ConfigNode)
    datasets: ConfigNode = field(default_factory=ConfigNode)
    run: ConfigNode = field(default_factory=ConfigNode)
    inference: ConfigNode = field(default_factory=ConfigNode)
    name: str = "experiment"
    cfg_path: Optional[str] = None

    @classmethod
    def from_file(cls, cfg_path: str, options: Optional[List[str]] = None) -> "Config":
        """A YAML config, or a JSON one (`.json`, read without PyYAML)."""
        with open(cfg_path) as handle:
            if cfg_path.endswith(".json"):
                raw = json.load(handle) or {}
            else:
                import yaml

                raw = yaml.safe_load(handle) or {}
        return cls.from_dict(raw, options=options,
                             name=os.path.splitext(os.path.basename(cfg_path))[0],
                             cfg_path=cfg_path)

    @classmethod
    def from_dict(cls, raw: Dict[str, Any], options: Optional[List[str]] = None,
                  name: str = "experiment", cfg_path: Optional[str] = None) -> "Config":
        merged = _deep_merge(raw, parse_dot_overrides(options))
        if "paths" in merged:
            paths.update_from_dict(merged.pop("paths"))
        return cls(
            model=ConfigNode(merged.get("model", {}) or {}),
            datasets=ConfigNode(merged.get("datasets", {}) or {}),
            run=ConfigNode(merged.get("run", {}) or {}),
            inference=ConfigNode(merged.get("inference", {}) or {}),
            name=name,
            cfg_path=cfg_path,
        )

    @property
    def output_dir(self) -> str:
        """output/<cfg-name>/: the experiment's identity is its YAML basename."""
        return os.path.join(self.run.get("output_dir", "output"), self.name)

    def to_dict(self) -> dict:
        return {
            "model": self.model.to_dict(),
            "datasets": self.datasets.to_dict(),
            "run": self.run.to_dict(),
            "inference": self.inference.to_dict(),
        }
