"""Hydra-style YAML config composition without Hydra (the port's own copy
of `s3od_tpu/training/config.py`, over its own `config/` tree).

Same UX as the reference's Hydra CLI (`train.py:72` + `config/` groups):
`group=name` swaps a group file, `a.b.c=value` overrides a leaf, composition
root is `config/train.yaml`. Values parse as YAML scalars.
"""

from __future__ import annotations

import copy
import re
from pathlib import Path
from typing import Any, Dict, List, Optional

import yaml

CONFIG_DIR = Path(__file__).parent / "config"


class Config(dict):
    """dict with attribute access, recursively."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return Config(v) if isinstance(v, dict) else v

    def get(self, k, default=None):
        v = super().get(k, default)
        return Config(v) if isinstance(v, dict) else v


def _set_dotted(cfg: Dict, key: str, value: Any) -> None:
    parts = key.split(".")
    node = cfg
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def load_config(
    overrides: Optional[List[str]] = None,
    config_name: str = "train",
    config_dir: Optional[Path] = None,
) -> Config:
    config_dir = config_dir or CONFIG_DIR
    root = yaml.safe_load((config_dir / f"{config_name}.yaml").read_text())
    defaults: Dict[str, str] = root.pop("defaults", {})
    overrides = list(overrides or [])

    # Group swaps first (e.g. dataset=synth).
    group_choices = dict(defaults)
    rest = []
    for ov in overrides:
        key, _, val = ov.partition("=")
        if key in defaults and "." not in key:
            group_choices[key] = val
        else:
            rest.append(ov)

    cfg: Dict[str, Any] = copy.deepcopy(root)
    for group, choice in group_choices.items():
        path = config_dir / group / f"{choice}.yaml"
        if not path.exists():
            raise FileNotFoundError(
                f"unknown {group} config {choice!r} (no {path})"
            )
        cfg[group] = yaml.safe_load(path.read_text())
        cfg[group]["_name"] = choice

    # Leaf overrides (a.b=val).
    for ov in rest:
        key, _, val = ov.partition("=")
        _set_dotted(cfg, key, yaml.safe_load(val))

    _resolve_interpolations(cfg)
    return Config(cfg)


# ${a.b.c} references and ${eval:'<expr>'} — the two OmegaConf mechanisms the
# reference's configs use (`config/scheduler/cosine.yaml`:
# `T_max: ${eval:'${backend.max_epochs} - 30'}`; resolver registered at
# `model_training/train.py:21`). Inner references resolve before the eval;
# eval runs with no builtins (arithmetic only, not Hydra's full eval).
_INTERP = re.compile(r"\$\{([^${}]+)\}")


def _lookup_dotted(cfg: Dict, key: str) -> Any:
    node: Any = cfg
    for p in key.strip().split("."):
        node = node[p]
    return node


def _resolve_str(cfg: Dict, s: str, depth: int = 0) -> Any:
    if depth > 10:
        raise ValueError(f"interpolation loop resolving {s!r}")

    def sub(m):
        v = _resolve_value(cfg, _lookup_dotted(cfg, m.group(1)), depth + 1)
        return str(v)

    if s.startswith("${eval:") and s.endswith("}"):
        expr = s[len("${eval:"):-1].strip().strip("'\"")
        expr = _INTERP.sub(sub, expr)
        return eval(expr, {"__builtins__": {}}, {})  # noqa: S307
    full = _INTERP.fullmatch(s)
    if full:  # whole-string reference keeps the referent's type
        return _resolve_value(cfg, _lookup_dotted(cfg, full.group(1)), depth + 1)
    return _INTERP.sub(sub, s) if "${" in s else s


def _resolve_value(cfg: Dict, v: Any, depth: int = 0) -> Any:
    if isinstance(v, str) and "${" in v:
        return _resolve_str(cfg, v, depth)
    return v


def _resolve_interpolations(cfg: Dict, node: Any = None) -> None:
    node = cfg if node is None else node
    it = node.items() if isinstance(node, dict) else enumerate(node)
    for k, v in it:
        if isinstance(v, (dict, list)):
            _resolve_interpolations(cfg, v)
        elif isinstance(v, str) and "${" in v:
            node[k] = _resolve_str(cfg, v)
