"""Hydra-style YAML config composition (no hydra/omegaconf dependency).

Counterpart of ``tomosar2height_tpu/config/compose.py``, line for line: the
root defaults list, group files under ``conf/model`` and ``conf/dataset``
(deep-merged at global scope, each with its own ``defaults``), ``_self_``,
dotted CLI overrides such as ``use_image=true training.max_iteration=500
dataset=berlin``, then ``${...}`` interpolation. :func:`default_conf_dir`
is the port's own ``conf/``, a byte-equal copy of the JAX package's.
"""

from __future__ import annotations

import copy
import os
import re
from typing import Any, Dict, List, Optional

import yaml

_INTERP_RE = re.compile(r"\$\{([^}]+)\}")


class Config(dict):
    """Dict with attribute access and dotted-path get/set, recursively wrapped."""

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key, value):
        self[key] = value

    def __getitem__(self, key):
        v = dict.__getitem__(self, key)
        if isinstance(v, dict) and not isinstance(v, Config):
            v = Config(v)
            dict.__setitem__(self, key, v)
        return v

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def select(self, path: str, default=None):
        """Dotted-path lookup: cfg.select('training.scheduler.type')."""
        node: Any = self
        for part in path.split("."):
            if isinstance(node, dict) and part in node:
                node = node[part] if not isinstance(node, Config) else node[part]
            elif isinstance(node, (list, tuple)) and part.lstrip("-").isdigit():
                node = node[int(part)]
            else:
                return default
        return node

    def set_path(self, path: str, value):
        parts = path.split(".")
        node = self
        for p in parts[:-1]:
            nxt = node.get(p)
            if not isinstance(nxt, dict):
                nxt = Config()
                node[p] = nxt
            node = node[p]
        node[parts[-1]] = value

    def to_dict(self) -> dict:
        def conv(v):
            if isinstance(v, dict):
                return {k: conv(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [conv(x) for x in v]
            return v

        return conv(self)


def load_yaml(path: str) -> dict:
    with open(path) as f:
        return yaml.safe_load(f) or {}


def _deep_merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _load_group(conf_dir: str, group: str, name: str) -> dict:
    """Load a group file, honoring its own nested ``defaults`` list
    (e.g. conf/dataset/berlin.yaml inheriting base — reference berlin.yaml:3-4)."""
    path = os.path.join(conf_dir, group, f"{name}.yaml")
    raw = load_yaml(path)
    raw.pop("# @package", None)
    defaults = raw.pop("defaults", None)
    merged: dict = {}
    if defaults:
        for entry in defaults:
            if entry == "_self_":
                merged = _deep_merge(merged, raw)
                raw = {}
            elif isinstance(entry, str):
                merged = _deep_merge(merged, _load_group(conf_dir, group, entry))
            elif isinstance(entry, dict):
                for g, n in entry.items():
                    merged = _deep_merge(merged, _load_group(conf_dir, str(g), str(n)))
    return _deep_merge(merged, raw)


def parse_cli_overrides(args: List[str]) -> Dict[str, Any]:
    """Parse ``key.path=value`` tokens; values go through YAML scalar parsing."""
    out: Dict[str, Any] = {}
    for a in args:
        if "=" not in a:
            raise ValueError(f"Override must look like key=value, got: {a!r}")
        k, v = a.split("=", 1)
        out[k.strip()] = yaml.safe_load(v) if v != "" else ""
    return out


def _resolve_interp(root: dict, node: Any, stack: tuple = ()) -> Any:
    if isinstance(node, dict):
        return {k: _resolve_interp(root, v, stack) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve_interp(root, v, stack) for v in node]
    if isinstance(node, str):
        m = _INTERP_RE.fullmatch(node.strip())
        if m:  # whole-string interpolation keeps the referenced type
            return _lookup_interp(root, m.group(1), stack)
        def sub(mm):
            v = _lookup_interp(root, mm.group(1), stack)
            return str(v)
        return _INTERP_RE.sub(sub, node)
    return node


def _lookup_interp(root: dict, path: str, stack: tuple) -> Any:
    if path in stack:
        raise ValueError(f"Interpolation cycle at ${{{path}}}")
    node: Any = root
    for part in path.split("."):
        if isinstance(node, dict) and part in node:
            node = node[part]
        else:
            raise KeyError(f"Interpolation target not found: ${{{path}}}")
    return _resolve_interp(root, node, stack + (path,))


def compose(
    conf_dir: str,
    config_name: str = "config",
    overrides: Optional[List[str]] = None,
) -> Config:
    """Compose the config tree like ``hydra.main`` would (reference train.py:16-17).

    Group selections may be overridden on the CLI (``dataset=berlin``,
    ``model=tomosar2height``); all other ``a.b=c`` tokens override values.
    """
    overrides = list(overrides or [])
    root_raw = load_yaml(os.path.join(conf_dir, f"{config_name}.yaml"))
    defaults = root_raw.pop("defaults", ["_self_"])

    ov = parse_cli_overrides(overrides)
    # split group selections (single token matching a defaults group) from value overrides
    group_names = {
        list(d.keys())[0] if isinstance(d, dict) else None for d in defaults
    } - {None}
    group_sel = {k: v for k, v in ov.items() if k in group_names}
    value_ov = {k: v for k, v in ov.items() if k not in group_names}

    merged: dict = {}
    self_done = False
    for entry in defaults:
        if entry == "_self_":
            merged = _deep_merge(merged, root_raw)
            self_done = True
        elif isinstance(entry, dict):
            for g, n in entry.items():
                g = str(g)
                if g.startswith("override "):
                    continue  # hydra logging overrides — not applicable
                name = str(group_sel.get(g, n))
                merged = _deep_merge(merged, _load_group(conf_dir, g, name))
        elif isinstance(entry, str) and entry.startswith("override"):
            continue
    if not self_done:
        merged = _deep_merge(merged, root_raw)

    for k, v in value_ov.items():
        node = merged
        parts = k.split(".")
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], dict):
                node[p] = {}
            node = node[p]
        node[parts[-1]] = v

    merged = _resolve_interp(merged, merged)
    return Config(merged)


def default_conf_dir() -> str:
    """The port's conf tree (tomosar2height_tpu_torch/conf)."""
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "conf")
