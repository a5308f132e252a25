"""Hydra-1.0-style config composition without hydra.

The reference's CLI contract (``python train.py task=panoptic data=...
models=... model_name=... training=...``, README.md:193-200) is part of its
API. This loader reproduces the pieces that contract needs:

* a root yaml with a ``defaults:`` list naming group/option pairs
  (conf/config.yaml:1-26 in the reference);
* ``group=option`` CLI overrides swapping which file a group loads;
* ``a.b.c=value`` dotted value overrides;
* ``${a.b}`` interpolation, plus the reference's string-eval arithmetic for
  expressions like ``1.5 * ${data.grid_size}``
  (utils/model_building_utils/model_definition_resolver.py:29-58) restricted
  to a safe arithmetic grammar.
"""

from __future__ import annotations

import ast
import os.path as osp
import re
from typing import Any, Dict, List

import yaml


class ConfigError(Exception):
    pass


_INTERP = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")
_ARITH = re.compile(r"^[\d\s\.\+\-\*/()eE]+$")


def _deep_update(dst: Dict, src: Dict) -> Dict:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_update(dst[k], v)
        else:
            dst[k] = v
    return dst


def _get_path(cfg: Dict, path: str):
    node = cfg
    for part in path.split("."):
        if not isinstance(node, dict) or part not in node:
            raise ConfigError(f"unknown config path: {path}")
        node = node[part]
    return node


def _set_path(cfg: Dict, path: str, value) -> None:
    parts = path.split(".")
    node = cfg
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def _parse_value(s: str):
    try:
        return yaml.safe_load(s)
    except yaml.YAMLError:
        return s


def resolve(cfg: Dict) -> Dict:
    """Resolve ${...} interpolations (iterating to a fixpoint) and then eval
    pure-arithmetic strings like "1.5 * 0.2"."""

    def subst(value, root):
        if isinstance(value, str):
            def repl(m):
                v = _get_path(root, m.group(1))
                return str(v)

            if _INTERP.fullmatch(value.strip()):
                return _get_path(root, value.strip()[2:-1])
            new = _INTERP.sub(repl, value)
            return new
        if isinstance(value, dict):
            return {k: subst(v, root) for k, v in value.items()}
        if isinstance(value, list):
            return [subst(v, root) for v in value]
        return value

    for _ in range(8):
        new = subst(cfg, cfg)
        if new == cfg:
            break
        cfg = new

    def arith(value):
        if isinstance(value, str) and _ARITH.match(value) and any(
            op in value for op in "+-*/"
        ):
            try:
                return ast.literal_eval(value)
            except (ValueError, SyntaxError):
                try:
                    # restricted eval: arithmetic only (regex-gated above)
                    return eval(compile(ast.parse(value, mode="eval"), "<cfg>", "eval"), {"__builtins__": {}}, {})
                except Exception:
                    return value
        if isinstance(value, dict):
            return {k: arith(v) for k, v in value.items()}
        if isinstance(value, list):
            return [arith(v) for v in value]
        return value

    return arith(cfg)


def load_config(
    conf_dir: str,
    overrides: List[str] | None = None,
    root: str = "config.yaml",
) -> Dict[str, Any]:
    """Compose conf/<root> + its defaults list + CLI overrides."""
    overrides = list(overrides or [])
    root_cfg = yaml.safe_load(open(osp.join(conf_dir, root))) or {}
    defaults = root_cfg.pop("defaults", [])

    # group overrides (no dot in key) swap the defaults entries
    group_over: Dict[str, str] = {}
    value_over: List[str] = []
    for ov in overrides:
        if "=" not in ov:
            raise ConfigError(f"override must be key=value: {ov}")
        k, v = ov.split("=", 1)
        if "." in k:
            value_over.append(ov)
        else:
            group_over[k] = v

    cfg: Dict[str, Any] = {}
    for entry in defaults:
        if isinstance(entry, dict):
            (group, option), = entry.items()
        else:
            group, option = entry, None
        option = group_over.pop(group, option)
        if option is None:
            continue
        path = osp.join(conf_dir, group, str(option) + ".yaml")
        if not osp.exists(path):
            raise ConfigError(f"missing config file: {path}")
        loaded = yaml.safe_load(open(path)) or {}
        # '# @package group' convention: file contents live under the group key
        cfg.setdefault(group.split("/")[0], {})
        _deep_update(cfg[group.split("/")[0]], loaded)
    _deep_update(cfg, root_cfg)

    # remaining group overrides that weren't in defaults (e.g. model_name=...)
    for k, v in group_over.items():
        cfg[k] = _parse_value(v)
    for ov in value_over:
        k, v = ov.split("=", 1)
        _set_path(cfg, k, _parse_value(v))

    return resolve(cfg)


def explicit_overrides(overrides: List[str] | None) -> Dict[str, Any]:
    """Just the CLI-passed dotted overrides as a nested dict (parsed values).

    eval.py/forward.py rebuild their model from the checkpoint's embedded run
    config; composed group DEFAULTS must not clobber it - only what the user
    explicitly typed on the command line should override (the reference gets
    this from hydra's sparse eval.yaml + checkpoint create_model semantics).
    """
    out: Dict[str, Any] = {}
    for ov in overrides or []:
        if "=" not in ov:
            continue
        k, v = ov.split("=", 1)
        if "." in k:
            _set_path(out, k, _parse_value(v))
    return out
