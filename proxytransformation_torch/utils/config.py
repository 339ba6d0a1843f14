"""Python-file configs with `_base_` inheritance and dot-key overrides.

The port's own copy of proxytransformation_tpu/utils/config.py (numpy-
free, so the same code; the port imports nothing of the JAX package):
configs are plain python files whose module-level variables become the
config dict; `_base_ = [...]` merges parent configs; `--cfg-options
a.b.c=v` sets dotted keys (reference tools/train.py:41-50, 72-80).
"""
from __future__ import annotations

import ast
import copy
import os
from typing import Any, Dict, List, Optional


def _deep_merge(base: Dict, new: Dict) -> Dict:
    """Recursively merge `new` into a copy of `base` (new wins)."""
    out = copy.deepcopy(base)
    for k, v in new.items():
        if (k in out and isinstance(out[k], dict) and isinstance(v, dict)
                and not v.pop('_delete_', False)):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _exec_config_file(filename: str) -> Dict[str, Any]:
    filename = os.path.abspath(os.path.expanduser(filename))
    with open(filename, 'r') as f:
        code = f.read()
    module_ns: Dict[str, Any] = {'__file__': filename}
    exec(compile(code, filename, 'exec'), module_ns)
    cfg = {
        k: v
        for k, v in module_ns.items()
        if not k.startswith('__') and not callable(v)
        and not isinstance(v, type(os))
    }
    base = cfg.pop('_base_', None)
    if base is not None:
        if isinstance(base, str):
            base = [base]
        merged: Dict[str, Any] = {}
        for b in base:
            b_path = os.path.join(os.path.dirname(filename), b)
            merged = _deep_merge(merged, _exec_config_file(b_path))
        cfg = _deep_merge(merged, cfg)
    return cfg


def _parse_value(v: str) -> Any:
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


class Config:
    """Dict-backed config with attribute access."""

    def __init__(self, cfg_dict: Optional[Dict[str, Any]] = None,
                 filename: Optional[str] = None):
        self._cfg_dict = cfg_dict or {}
        self.filename = filename

    @classmethod
    def fromfile(cls, filename: str) -> 'Config':
        return cls(_exec_config_file(filename), filename=filename)

    def merge_from_dict(self, options: Dict[str, Any]) -> None:
        """Merge `{'a.b.c': v}` style dotted options."""
        for full_key, v in options.items():
            d = self._cfg_dict
            keys = full_key.split('.')
            for k in keys[:-1]:
                d = d.setdefault(k, {})
            d[keys[-1]] = v

    @staticmethod
    def parse_cfg_options(pairs: List[str]) -> Dict[str, Any]:
        """Parse CLI `key=value` strings."""
        out: Dict[str, Any] = {}
        for pair in pairs or []:
            key, _, val = pair.partition('=')
            out[key] = _parse_value(val)
        return out

    # -- mapping / attribute protocol -------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name.startswith('_'):
            raise AttributeError(name)
        try:
            return self._cfg_dict[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __getitem__(self, name: str) -> Any:
        return self._cfg_dict[name]

    def __setitem__(self, name: str, value: Any) -> None:
        self._cfg_dict[name] = value

    def __contains__(self, name: str) -> bool:
        return name in self._cfg_dict

    def get(self, name: str, default: Any = None) -> Any:
        return self._cfg_dict.get(name, default)

    def setdefault(self, name: str, default: Any = None) -> Any:
        return self._cfg_dict.setdefault(name, default)

    def keys(self):
        return self._cfg_dict.keys()

    def to_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(self._cfg_dict)

    def __repr__(self) -> str:
        return f'Config(filename={self.filename!r}, keys={sorted(self._cfg_dict)})'
