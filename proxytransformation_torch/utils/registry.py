"""Name → class registries with config-dict build.

The port's own copy of proxytransformation_tpu/utils/registry.py: the
reference wires its components through mmengine registries (reference
embodiedscan/registry.py:11-36); `dict(type='Name', ...)` →
`MODELS.build(cfg)` keeps that surface without mmengine.
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional


class Registry:
    """Name → class registry with config-dict build."""

    def __init__(self, name: str, parent: Optional['Registry'] = None):
        self.name = name
        self._module_dict: Dict[str, Any] = {}
        self.parent = parent

    def __contains__(self, key: str) -> bool:
        return key in self._module_dict or (self.parent is not None
                                            and key in self.parent)

    def get(self, key: str) -> Any:
        if key in self._module_dict:
            return self._module_dict[key]
        if self.parent is not None and key in self.parent:
            return self.parent.get(key)
        raise KeyError(f'{key!r} is not registered in registry {self.name!r};'
                       f' known: {sorted(self._module_dict)}')

    def register_module(self,
                        name: Optional[str] = None,
                        module: Optional[Any] = None,
                        force: bool = False) -> Callable:
        """Register a class/function, usable as a decorator."""

        def _register(mod):
            key = name or mod.__name__
            if not force and key in self._module_dict:
                raise KeyError(f'{key} already registered in {self.name}')
            self._module_dict[key] = mod
            return mod

        if module is not None:
            return _register(module)
        return _register

    def build(self, cfg: Dict[str, Any], **default_kwargs) -> Any:
        """Instantiate from `dict(type='Name', **kwargs)`."""
        if cfg is None:
            return None
        if not isinstance(cfg, dict) or 'type' not in cfg:
            raise TypeError(f'cfg must be a dict with a "type" key, got {cfg}')
        cfg = dict(cfg)
        obj_type = cfg.pop('type')
        if isinstance(obj_type, str):
            obj_cls = self.get(obj_type)
        else:
            obj_cls = obj_type
        kwargs = {**default_kwargs, **cfg}
        # an unexpected keyword fails loudly, with the signature
        try:
            return obj_cls(**kwargs)
        except TypeError as e:
            sig = None
            try:
                sig = str(inspect.signature(obj_cls))
            except (TypeError, ValueError):
                pass
            raise TypeError(
                f'Failed to build {obj_type} from registry {self.name}: {e}'
                + (f' (signature: {sig})' if sig else '')) from e


MODELS = Registry('models')
TASK_UTILS = Registry('task_utils')
DATASETS = Registry('datasets')
TRANSFORMS = Registry('transforms')
METRICS = Registry('metrics')
LOOPS = Registry('loops')
VISUALIZERS = Registry('visualizers')
VISBACKENDS = Registry('vis_backends')
