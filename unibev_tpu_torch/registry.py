"""String-keyed component registries of the port.

Counterpart of ``unibev_tpu/registry.py``: the same small ``Registry`` and the
same reference type names, but separate instances, so the port and the JAX
package can both register "UniBEV", "ResNet" and the rest in one process.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Callable, Dict, Optional


class Registry:
    """Minimal name -> class registry with mmcv's build semantics."""

    def __init__(self, name: str):
        self.name = name
        self._module_dict: Dict[str, Any] = {}

    def get(self, key: str) -> Optional[Any]:
        return self._module_dict.get(key)

    def register_module(self, name: Optional[str] = None) -> Callable:
        def _register(cls):
            key = name or cls.__name__
            if key in self._module_dict:
                raise KeyError(f"{key} already registered in {self.name}")
            self._module_dict[key] = cls
            return cls

        return _register

    def build(self, cfg: Dict[str, Any]) -> Any:
        """Instantiate ``self[cfg['type']](**cfg_without_type)``."""
        if not isinstance(cfg, Mapping) or "type" not in cfg:
            raise TypeError(f"cfg must be a dict with a 'type' key, got {cfg!r}")
        args = dict(cfg)
        obj_type = args.pop("type")
        obj_cls = self.get(obj_type)
        if obj_cls is None:
            raise KeyError(f"{obj_type} is not registered in {self.name}. "
                           f"Available: {sorted(self._module_dict)}")
        return obj_cls(**args)


# The registries this slice of the port fills, under the reference's names.
DETECTORS = Registry("detectors")
HEADS = Registry("heads")
BACKBONES = Registry("backbones")
NECKS = Registry("necks")
VOXEL_ENCODERS = Registry("voxel_encoders")
MIDDLE_ENCODERS = Registry("middle_encoders")
TRANSFORMERS = Registry("transformers")
TRANSFORMER_LAYER_SEQUENCES = Registry("transformer_layer_sequences")
ATTENTION = Registry("attention")
POSITIONAL_ENCODINGS = Registry("positional_encodings")
BBOX_CODERS = Registry("bbox_coders")
BBOX_ASSIGNERS = Registry("bbox_assigners")
MATCH_COSTS = Registry("match_costs")
LOSSES = Registry("losses")
