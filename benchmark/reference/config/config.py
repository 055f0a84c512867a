"""Python-file config loader with ``_base_`` inheritance and dotted overrides.

The port's own copy of ``unibev_tpu/config/config.py`` (the port imports
nothing of ``unibev_tpu``): the slice of mmcv ``Config`` the reference uses,
``Config.fromfile`` on python-module configs such as ``configs/unibev/*.py``,
``_base_`` inheritance (``configs/unibev/inference/*.py``), ``--cfg-options``
style dotted deep-merge, and attribute access / dump.
"""

from __future__ import annotations

import ast
import copy
import os
import os.path as osp
import pprint
import types
from typing import Any, Dict, List, Optional, Union

BASE_KEY = "_base_"
DELETE_KEY = "_delete_"
RESERVED = {"__builtins__", "__name__", "__doc__", "__file__", "__loader__",
            "__spec__", "__package__", "__cached__"}


class ConfigDict(dict):
    """dict with attribute access, recursively applied."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __deepcopy__(self, memo):
        return ConfigDict({copy.deepcopy(k, memo): copy.deepcopy(v, memo)
                           for k, v in self.items()})


def _to_configdict(obj: Any) -> Any:
    if isinstance(obj, dict):
        return ConfigDict({k: _to_configdict(v) for k, v in obj.items()})
    if isinstance(obj, (list, tuple)):
        converted = [_to_configdict(v) for v in obj]
        return type(obj)(converted) if isinstance(obj, tuple) else converted
    return obj


def _merge_dict(base: dict, new: dict) -> dict:
    """new wins; nested dicts merge recursively unless ``_delete_`` is set."""
    out = copy.deepcopy(base)
    for k, v in new.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict) and not v.get(DELETE_KEY, False):
            out[k] = _merge_dict(out[k], v)
        else:
            if isinstance(v, dict):
                v = {kk: vv for kk, vv in v.items() if kk != DELETE_KEY}
            out[k] = copy.deepcopy(v)
    return out


def _exec_pyfile(filename: str) -> Dict[str, Any]:
    filename = osp.abspath(osp.expanduser(filename))
    if not osp.isfile(filename):
        raise FileNotFoundError(filename)
    with open(filename) as f:
        source = f.read()
    # Validate syntax early with a clear error.
    ast.parse(source, filename=filename)
    module = types.ModuleType("_unibev_cfg")
    module.__file__ = filename
    exec(compile(source, filename, "exec"), module.__dict__)
    return {k: v for k, v in vars(module).items()
            if k not in RESERVED
            and not isinstance(v, types.ModuleType)
            and not callable(v)}


def _load_with_bases(filename: str) -> Dict[str, Any]:
    cfg = _exec_pyfile(filename)
    bases = cfg.pop(BASE_KEY, None)
    if bases is None:
        return cfg
    if isinstance(bases, str):
        bases = [bases]
    merged: Dict[str, Any] = {}
    cfg_dir = osp.dirname(osp.abspath(osp.expanduser(filename)))
    for base in bases:
        base_cfg = _load_with_bases(osp.join(cfg_dir, base))
        merged = _merge_dict(merged, base_cfg)
    return _merge_dict(merged, cfg)


class Config:
    """Attribute-accessible config tree loaded from a python file."""

    def __init__(self, cfg_dict: Optional[dict] = None, filename: Optional[str] = None):
        object.__setattr__(self, "_cfg_dict", _to_configdict(cfg_dict or {}))
        object.__setattr__(self, "_filename", filename)

    @staticmethod
    def fromfile(filename: str) -> "Config":
        return Config(_load_with_bases(filename), filename=filename)

    @property
    def filename(self) -> Optional[str]:
        return self._filename

    def __getattr__(self, name: str) -> Any:
        return getattr(self._cfg_dict, name)

    def __setattr__(self, name: str, value: Any) -> None:
        self._cfg_dict[name] = _to_configdict(value)

    def __getitem__(self, name: str) -> Any:
        return self._cfg_dict[name]

    def __setitem__(self, name: str, value: Any) -> None:
        self._cfg_dict[name] = _to_configdict(value)

    def __contains__(self, name: str) -> bool:
        return name in self._cfg_dict

    def get(self, name: str, default: Any = None) -> Any:
        return self._cfg_dict.get(name, default)

    def keys(self):
        return self._cfg_dict.keys()

    def merge_from_dict(self, options: Dict[str, Any]) -> None:
        """Deep-merge dotted-key overrides, e.g. {'model.use_lidar': False}.

        Same semantics as the reference's ``--cfg-options`` path
        (tools/train_UniBEV.py:105-106 -> mmcv Config.merge_from_dict).
        """
        expanded: Dict[str, Any] = {}
        for full_key, v in options.items():
            d = expanded
            parts = full_key.split(".")
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = v
        merged = _merge_dict(dict(self._cfg_dict), expanded)
        object.__setattr__(self, "_cfg_dict", _to_configdict(merged))

    def to_dict(self) -> dict:
        return copy.deepcopy(dict(self._cfg_dict))

    @property
    def pretty_text(self) -> str:
        return pprint.pformat(self.to_dict(), width=100, sort_dicts=False)

    def dump(self, file: str) -> None:
        os.makedirs(osp.dirname(osp.abspath(file)), exist_ok=True)
        with open(file, "w") as f:
            for k, v in self.to_dict().items():
                f.write(f"{k} = {v!r}\n")

    def __repr__(self) -> str:
        return f"Config(file={self._filename})\n{self.pretty_text}"


def parse_cfg_option_value(raw: str) -> Any:
    """Parse a --cfg-options value: literal eval with bool/None/list support."""
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        lowered = raw.lower()
        if lowered in ("true", "false"):
            return lowered == "true"
        if lowered in ("none", "null"):
            return None
        if "," in raw:
            return [parse_cfg_option_value(s) for s in raw.split(",")]
        return raw
