"""Config override utilities — the CLI dot-path override UX of the
reference's LazyConfig/Hydra hybrid (``lazy_config``, ``config_helper.py:69``)
applied to plain frozen dataclasses.

A copy of ``chronoedit_tpu/utils/config.py`` (the port imports nothing of
the JAX package); :func:`config_to_dict` also writes a ``torch.dtype`` by
its name, as JAX's writes a numpy dtype class.

``apply_overrides(cfg, ["dit.num_layers=2", "guidance_scale=3.5"])`` returns
a new config with the dotted fields replaced (dataclasses are rebuilt
immutably along the path; values are parsed as python literals).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Any, Iterable

import torch


def _parse(value: str) -> Any:
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value  # bare string


def _replace_path(obj: Any, parts: list[str], value: Any) -> Any:
    field = parts[0]
    if not dataclasses.is_dataclass(obj):
        raise TypeError(f"cannot override {field!r} on non-dataclass {type(obj)}")
    names = {f.name for f in dataclasses.fields(obj)}
    if field not in names:
        raise KeyError(f"unknown config field {field!r}; have {sorted(names)}")
    if len(parts) == 1:
        return dataclasses.replace(obj, **{field: value})
    child = getattr(obj, field)
    return dataclasses.replace(obj, **{field: _replace_path(child, parts[1:], value)})


def apply_overrides(cfg: Any, overrides: Iterable[str]) -> Any:
    """Apply ``key.path=value`` overrides to a (nested) frozen dataclass."""
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override {item!r} must be key=value")
        key, _, raw = item.partition("=")
        cfg = _replace_path(cfg, key.strip().split("."), _parse(raw.strip()))
    return cfg


def config_to_dict(cfg: Any) -> Any:
    """Nested dataclass -> plain dict (for config dumps, trainer.py:104-109)."""
    if dataclasses.is_dataclass(cfg):
        return {f.name: config_to_dict(getattr(cfg, f.name))
                for f in dataclasses.fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return type(cfg)(config_to_dict(v) for v in cfg)
    if isinstance(cfg, type):
        return cfg.__name__
    if isinstance(cfg, torch.dtype):
        return str(cfg).removeprefix("torch.")
    return cfg
