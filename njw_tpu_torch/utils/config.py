"""Configuration files and command-line overrides for dataclass configs.

Counterpart of ``njw_tpu/utils/config.py``, over the port's ``SimConfig``
(or any dataclass): ``save_config`` writes JSON, or YAML for a .yaml /
.yml path; ``load_config`` reads either into the dataclass and refuses
unknown keys; ``apply_cli_overrides`` applies ``key=value`` pairs with
the type of each field's current value. YAML needs PyYAML, imported only
when a YAML path is given.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Type, TypeVar

T = TypeVar("T")


def _to_plain(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _to_plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_to_plain(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _to_plain(v) for k, v in obj.items()}
    return obj


def save_config(config: Any, path: str) -> str:
    """Write a dataclass config as YAML (.yaml/.yml) or JSON."""
    payload = _to_plain(config)
    if path.endswith((".yaml", ".yml")):
        import yaml

        with open(path, "w") as fh:
            yaml.safe_dump(payload, fh, sort_keys=False)
    else:
        with open(path, "w") as fh:
            json.dump(payload, fh, indent=2)
    return path


def load_config(cls: Type[T], path: str, **overrides) -> T:
    """Read YAML/JSON into a dataclass, applying keyword overrides last.
    Unknown keys raise."""
    if path.endswith((".yaml", ".yml")):
        import yaml

        with open(path) as fh:
            data = yaml.safe_load(fh) or {}
    else:
        with open(path) as fh:
            data = json.load(fh)
    data.update(overrides)
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(data) - names
    if unknown:
        raise ValueError(f"unknown config keys for {cls.__name__}: "
                         f"{sorted(unknown)}")
    return cls(**data)


def apply_cli_overrides(config: T, pairs: list[str]) -> T:
    """Apply 'key=value' CLI overrides, each value converted to the type
    of the field's current value (bool, int, float, else str)."""
    updates = {}
    fields = {f.name: f for f in dataclasses.fields(config)}
    for pair in pairs:
        key, _, raw = pair.partition("=")
        if key not in fields:
            raise ValueError(f"unknown config key {key!r}")
        current = getattr(config, key)
        if isinstance(current, bool):
            updates[key] = raw.lower() in ("1", "true", "yes")
        elif isinstance(current, int):
            updates[key] = int(raw)
        elif isinstance(current, float):
            updates[key] = float(raw)
        else:
            updates[key] = raw
    return dataclasses.replace(config, **updates)
