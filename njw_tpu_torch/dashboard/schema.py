"""Typed dashboard row schema, shared with proto/dashboard.proto:
counterpart of ``njw_tpu/dashboard/schema.py``.

The single source of truth is ``proto/dashboard.proto`` at the
repository root (three directories up from this file, the same file the
JAX package reads). This module parses it and checks it field for field
against ``njw_tpu_torch.bench.suite.BenchmarkResult`` (the JAX field
names), so JSON payloads, proto schema and Python types cannot drift
apart silently.
"""
from __future__ import annotations

import os
import re

_PROTO_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "proto",
    "dashboard.proto")

# proto scalar -> python type of the JSON payload
_PY_TYPES = {
    "string": str,
    "double": float,
    "float": float,
    "int32": int,
    "int64": int,
    "bool": bool,
}


def parse_proto_messages(path: str = _PROTO_PATH) -> dict[str, dict]:
    """Tiny proto3 parser: {message: {field: (type, repeated)}}.
    Handles scalar fields, map<,>, repeated, and message-typed fields —
    all that dashboard.proto uses."""
    with open(path) as fh:
        text = fh.read()
    text = re.sub(r"//[^\n]*", "", text)
    messages: dict[str, dict] = {}
    for m in re.finditer(r"message\s+(\w+)\s*\{([^}]*)\}", text):
        name, body = m.group(1), m.group(2)
        fields = {}
        for f in re.finditer(
                r"(repeated\s+)?(map<[\w\s,]+>|[\w.]+)\s+(\w+)\s*=\s*\d+",
                body):
            repeated = bool(f.group(1))
            ftype = f.group(2).replace(" ", "")
            fields[f.group(3)] = (ftype, repeated)
        messages[name] = fields
    return messages


def result_row_fields() -> dict[str, tuple]:
    """Fields of BenchmarkResultRow from the proto file."""
    return parse_proto_messages()["BenchmarkResultRow"]


def check_result_schema() -> None:
    """Assert the proto BenchmarkResultRow and the Python dataclass agree
    field-for-field. Raises AssertionError listing any drift."""
    import dataclasses

    from njw_tpu_torch.bench.suite import BenchmarkResult

    proto_fields = set(result_row_fields())
    py_fields = {f.name for f in dataclasses.fields(BenchmarkResult)}
    missing = py_fields - proto_fields
    extra = proto_fields - py_fields
    if missing or extra:
        raise AssertionError(
            f"dashboard schema drift: proto missing {sorted(missing)}, "
            f"proto extra {sorted(extra)}")


def normalize_row(row: dict) -> dict:
    """Coerce a raw results.json row to the typed schema: every proto
    field present with the right JSON type; unknown keys preserved under
    'additional_metrics' semantics are left intact."""
    out = dict(row)
    for name, (ftype, repeated) in result_row_fields().items():
        if ftype.startswith("map<"):
            out[name] = dict(row.get(name) or {})
        elif repeated:
            out[name] = list(row.get(name) or [])
        else:
            py = _PY_TYPES.get(ftype)
            val = row.get(name)
            if py is None:
                out[name] = val
            elif val is None:
                out[name] = py()
            else:
                out[name] = py(val)
    return out
