"""Polymorphic JSON serde for configuration beans.

Replaces the reference's Jackson polymorphic type registry
(reference nn/conf/layers/Layer.java:43-56 ``@JsonSubTypes`` list). Beans are
dataclasses registered under a stable type name; serialization tags each
object with ``"@type"`` so heterogeneous lists (layers, preprocessors,
vertices) round-trip.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from typing import Any, Type, TypeVar

_REGISTRY: dict[str, type] = {}
_TYPE_KEY = "@type"

T = TypeVar("T")


def register_bean(name: str):
    """Class decorator: register a dataclass under a stable JSON type name."""

    def deco(cls):
        if name in _REGISTRY and _REGISTRY[name] is not cls:
            raise ValueError(f"Duplicate bean name {name!r}")
        _REGISTRY[name] = cls
        cls.__bean_name__ = name
        return cls

    return deco


def bean_name(obj_or_cls) -> str:
    cls = obj_or_cls if isinstance(obj_or_cls, type) else type(obj_or_cls)
    try:
        return cls.__bean_name__
    except AttributeError:
        raise ValueError(f"{cls.__name__} is not a registered bean") from None


def to_jsonable(obj: Any) -> Any:
    """Recursively convert beans/enums/containers to plain JSON values."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, enum.Enum):
        return obj.value
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {_TYPE_KEY: bean_name(obj)}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            out[f.name] = to_jsonable(v)
        return out
    if isinstance(obj, (list, tuple)):
        return [to_jsonable(v) for v in obj]
    if isinstance(obj, dict):
        return {str(k): to_jsonable(v) for k, v in obj.items()}
    raise TypeError(f"Cannot serialize {type(obj).__name__}: {obj!r}")


def from_jsonable(data: Any) -> Any:
    """Inverse of :func:`to_jsonable`; rebuilds beans from ``@type`` tags."""
    if isinstance(data, dict):
        if _TYPE_KEY in data:
            d = dict(data)
            name = d.pop(_TYPE_KEY)
            try:
                cls = _REGISTRY[name]
            except KeyError:
                raise ValueError(f"Unknown bean type {name!r}") from None
            field_types = {f.name: f.type for f in dataclasses.fields(cls)}
            kwargs = {}
            for k, v in d.items():
                if k not in field_types:
                    continue  # forward-compat: ignore unknown fields
                kwargs[k] = from_jsonable(v)
            obj = cls(**kwargs)
            return _coerce_enums(obj)
        return {k: from_jsonable(v) for k, v in data.items()}
    if isinstance(data, list):
        return [from_jsonable(v) for v in data]
    return data


_HINTS_CACHE: dict[type, dict] = {}


def enum_field_type(cls: type, field_name: str):
    """The Enum type a dataclass field is declared with (unwrapping
    Optional/union hints), or None."""
    import typing
    import types as _types

    hints = _HINTS_CACHE.get(cls)
    if hints is None:
        hints = typing.get_type_hints(cls)
        _HINTS_CACHE[cls] = hints
    t = hints.get(field_name)
    if typing.get_origin(t) in (typing.Union, _types.UnionType):
        args = [a for a in typing.get_args(t) if a is not type(None)]
        enum_args = [
            a for a in args if isinstance(a, type) and issubclass(a, enum.Enum)
        ]
        t = enum_args[0] if enum_args else None
    if isinstance(t, type) and issubclass(t, enum.Enum):
        return t
    return None


def coerce_enum_value(cls: type, field_name: str, value):
    """Coerce a string into the field's Enum member, accepting either
    the member NAME ("LBFGS") or its wire value ("lbfgs") — shared by
    JSON deserialization and the fluent Builder setters."""
    t = enum_field_type(cls, field_name)
    if t is not None and isinstance(value, str) and not isinstance(value, t):
        try:
            return t[value.upper()]
        except KeyError:
            return t(value)
    return value


def _coerce_enums(obj):
    """Coerce string field values back into Enum members where the dataclass
    declared an Enum type (JSON carries only the value)."""
    cls = type(obj)
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if not isinstance(v, str):
            continue
        coerced = coerce_enum_value(cls, f.name, v)
        if coerced is not v:
            object.__setattr__(obj, f.name, coerced)
    return obj


def to_json(obj: Any, indent: int | None = 2) -> str:
    return json.dumps(to_jsonable(obj), indent=indent)


def from_json(s: str) -> Any:
    return from_jsonable(json.loads(s))
