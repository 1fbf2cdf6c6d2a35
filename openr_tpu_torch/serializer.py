"""Canonical byte serialization of wire types.

Port of `openr_tpu.serializer`, with the same encoding: canonical JSON
(sorted keys, no whitespace, every field written, defaults included)
of `{"__type__": <class name>, "d": <fields>}`, so the two packages
give the same bytes for counterpart objects and each reads the other's
(reference: KvStore compares raw value bytes as a CRDT tie-break,
openr/kvstore/KvStore.cpp mergeKeyValues).

`to_wire` / `from_wire` are the RPC value encoding: dataclasses tagged
`{"!t": TypeName, "!d": ...}` inside arbitrary compositions.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import typing
from typing import Any, Type, TypeVar

from . import types as T

T_ = TypeVar("T_")


_SCALARS = frozenset({str, int, bool, float})
# dataclass type -> its field names, filled on first encode
_FIELD_NAMES: dict[type, tuple[str, ...]] = {}


def _to_jsonable(obj: Any) -> Any:
    if obj is None or type(obj) in _SCALARS:
        return obj
    names = _FIELD_NAMES.get(type(obj))
    if names is not None:
        return {name: _to_jsonable(getattr(obj, name)) for name in names}
    if isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, bytes):
        return {"__bytes__": obj.hex()}
    if isinstance(obj, enum.Enum):
        return int(obj.value)
    if dataclasses.is_dataclass(obj):
        names = _FIELD_NAMES[type(obj)] = tuple(
            f.name for f in dataclasses.fields(obj)
        )
        return {name: _to_jsonable(getattr(obj, name)) for name in names}
    if isinstance(obj, dict):
        return {str(k): _to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    if isinstance(obj, (set, frozenset)):
        return sorted((_to_jsonable(v) for v in obj), key=repr)
    raise TypeError(f"cannot serialize {type(obj)!r}")


def _key_from_str(cls: Any, key: str) -> Any:
    """Undo the str() of dict keys on encode (JSON object keys are
    strings; dict[int, ...] fields must round-trip)."""
    if cls is int:
        return int(key)
    if isinstance(cls, type) and issubclass(cls, enum.Enum):
        return cls(int(key))
    return key


def _from_jsonable(cls: Any, data: Any) -> Any:
    if data is None:
        return None
    if cls in _SCALARS:
        return data
    if isinstance(data, dict) and "__bytes__" in data:
        return bytes.fromhex(data["__bytes__"])
    # an inner forward reference (dict[str, "X"]) stays a plain string
    # through typing.get_type_hints: resolve it by registry name
    if isinstance(cls, str):
        cls = _TYPE_REGISTRY.get(cls, Any)
    elif isinstance(cls, typing.ForwardRef):
        cls = _TYPE_REGISTRY.get(cls.__forward_arg__, Any)
    origin = typing.get_origin(cls)
    if origin is not None:
        args = typing.get_args(cls)
        if origin is dict:
            return {
                _key_from_str(args[0], k): _from_jsonable(args[1], v)
                for k, v in data.items()
            }
        if origin is list:
            return [_from_jsonable(args[0], v) for v in data]
        if origin is tuple:
            elem = args[0] if args else Any
            return tuple(_from_jsonable(elem, v) for v in data)
        if origin in (set, frozenset):
            elem = args[0] if args else Any
            return origin(_from_jsonable(elem, v) for v in data)
        # Optional[X] and other unions: the first member that parses
        for arg in args:
            if arg is type(None):
                continue
            try:
                return _from_jsonable(arg, data)
            except (TypeError, ValueError, KeyError):
                continue
        return data
    if isinstance(cls, type) and issubclass(cls, enum.Enum):
        return cls(data)
    if dataclasses.is_dataclass(cls):
        return cls(
            **{
                name: (
                    data[name]
                    if hint in _SCALARS
                    else _from_jsonable(hint, data[name])
                )
                for name, hint in _field_hints(cls)
                if name in data
            }
        )
    return data


_HINTS_CACHE: dict[type, list[tuple[str, Any]]] = {}


def _field_hints(cls: type) -> list[tuple[str, Any]]:
    """(field name, resolved type hint) of a dataclass, memoized: with
    postponed annotations every hint is a string that
    typing.get_type_hints compiles anew per call."""
    hints = _HINTS_CACHE.get(cls)
    if hints is None:
        resolved = typing.get_type_hints(cls)
        hints = _HINTS_CACHE[cls] = [
            (f.name, resolved[f.name]) for f in dataclasses.fields(cls)
        ]
    return hints


_TYPE_REGISTRY: dict[str, type] = {
    name: getattr(T, name)
    for name in dir(T)
    if dataclasses.is_dataclass(getattr(T, name, None))
}


def dumps(obj: Any) -> bytes:
    """Serialize a wire-type dataclass to canonical bytes."""
    payload = {"__type__": type(obj).__name__, "d": _to_jsonable(obj)}
    return json.dumps(payload, sort_keys=True, separators=(",", ":")).encode()


def loads(data: bytes, expected: Type[T_] | None = None) -> T_:
    payload = json.loads(data.decode())
    cls = _TYPE_REGISTRY[payload["__type__"]]
    if expected is not None and cls is not expected:
        raise TypeError(f"expected {expected.__name__}, got {payload['__type__']}")
    return _from_jsonable(cls, payload["d"])


def register_type(cls: type) -> type:
    """Register a dataclass of another module for (de)serialization;
    usable as a decorator."""
    _TYPE_REGISTRY[cls.__name__] = cls
    return cls


_SENTINEL_KEYS = frozenset({"!t", "!d", "!m", "__bytes__"})


def to_wire(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {"!t": type(obj).__name__, "!d": _to_jsonable(obj)}
    if isinstance(obj, enum.Enum):
        return int(obj.value)
    if isinstance(obj, bytes):
        return {"__bytes__": obj.hex()}
    if isinstance(obj, dict):
        encoded = {str(k): to_wire(v) for k, v in obj.items()}
        if _SENTINEL_KEYS.intersection(encoded):
            # user data that collides with a sentinel: wrap it
            return {"!m": encoded}
        return encoded
    if isinstance(obj, (list, tuple, set, frozenset)):
        return [to_wire(v) for v in obj]
    return obj


def from_wire(data: Any) -> Any:
    if isinstance(data, dict):
        if "!t" in data:
            return _from_jsonable(_TYPE_REGISTRY[data["!t"]], data["!d"])
        if "!m" in data:
            return {k: from_wire(v) for k, v in data["!m"].items()}
        if "__bytes__" in data:
            return bytes.fromhex(data["__bytes__"])
        return {k: from_wire(v) for k, v in data.items()}
    if isinstance(data, list):
        return [from_wire(v) for v in data]
    return data
