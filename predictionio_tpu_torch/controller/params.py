"""Typed parameter binding: engine.json → dataclass Params.

Reference: core/.../workflow/JsonExtractor.scala — binds the ``engine.json``
variant's ``datasource`` / ``preparator`` / ``algorithms[]`` / ``serving``
param blocks onto typed case classes, erroring on type mismatches.  Here
"case class" is a Python dataclass; binding is strict: unknown keys and
type mismatches raise :class:`ParamsBindingError`.
"""

from __future__ import annotations

import dataclasses
import json
import typing
from typing import Any, Dict, Mapping, Optional, Type, TypeVar

__all__ = ["Params", "EmptyParams", "ParamsBindingError", "bind_params", "params_to_dict"]


class ParamsBindingError(TypeError):
    pass


@dataclasses.dataclass(frozen=True)
class Params:
    """Marker base for engine parameter dataclasses (reference: Params trait).

    Subclass with ``@dataclass(frozen=True)`` fields; defaults become
    optional engine.json keys.
    """


@dataclasses.dataclass(frozen=True)
class EmptyParams(Params):
    """Reference: EmptyParams — roles that take no parameters."""


T = TypeVar("T", bound=Params)


def _coerce(value: Any, annot: Any, path: str) -> Any:
    origin = typing.get_origin(annot)
    if annot is Any or annot is dataclasses.MISSING or annot is None:
        return value
    if origin is typing.Union:  # includes Optional[X]
        args = typing.get_args(annot)
        if value is None:
            if type(None) in args:
                return None
            raise ParamsBindingError(f"{path}: null not allowed for {annot}.")
        non_none = [a for a in args if a is not type(None)]
        last_err: Optional[Exception] = None
        for a in non_none:
            try:
                return _coerce(value, a, path)
            except ParamsBindingError as e:
                last_err = e
        raise ParamsBindingError(f"{path}: {value!r} matches no arm of {annot}.") from last_err
    if origin in (list, tuple):
        if not isinstance(value, (list, tuple)):
            raise ParamsBindingError(f"{path}: expected list, got {type(value).__name__}.")
        args = typing.get_args(annot)
        elem = args[0] if args else Any
        seq = [_coerce(v, elem, f"{path}[{i}]") for i, v in enumerate(value)]
        return tuple(seq) if origin is tuple else seq
    if origin is dict:
        if not isinstance(value, Mapping):
            raise ParamsBindingError(f"{path}: expected object, got {type(value).__name__}.")
        kt, vt = (typing.get_args(annot) + (Any, Any))[:2]
        return {
            _coerce(k, kt, f"{path}.<key>"): _coerce(v, vt, f"{path}.{k}")
            for k, v in value.items()
        }
    if dataclasses.is_dataclass(annot):
        if not isinstance(value, Mapping):
            raise ParamsBindingError(f"{path}: expected object for nested params.")
        return bind_params(annot, value, _path=path)
    if annot is bool:
        if not isinstance(value, bool):
            raise ParamsBindingError(f"{path}: expected bool, got {type(value).__name__}.")
        return value
    if annot is int:
        if isinstance(value, bool) or not isinstance(value, int):
            raise ParamsBindingError(f"{path}: expected int, got {type(value).__name__}.")
        return value
    if annot is float:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise ParamsBindingError(f"{path}: expected number, got {type(value).__name__}.")
        return float(value)
    if annot is str:
        if not isinstance(value, str):
            raise ParamsBindingError(f"{path}: expected string, got {type(value).__name__}.")
        return value
    return value


_HINTS_CACHE: Dict[type, Dict[str, Any]] = {}


def _type_hints(cls: type) -> Dict[str, Any]:
    """Cached ``typing.get_type_hints``: evaluating annotations was 23% of
    the serving hot path (it re-compiles every string annotation per call;
    query classes are bound once per REQUEST)."""
    hints = _HINTS_CACHE.get(cls)
    if hints is None:
        hints = _HINTS_CACHE[cls] = typing.get_type_hints(cls)
    return hints


def bind_params(cls: Type[T], data: Optional[Mapping[str, Any]], _path: str = "params") -> T:
    """Bind a JSON object onto a Params dataclass, strictly."""
    if not dataclasses.is_dataclass(cls):
        raise ParamsBindingError(f"{cls!r} is not a dataclass Params type.")
    data = dict(data or {})
    hints = _type_hints(cls)
    kwargs: Dict[str, Any] = {}
    # Python-reserved-word aliasing: the reference's engine.json spells
    # e.g. ALS regParam as "lambda"; the dataclass field is "lambda_".
    for f in dataclasses.fields(cls):
        if f.name.endswith("_") and f.name[:-1] in data \
                and f.name not in data:
            data[f.name] = data.pop(f.name[:-1])
    for f in dataclasses.fields(cls):
        if f.name in data:
            kwargs[f.name] = _coerce(data.pop(f.name), hints.get(f.name, Any), f"{_path}.{f.name}")
        elif (
            f.default is dataclasses.MISSING
            and f.default_factory is dataclasses.MISSING  # type: ignore[misc]
        ):
            raise ParamsBindingError(f"{_path}.{f.name} is required for {cls.__name__}.")
    if data:
        raise ParamsBindingError(
            f"{_path}: unknown keys {sorted(data)} for {cls.__name__} "
            f"(known: {[f.name for f in dataclasses.fields(cls)]})."
        )
    return cls(**kwargs)


def params_to_dict(params: Any) -> Dict[str, Any]:
    """Serialize Params back to a JSON-able dict (for EngineInstance rows)."""
    if params is None:
        return {}
    if dataclasses.is_dataclass(params):
        return json.loads(json.dumps(dataclasses.asdict(params)))
    if isinstance(params, Mapping):
        return dict(params)
    raise ParamsBindingError(f"Cannot serialize params of type {type(params).__name__}.")
