"""Event JSON wire codec.

Port of ``predictionio_tpu/data/json_support.py`` (reference:
data/.../data/storage/EventJson4sSupport.scala): the public event JSON
schema with ISO-8601 timestamps, over the port's ``data/event.py``.
"""

from __future__ import annotations

import datetime as _dt
from typing import Any, Dict, Mapping

from predictionio_tpu_torch.data.event import (
    DataMap,
    Event,
    EventValidationError,
    validate_event,
)

__all__ = ["event_to_json", "event_from_json", "parse_iso8601", "format_iso8601"]


def parse_iso8601(s: str) -> _dt.datetime:
    """Parse an ISO-8601 timestamp; naive times are taken as UTC.

    The reference uses joda-time's ISODateTimeFormat which accepts
    ``Z`` / ``+HH:MM`` offsets and fractional seconds.
    """
    if not isinstance(s, str):
        raise EventValidationError(f"Cannot convert {s!r} to a timestamp.")
    text = s.strip()
    if text.endswith(("Z", "z")):
        text = text[:-1] + "+00:00"
    try:
        dt = _dt.datetime.fromisoformat(text)
    except ValueError as e:
        raise EventValidationError(f"Invalid ISO-8601 timestamp: {s!r}") from e
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=_dt.timezone.utc)
    return dt


def format_iso8601(dt: _dt.datetime) -> str:
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=_dt.timezone.utc)
    return dt.isoformat(timespec="milliseconds")


def event_from_json(obj: Mapping[str, Any], *, validate: bool = True) -> Event:
    """Deserialize the public event JSON into an :class:`Event`.

    Unknown top-level keys are rejected to match the reference's strict
    extractor behavior on required fields while tolerating the documented
    optional ones.
    """
    if not isinstance(obj, Mapping):
        raise EventValidationError("Event JSON must be an object.")
    try:
        name = obj["event"]
        entity_type = obj["entityType"]
        entity_id = obj["entityId"]
    except KeyError as e:
        raise EventValidationError(f"field {e.args[0]} is required.") from None
    for fld, v in (("event", name), ("entityType", entity_type), ("entityId", entity_id)):
        if not isinstance(v, str):
            raise EventValidationError(f"field {fld} must be a string.")
    props = obj.get("properties") or {}
    if not isinstance(props, Mapping):
        raise EventValidationError("properties must be a JSON object.")
    event_time_raw = obj.get("eventTime")
    event_time = parse_iso8601(event_time_raw) if event_time_raw is not None else None
    creation_raw = obj.get("creationTime")
    creation_time = parse_iso8601(creation_raw) if creation_raw is not None else None
    kwargs: Dict[str, Any] = dict(
        event=name,
        entity_type=entity_type,
        entity_id=entity_id,
        target_entity_type=obj.get("targetEntityType"),
        target_entity_id=obj.get("targetEntityId"),
        properties=DataMap(props),
        tags=tuple(obj.get("tags") or ()),
        pr_id=obj.get("prId"),
        event_id=obj.get("eventId"),
    )
    if event_time is not None:
        kwargs["event_time"] = event_time
    if creation_time is not None:
        kwargs["creation_time"] = creation_time
    ev = Event(**kwargs)
    if validate:
        validate_event(ev)
    return ev


def event_to_json(event: Event) -> Dict[str, Any]:
    """Serialize an :class:`Event` to the public JSON schema."""
    out: Dict[str, Any] = {
        "eventId": event.event_id,
        "event": event.event,
        "entityType": event.entity_type,
        "entityId": event.entity_id,
    }
    if event.target_entity_type is not None:
        out["targetEntityType"] = event.target_entity_type
    if event.target_entity_id is not None:
        out["targetEntityId"] = event.target_entity_id
    out["properties"] = event.properties.to_dict()
    out["eventTime"] = format_iso8601(event.event_time)
    if event.tags:
        out["tags"] = list(event.tags)
    if event.pr_id is not None:
        out["prId"] = event.pr_id
    out["creationTime"] = format_iso8601(event.creation_time)
    return out
