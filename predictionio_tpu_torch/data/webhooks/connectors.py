"""Connector traits + the two reference example connectors.

Reference classes: webhooks/JsonConnector.scala, FormConnector.scala,
ConnectorUtil.scala, segmentio/SegmentIOConnector.scala,
mailchimp/MailChimpConnector.scala (SURVEY.md §2.1 "Webhooks").
A connector maps one provider payload to the standard event JSON
(Appendix A), which then flows through the normal ingestion path —
connectors never write storage themselves.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, List, Mapping, Type

__all__ = ["ConnectorError", "JsonConnector", "FormConnector",
           "SegmentIOConnector", "MailchimpConnector", "register_connector",
           "get_connector"]


class ConnectorError(ValueError):
    """Reference: ConnectorException."""


class JsonConnector(abc.ABC):
    """Payload is a JSON object (reference: JsonConnector.toEventJson)."""

    @abc.abstractmethod
    def to_event_json(self, payload: Mapping[str, Any]) -> Dict[str, Any]: ...

    def to_events_json(self, payload: Mapping[str, Any]) -> List[Dict[str, Any]]:
        """Burst entry: one provider delivery → N event JSONs,
        fed through the server's batched-ingest fold as ONE group commit
        instead of a per-row ``create_event`` loop.  Default wraps the
        single-event mapping; connectors whose providers batch deliveries
        (segment.io) override."""
        return [self.to_event_json(payload)]


class FormConnector(abc.ABC):
    """Payload is form-encoded key/value (reference: FormConnector)."""

    @abc.abstractmethod
    def to_event_json(self, form: Mapping[str, str]) -> Dict[str, Any]: ...

    def to_events_json(self, form: Mapping[str, str]) -> List[Dict[str, Any]]:
        """Burst entry — see :meth:`JsonConnector.to_events_json`."""
        return [self.to_event_json(form)]


class SegmentIOConnector(JsonConnector):
    """Reference: segmentio/SegmentIOConnector — maps track/identify/...

    Segment spec fields: type, userId/anonymousId, event, properties/traits,
    timestamp.
    """

    def to_events_json(self, payload: Mapping[str, Any]) -> List[Dict[str, Any]]:
        """Segment's HTTP API delivers call batches as
        ``{"batch": [msg, ...]}`` — coalesce the whole delivery into one
        event list (one group commit downstream).  A malformed message
        inside the batch stays a per-item error: it is passed through as
        a ConnectorError placeholder for the fold to answer 400."""
        if isinstance(payload, Mapping) and isinstance(
                payload.get("batch"), list):
            out: List[Any] = []
            for msg in payload["batch"]:
                try:
                    out.append(self.to_event_json(msg))
                except ConnectorError as e:
                    out.append(e)
            return out
        return [self.to_event_json(payload)]

    def to_event_json(self, payload: Mapping[str, Any]) -> Dict[str, Any]:
        typ = payload.get("type")
        if not typ:
            raise ConnectorError("segmentio payload missing 'type'.")
        user = payload.get("userId") or payload.get("anonymousId")
        if not user:
            raise ConnectorError("segmentio payload missing userId/anonymousId.")
        common: Dict[str, Any] = {
            "entityType": "user",
            "entityId": str(user),
        }
        ts = payload.get("timestamp")
        if ts:
            common["eventTime"] = ts
        if typ == "track":
            name = payload.get("event")
            if not name:
                raise ConnectorError("segmentio track missing 'event'.")
            return {**common, "event": name,
                    "properties": dict(payload.get("properties") or {})}
        if typ == "identify":
            return {**common, "event": "$set",
                    "properties": dict(payload.get("traits") or {})}
        if typ in ("page", "screen"):
            props = dict(payload.get("properties") or {})
            if payload.get("name"):
                props["name"] = payload["name"]
            return {**common, "event": typ, "properties": props}
        if typ == "alias":
            return {**common, "event": "alias",
                    "properties": {"previousId": payload.get("previousId")}}
        if typ == "group":
            return {**common, "event": "group",
                    "properties": {"groupId": payload.get("groupId"),
                                   **dict(payload.get("traits") or {})}}
        raise ConnectorError(f"segmentio type {typ!r} not supported.")


class MailchimpConnector(FormConnector):
    """Reference: mailchimp/MailChimpConnector — subscribe/unsubscribe/...

    Mailchimp webhooks POST form fields like ``type=subscribe``,
    ``data[email]=...``, ``fired_at=...``.
    """

    _SUPPORTED = ("subscribe", "unsubscribe", "profile", "upemail",
                  "cleaned", "campaign")

    def to_event_json(self, form: Mapping[str, str]) -> Dict[str, Any]:
        typ = form.get("type")
        if typ not in self._SUPPORTED:
            raise ConnectorError(f"mailchimp type {typ!r} not supported.")
        entity = (form.get("data[email]") or form.get("data[new_email]")
                  or form.get("data[id]"))
        if not entity:
            raise ConnectorError("mailchimp payload missing data[email]/data[id].")
        props = {k[5:-1]: v for k, v in form.items()
                 if k.startswith("data[") and k.endswith("]")}
        out = {
            "event": typ,
            "entityType": "user",
            "entityId": str(entity),
            "properties": props,
        }
        fired = form.get("fired_at")
        if fired:
            # Mailchimp sends "YYYY-MM-DD HH:MM:SS" — ISO-ify.
            out["eventTime"] = fired.replace(" ", "T") + "+00:00" \
                if "T" not in fired and "+" not in fired else fired
        return out


_REGISTRY: Dict[str, Any] = {
    "segmentio": SegmentIOConnector(),
    "mailchimp": MailchimpConnector(),
}


def register_connector(name: str, connector) -> None:
    """Plugin hook (reference: connector discovery via ServiceLoader)."""
    _REGISTRY[name] = connector


def get_connector(name: str):
    c = _REGISTRY.get(name)
    if c is None:
        raise ConnectorError(f"Unknown webhook connector {name!r}; "
                             f"registered: {sorted(_REGISTRY)}")
    return c
