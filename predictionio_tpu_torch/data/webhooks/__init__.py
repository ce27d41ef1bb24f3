"""Webhook connectors — adapt third-party payloads to PIO events.

Port of ``predictionio_tpu/data/webhooks/``.  Reference: data/src/main/scala/org/apache/predictionio/data/webhooks/
(SURVEY.md §2.1): ``JsonConnector`` / ``FormConnector`` traits +
``ConnectorUtil`` dispatch, with example connectors for segment.io
(JSON) and mailchimp (form-encoded).  The event server mounts them at
``POST /webhooks/<connector>.json`` (JSON) and
``POST /webhooks/<connector>`` (form).
"""

from predictionio_tpu_torch.data.webhooks.connectors import (
    ConnectorError,
    FormConnector,
    JsonConnector,
    MailchimpConnector,
    SegmentIOConnector,
    get_connector,
    register_connector,
)

__all__ = [
    "ConnectorError",
    "FormConnector",
    "JsonConnector",
    "MailchimpConnector",
    "SegmentIOConnector",
    "get_connector",
    "register_connector",
]
