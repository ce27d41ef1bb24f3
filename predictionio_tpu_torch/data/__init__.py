"""Data layer of the port: the event model, the in-memory event store,
its columnar decoding, and the storage that training and deploy share."""

from predictionio_tpu_torch.data.event import (
    BiMap,
    DataMap,
    DataMapError,
    Event,
    EventValidationError,
    PropertyMap,
    aggregate_properties,
    is_reserved_event,
    validate_event,
)

__all__ = [
    "BiMap",
    "DataMap",
    "DataMapError",
    "Event",
    "EventValidationError",
    "PropertyMap",
    "aggregate_properties",
    "is_reserved_event",
    "validate_event",
]
