"""``aggregate_properties`` in the port against the JAX package.

The same ``$set`` / ``$unset`` / ``$delete`` events (and events that are
not reserved) go through both packages at each level:

- the event fold (``data.event.aggregate_properties``) on one entity's
  events, case by case;
- the storage trait (``Events.aggregate_properties``) on the memory
  backends (each package its own, same inserts) and on sqlite (one
  ``pio.db``, written by the reference, read by both), with
  ``required`` and time bounds;
- the store (``EventStore`` and ``WindowedEventStore``, where only the
  until bound applies and the window start is never injected).

The results must be equal: the same entities, properties,
``first_updated`` and ``last_updated`` (no tolerance; nothing here is
computed in floating point).
"""

import datetime as dt

import pytest

from predictionio_tpu.config import load_config as jax_load_config
from predictionio_tpu.data.event import DataMap as JaxDataMap
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.event import (
    aggregate_properties as jax_aggregate,
)
from predictionio_tpu.data.storage import App as JaxApp
from predictionio_tpu.data.storage import Storage as JaxStorage
from predictionio_tpu.data.store import EventStore as JaxEventStore
from predictionio_tpu.data.store import (
    WindowedEventStore as JaxWindowedEventStore,
)
from predictionio_tpu_torch.config import load_config
from predictionio_tpu_torch.data import aggregate_properties
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage import App, Storage
from predictionio_tpu_torch.data.store import EventStore, WindowedEventStore

T0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
APP = "aggapp"

# (event, entity type, entity id, properties, minutes after T0, creation
# minutes after T0 or None for the event time)
SPECS = [
    ("$set", "item", "a", {"categories": ["c1"], "price": 3}, 0, None),
    ("$set", "item", "a", {"price": 4, "color": "red"}, 5, None),
    ("$unset", "item", "a", {"color": None}, 7, None),
    ("$set", "item", "b", {"categories": ["c2"]}, 1, None),
    ("$delete", "item", "b", {}, 6, None),
    ("$set", "item", "c", {"categories": ["c3"]}, 2, None),
    ("$delete", "item", "c", {}, 3, None),
    ("$set", "item", "c", {"categories": ["c1", "c3"]}, 9, None),
    ("$unset", "item", "d", {"price": None}, 4, None),
    ("view", "item", "e", {"price": 1}, 4, None),
    # two $set at one event time: creation time decides
    ("$set", "item", "f", {"price": 2}, 8, 20),
    ("$set", "item", "f", {"price": 1}, 8, 10),
    ("$set", "user", "u1", {"attr0": 1.0, "plan": 2.0}, 0, None),
    ("$set", "user", "u2", {"attr0": 3.0}, 1, None),
    ("$set", "user", "u3", {"attr0": 1.0, "plan": 1.0}, 2, None),
    ("$unset", "user", "u3", {"plan": None}, 30, None),
    ("$set", "item", "late", {"price": 9}, 40, None),
    ("$set", "item", "a", {"price": 99}, 41, None),
]


def _events(event_cls, datamap_cls, specs=SPECS):
    out = []
    for e, etype, eid, props, minutes, created in specs:
        t = T0 + dt.timedelta(minutes=minutes)
        c = t if created is None else T0 + dt.timedelta(minutes=created)
        out.append(event_cls(event=e, entity_type=etype, entity_id=eid,
                             properties=datamap_cls(props), event_time=t,
                             creation_time=c))
    return out


def _plain(result):
    """A PropertyMap, or a dict of them, as plain comparable values."""
    if result is None:
        return None
    if isinstance(result, dict):
        return {k: _plain(v) for k, v in result.items()}
    return (dict(result), result.first_updated, result.last_updated)


@pytest.mark.parametrize("entity", ["a", "b", "c", "d", "e", "f", "u3"])
def test_event_fold_matches_the_reference(entity):
    """Merges, $unset, $delete, a set after a delete, an $unset alone
    (absent), a non-reserved event (absent) and a creation-time tie."""
    got = aggregate_properties(
        [e for e in _events(Event, DataMap) if e.entity_id == entity])
    want = jax_aggregate(
        [e for e in _events(JaxEvent, JaxDataMap) if e.entity_id == entity])
    assert _plain(got) == _plain(want)
    expected = {"a": {"categories": ["c1"], "price": 99},
                "b": None, "c": {"categories": ["c1", "c3"]}, "d": None,
                "e": None, "f": {"price": 2}, "u3": {"attr0": 1.0}}[entity]
    assert (None if got is None else dict(got)) == expected


def _stores(kind, tmp_path):
    """(reference Storage, port Storage) on one backend, with the events
    inserted: each package its own memory store, or one pio.db the
    reference writes."""
    env = {"PIO_HOME": str(tmp_path)}
    if kind == "memory":
        for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
            env[f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE"] = "MEMORY"
    ref = JaxStorage(jax_load_config(env))
    port = Storage(load_config(env))
    app_id = ref.get_apps().insert(JaxApp(id=None, name=APP))
    ref.get_events().init(app_id)
    ref.get_events().insert_batch(_events(JaxEvent, JaxDataMap), app_id)
    if kind == "memory":
        assert port.get_apps().insert(App(id=None, name=APP)) == app_id
        port.get_events().init(app_id)
        port.get_events().insert_batch(_events(Event, DataMap), app_id)
    return ref, port, app_id


BOUNDS = {
    "all": {},
    "required": {"required": ["attr0", "plan"]},
    "start": {"start_time": T0 + dt.timedelta(minutes=3)},
    "until": {"until_time": T0 + dt.timedelta(minutes=8)},
    "window": {"start_time": T0 + dt.timedelta(minutes=1),
               "until_time": T0 + dt.timedelta(minutes=40)},
}


@pytest.mark.parametrize("bounds", sorted(BOUNDS))
@pytest.mark.parametrize("kind", ["memory", "sqlite"])
def test_storage_and_store_match_the_reference(tmp_path, kind, bounds):
    ref, port, app_id = _stores(kind, tmp_path)
    kw = BOUNDS[bounds]
    for etype in ("item", "user"):
        want = ref.get_events().aggregate_properties(
            app_id, entity_type=etype, **kw)
        got = port.get_events().aggregate_properties(
            app_id, entity_type=etype, **kw)
        assert _plain(got) == _plain(want)
        want_store = JaxEventStore(ref).aggregate_properties(APP, etype, **kw)
        got_store = EventStore(port).aggregate_properties(APP, etype, **kw)
        assert _plain(got_store) == _plain(want) == _plain(want_store)
    if bounds == "required":
        assert sorted(got) == ["u1"]


@pytest.mark.parametrize("explicit_start", [False, True])
@pytest.mark.parametrize("kind", ["memory", "sqlite"])
def test_windowed_store_takes_only_the_until_bound(tmp_path, kind,
                                                   explicit_start):
    """A training window [start, until) clamps the until bound only:
    `$set` state builds up from t = 0, so the items set before the
    window start keep their properties, and the sets at or past the
    watermark are not seen.  A start the caller passes applies as given
    (the reference clamps it neither)."""
    ref, port, _ = _stores(kind, tmp_path)
    start = T0 + dt.timedelta(minutes=6)
    until = T0 + dt.timedelta(minutes=40)
    kw = {"start_time": T0 + dt.timedelta(minutes=2)} if explicit_start \
        else {}
    want = JaxWindowedEventStore(ref, start, until).aggregate_properties(
        APP, "item", **kw)
    got = WindowedEventStore(port, start, until).aggregate_properties(
        APP, "item", **kw)
    assert _plain(got) == _plain(want)
    assert "late" not in got and got["a"]["price"] == 4
    # the window start is never injected; an explicit start applies
    assert ("categories" in got["a"]) == (not explicit_start)
    # the other reads of the window still inject its start
    assert [e.entity_id for e in WindowedEventStore(port, start, until).find(
        APP, entity_type="item")] == [
        e.entity_id for e in JaxWindowedEventStore(ref, start, until).find(
            APP, entity_type="item")]
