"""Public names of the reference that the port's modules now carry too,
each held against the reference's: ``controller.model_to_bytes`` /
``model_from_bytes``, ``EventStore.insert_columnar``,
``native.native_available``, ``resilience.faults.active``,
``ServingScheduler.models``, ``ALSModel.tree_flatten``, the
``PEventStore`` / ``LEventStore`` aliases and ``server.http.
HandlerResult`` (``Retriever.vecs``:
``tests/test_torch_sharded_retrieval.py``)."""

import numpy as np
import pytest


def test_model_bytes_round_trip_as_the_reference():
    from predictionio_tpu.controller import model_from_bytes as ref_from
    from predictionio_tpu.controller import model_to_bytes as ref_to
    from predictionio_tpu_torch.controller import (
        model_from_bytes,
        model_to_bytes,
    )
    from predictionio_tpu_torch.models.als import als_model_from_numpy

    plain = {"weights": [1.5, -2.0], "name": "m", "n": 3}
    assert model_to_bytes(plain) == ref_to(plain)
    assert model_from_bytes(ref_to(plain)) == ref_from(model_to_bytes(plain))
    rng = np.random.default_rng(0)
    m = als_model_from_numpy(rng.normal(size=(4, 2)), rng.normal(size=(3, 2)),
                             rank=2, implicit=False)
    back = model_from_bytes(model_to_bytes(m))
    assert np.array_equal(back.user_factors, m.user_factors)
    assert np.array_equal(back.item_factors, m.item_factors)


def test_als_model_tree_flatten_as_the_reference():
    import jax.numpy as jnp

    from predictionio_tpu.models.als import ALSModel as RefModel
    from predictionio_tpu_torch.models.als import als_model_from_numpy

    rng = np.random.default_rng(1)
    uf = rng.normal(size=(5, 3)).astype(np.float32)
    itf = rng.normal(size=(4, 3)).astype(np.float32)
    got = als_model_from_numpy(uf, itf, rank=3, implicit=True).tree_flatten()
    want = RefModel(jnp.asarray(uf), jnp.asarray(itf), 3, True).tree_flatten()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def _columns(props: str, n=5):
    t0 = 1_767_225_600_000_000          # 2026-01-01T00:00:00Z in µs
    return {
        "event": ["rate"] * n,
        "entity_type": ["user"] * n,
        "entity_id": [f"u{k}" for k in range(n)],
        "target_entity_type": ["item"] * n,
        "target_entity_id": [f"i{k % 3}" for k in range(n)],
        props: [f'{{"rating": {k + 1}}}' for k in range(n)],
        "event_time_us": [t0 + k * 1_000_000 for k in range(n)],
    }


def _rows(events):
    return sorted((e.event, e.entity_id, e.target_entity_id,
                   dict(e.properties.to_dict()), e.event_time)
                  for e in events)


def test_event_store_insert_columnar_as_the_reference(pio_home,
                                                      monkeypatch):
    """The same columns through each package's store read back as the
    same events (the reference takes them as an Arrow table with a
    ``properties_json`` column; the port, which imports no pyarrow, as a
    mapping of sequences with a ``properties`` column)."""
    import pyarrow as pa

    from predictionio_tpu.data.storage import App as RefApp
    from predictionio_tpu.data.storage import get_storage as ref_storage
    from predictionio_tpu.data.store import EventStore as RefStore
    from predictionio_tpu_torch.data.storage import App, get_storage, \
        reset_storage
    from predictionio_tpu_torch.data.store import EventStore

    reset_storage()
    try:
        ref = ref_storage()
        rid = ref.get_apps().insert(RefApp(id=None, name="colapp"))
        ref.get_events().init(rid)
        assert RefStore(ref).insert_columnar(
            pa.table(_columns("properties_json")), "colapp") == 5
        port = get_storage()
        pid = port.get_apps().insert(App(id=None, name="colapp"))
        port.get_events().init(pid)
        assert EventStore(port).insert_columnar(_columns("properties"),
                                                "colapp") == 5
        assert _rows(EventStore(port).find("colapp")) \
            == _rows(RefStore(ref).find("colapp"))
    finally:
        reset_storage()


def test_native_available_as_the_reference():
    from predictionio_tpu.native import native_available as ref
    from predictionio_tpu_torch.native import native_available

    assert native_available("no_such_library") is ref("no_such_library") \
        is False
    assert native_available("serving_frontend") is True


def test_faults_active_as_the_reference(monkeypatch):
    from predictionio_tpu.resilience import faults as ref
    from predictionio_tpu_torch.resilience import faults

    monkeypatch.delenv("PIO_FAULTS", raising=False)
    faults.clear()
    ref.clear()
    try:
        assert faults.active() is ref.active() is False
        faults.install("storage.find:error:1.0")
        ref.install("storage.find:error:1.0")
        assert faults.active() is ref.active() is True
        faults.clear()
        ref.clear()
        monkeypatch.setenv("PIO_FAULTS", "storage.create:error:0.5")
        assert faults.active() is ref.active() is True
    finally:
        faults.clear()
        ref.clear()


@pytest.mark.parametrize("names", [[], ["b", "a"], ["als", "tt", "dlrm"]])
def test_scheduler_models_as_the_reference(names):
    from predictionio_tpu.serving import SchedulerConfig as RefConfig
    from predictionio_tpu.serving import ServingScheduler as RefScheduler
    from predictionio_tpu_torch.serving import (
        SchedulerConfig,
        ServingScheduler,
    )

    def dispatch(batch):
        return batch, len(batch)

    port = ServingScheduler(SchedulerConfig(enabled=False))
    ref = RefScheduler(RefConfig(enabled=False))
    try:
        for n in names:
            port.register(n, dispatch)
            ref.register(n, dispatch)
        assert port.models() == ref.models() == sorted(names)
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize("alias", ["PEventStore", "LEventStore"])
def test_event_store_aliases_as_the_reference(alias):
    import predictionio_tpu.data.store as ref
    import predictionio_tpu_torch.data.store as port

    assert getattr(ref, alias) is ref.EventStore
    assert getattr(port, alias) is port.EventStore
    assert alias in ref.__all__ and alias in port.__all__


def test_handler_result_as_the_reference():
    """The same Union of tuples once each of the reference's types is
    mapped to the port's by name (both are typing's, so they are the
    same objects)."""
    import typing

    from predictionio_tpu.server import http as ref
    from predictionio_tpu_torch.server import http as port

    def spelled(tp):
        args = typing.get_args(tp)
        if not args:
            return getattr(tp, "__name__", None) or repr(tp)
        return (repr(typing.get_origin(tp)),
                tuple(spelled(a) for a in args))

    assert typing.get_origin(port.HandlerResult) is typing.Union
    assert spelled(port.HandlerResult) == spelled(ref.HandlerResult)
    assert typing.get_args(port.HandlerResult) == \
        typing.get_args(ref.HandlerResult)
    assert "HandlerResult" in port.__all__
