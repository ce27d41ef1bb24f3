"""The port's webhook connectors against the reference's.

Each provider payload goes through ``get_connector(name).to_events_json``
of both packages: the event JSON must be equal, and a payload one
rejects the other rejects with the same message.  A registered
connector then serves ``POST /webhooks/<name>.json`` on both event
servers, a burst with a malformed message in it answered item by item.
"""

import json
import urllib.parse

import pytest

import predictionio_tpu.data.webhooks as ref_hooks
import predictionio_tpu_torch.data.webhooks as port_hooks

SEGMENT = [
    {"type": "track", "userId": "u1", "event": "signup",
     "properties": {"plan": "pro", "seats": 3},
     "timestamp": "2026-03-03T13:00:00Z"},
    {"type": "track", "anonymousId": "a9", "event": "click"},
    {"type": "identify", "userId": "u2", "traits": {"age": 30, "vip": True}},
    {"type": "identify", "userId": "u2"},
    {"type": "page", "userId": "u3", "name": "home",
     "properties": {"url": "/"}},
    {"type": "screen", "anonymousId": "a1"},
    {"type": "alias", "userId": "u4", "previousId": "a1"},
    {"type": "group", "userId": "u5", "groupId": "g1",
     "traits": {"size": 10}},
    {"batch": [{"type": "track", "userId": "u6", "event": "e1"},
               {"type": "track", "userId": "u7"},
               {"type": "identify", "anonymousId": "a2",
                "traits": {"x": 1}},
               {"userId": "u8"}]},
    {"batch": []},
    # rejected whole
    {"userId": "u1"},
    {"type": "track", "event": "e"},
    {"type": "track", "userId": "u1"},
    {"type": "teleport", "userId": "u1"},
]

MAILCHIMP = [
    {"type": "subscribe", "fired_at": "2026-03-03 12:00:00",
     "data[email]": "a@b.example", "data[merges][FNAME]": "Ann",
     "data[list_id]": "L1"},
    {"type": "unsubscribe", "data[email]": "c@d.example",
     "fired_at": "2026-03-03T12:00:00+00:00"},
    {"type": "profile", "data[id]": "x1"},
    {"type": "upemail", "data[new_email]": "n@e.example",
     "data[old_email]": "o@e.example"},
    {"type": "cleaned", "data[email]": "z@e.example", "data[reason]": "hard"},
    {"type": "campaign", "data[id]": "c7", "data[subject]": "Hi"},
    # rejected
    {"type": "nope", "data[email]": "a@b.example"},
    {"type": "subscribe"},
    {},
]


def _outcome(hooks, name, payload):
    try:
        out = hooks.get_connector(name).to_events_json(payload)
    except hooks.ConnectorError as e:
        return "rejected", str(e)
    return "mapped", [("error", str(x)) if isinstance(x, Exception) else x
                      for x in out]


@pytest.mark.parametrize("name,payload",
                         [("segmentio", p) for p in SEGMENT]
                         + [("mailchimp", p) for p in MAILCHIMP])
def test_connectors_map_as_the_reference(name, payload):
    assert _outcome(port_hooks, name, payload) == \
        _outcome(ref_hooks, name, payload)


def test_unknown_connector_names_the_registered_ones():
    for hooks in (ref_hooks, port_hooks):
        with pytest.raises(hooks.ConnectorError) as e:
            hooks.get_connector("nosuch")
        assert "registered: ['mailchimp', 'segmentio']" in str(e.value)


def shop_connector(hooks):
    """A JSON connector of the shape a user registers, on ``hooks``'s
    traits and errors: one order → one ``buy`` per line item."""

    class Shop(hooks.JsonConnector):
        def to_event_json(self, payload):
            return self.to_events_json(payload)[0]

        def to_events_json(self, payload):
            if "order" not in payload:
                raise hooks.ConnectorError("shop payload missing 'order'.")
            out = []
            for line in payload["order"]["lines"]:
                if "sku" not in line:
                    out.append(hooks.ConnectorError("line without sku"))
                    continue
                out.append({"event": "buy", "entityType": "user",
                            "entityId": payload["order"]["customer"],
                            "targetEntityType": "item",
                            "targetEntityId": line["sku"],
                            "properties": {"qty": line.get("qty", 1)},
                            "eventTime": payload["order"]["at"]})
            return out

    return Shop()


def test_registered_connector_over_both_event_servers(tmp_path,
                                                      monkeypatch):
    import http.client

    import predictionio_tpu.config as ref_config
    import predictionio_tpu.data.storage as ref_storage
    import predictionio_tpu.server.event_server as ref_es
    import predictionio_tpu_torch.config as port_config
    import predictionio_tpu_torch.data.storage as port_storage
    import predictionio_tpu_torch.server.event_server as port_es

    from test_torch_segments import own_segment_root

    monkeypatch.delenv("PIO_SEGMENTS", raising=False)
    monkeypatch.setenv("PIO_HOME", str(tmp_path / "env_home"))
    order = {"order": {"customer": "c1", "at": "2026-03-05T10:00:00Z",
                       "lines": [{"sku": "s1", "qty": 2}, {"qty": 1},
                                 {"sku": "s2"}]}}
    answers = []
    for name, hooks, config, storage_mod, es in (
            ("ref", ref_hooks, ref_config, ref_storage, ref_es),
            ("port", port_hooks, port_config, port_storage, port_es)):
        hooks.register_connector("shop", shop_connector(hooks))
        storage = storage_mod.Storage(config.load_config(
            env={"PIO_HOME": str(tmp_path / name)}))
        app_id = storage.get_apps().insert(storage_mod.App(id=None,
                                                           name="hook"))
        storage.get_events().init(app_id)
        storage.get_access_keys().insert(storage_mod.AccessKey(
            key="K", app_id=app_id))
        with own_segment_root(tmp_path / name / "segments"):
            srv = es.EventServer(storage=storage, host="127.0.0.1", port=0)
        srv.start()
        got = []
        try:
            for body in (order, {"nothing": 1}):
                conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                                  timeout=30)
                conn.request("POST", "/webhooks/shop.json?accessKey=K",
                             json.dumps(body),
                             {"Content-Type": "application/json"})
                r = conn.getresponse()
                got.append((r.status, json.loads(r.read())))
                conn.close()
            conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                              timeout=30)
            conn.request("POST", "/webhooks/shop?accessKey=K",
                         urllib.parse.urlencode({"a": "b"}),
                         {"Content-Type":
                          "application/x-www-form-urlencoded"})
            r = conn.getresponse()
            got.append((r.status, r.read() and None))
            conn.close()
            stored = [(e.event, e.entity_id, e.target_entity_id,
                       dict(e.properties)) for e in
                      storage.get_events().find(app_id)]
        finally:
            srv.stop()
            storage.close()
            hooks.connectors._REGISTRY.pop("shop", None)
        for item in got[0][1]:
            item.pop("eventId", None)
        answers.append((got, stored))
    assert answers[1] == answers[0]
    (got, stored) = answers[1]
    assert [i["status"] for i in got[0][1]] == [201, 400, 201]
    assert got[1][0] == 400 and stored == [
        ("buy", "c1", "s1", {"qty": 2}), ("buy", "c1", "s2", {"qty": 1})]
