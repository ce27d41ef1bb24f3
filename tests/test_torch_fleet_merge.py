"""The port's fleet telemetry merge against the reference's, on the CPU.

``parse_exposition``, ``merge_samples``, ``merge_histogram_buckets``,
``histogram_quantile``, ``CounterResetTracker``,
``fleet_instances_from_env`` and ``FleetAggregator.payload`` must give
equal outputs on the same inputs (exactly: the merge is float addition
in one order in both).  The inputs include each package's own rendered
``/metrics``, with and without exemplar suffixes, and the cases of the
reference's ``tests/test_slo_fleet.py::TestFleetMerge`` and
``TestFleetEndToEnd``, which also run against live port servers with a
port dashboard.  Bucket-merge associativity is a hypothesis property.
"""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import predictionio_tpu.obs.fleet as ref_fleet
import predictionio_tpu.obs.metrics as ref_metrics
import predictionio_tpu_torch.obs.fleet as port_fleet
import predictionio_tpu_torch.obs.metrics as port_metrics
from test_torch_rollout import _port_stack, _ref_stack

PACKAGES = {"reference": ref_fleet, "port": port_fleet}


def _expo(counter=0.0, gen=1.0, buckets=(1, 2, 3)):
    b1, b2, b3 = buckets
    return (
        "# TYPE pio_query_requests_total counter\n"
        f"pio_query_requests_total {counter}\n"
        "# TYPE pio_model_generation gauge\n"
        f"pio_model_generation {gen}\n"
        "# TYPE pio_query_latency_ms histogram\n"
        f'pio_query_latency_ms_bucket{{le="10"}} {b1}\n'
        f'pio_query_latency_ms_bucket{{le="100"}} {b2}\n'
        f'pio_query_latency_ms_bucket{{le="+Inf"}} {b3}\n'
        f"pio_query_latency_ms_sum {b3 * 5.0}\n"
        f"pio_query_latency_ms_count {b3}\n")


JUNK = ('# TYPE pio_a_ms histogram\n'
        'pio_a_ms_bucket{le="5"} 2 # {trace_id="abc"} 3.0\n'
        'garbage !!! line\n'
        '{not even a name} 4\n'
        'pio_a_ms_count 2\n'
        'pio_b_total{x="a\\"b\\\\n",y="\\n"} 7\n'
        'pio_c NaN\n'
        'pio_d +Inf\n'
        'pio_e notanumber\n'
        '# HELP pio_a_ms something\n'
        '# TYPE\n')


def _rendered(metrics_mod, seed):
    """One registry of ``metrics_mod`` (either package's) filled with the
    same seeded series: counters, labelled gauges, histograms with
    exemplars; returns (plain, with exemplars) renderings."""
    rng = np.random.default_rng(seed)
    reg = metrics_mod.MetricsRegistry()
    c = reg.counter("pio_query_requests_total", "Predict requests.")
    c.inc(float(rng.integers(1, 100)))
    ev = reg.counter("pio_event_requests_total", "Events.", ("status",))
    for s in ("201", "400", "a\"b\\c"):
        ev.inc(float(rng.integers(1, 9)), status=s)
    g = reg.gauge("pio_model_generation", "Generation.")
    g.set(float(rng.integers(1, 5)))
    b = reg.gauge("pio_breaker_state", "Breaker.", ("breaker",))
    b.set(2.0, breaker="modeldata")
    h = reg.histogram("pio_serve_stage_ms", "Stages.", ("stage",))
    for n, v in enumerate(rng.exponential(5.0, 40)):
        h.observe(float(v), exemplar=f"req-{seed}-{n}",
                  stage=("dispatch", "queue_wait")[n % 2])
    lat = reg.histogram("pio_query_latency_ms", "Latency.")
    for v in rng.exponential(3.0, 12):
        lat.observe(float(v))
    return reg.render(), reg.render(exemplars=True)


def _texts():
    out = {"junk": JUNK, "empty": "", "expo": _expo(10, 3, (1, 2, 4)),
           "expo_b": _expo(32, 7, (0, 6, 8))}
    for name, mod in (("reference", ref_metrics), ("port", port_metrics)):
        for seed in (0, 1):
            plain, ex = _rendered(mod, seed)
            out[f"{name}{seed}"] = plain
            out[f"{name}{seed}_exemplars"] = ex
    return out


TEXTS = _texts()


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_parse_exposition_equals_the_reference(name):
    text = TEXTS[name]
    # json: NaN samples compare equal to themselves
    assert json.dumps(port_fleet.parse_exposition(text)) == \
        json.dumps(ref_fleet.parse_exposition(text))


def test_rendered_metrics_agree_and_exemplars_change_nothing():
    """Both packages render the same series the same way, and the
    exemplar suffix parses away: the samples with and without it are
    the same."""
    for seed in (0, 1):
        assert TEXTS[f"port{seed}"] == TEXTS[f"reference{seed}"]
        assert TEXTS[f"port{seed}_exemplars"] == \
            TEXTS[f"reference{seed}_exemplars"]
        assert "# {trace_id=" in TEXTS[f"port{seed}_exemplars"]
        assert port_fleet.parse_exposition(TEXTS[f"port{seed}"]) == \
            port_fleet.parse_exposition(TEXTS[f"port{seed}_exemplars"])


MERGES = (("expo", "expo_b"), ("reference0", "port1"),
          ("port0_exemplars", "port1", "reference1_exemplars"),
          ("junk", "expo"), ("port0",), ())


@pytest.mark.parametrize("names", MERGES, ids=lambda n: "+".join(n) or "none")
def test_merge_samples_and_quantiles_equal_the_reference(names):
    per = {f"http://i{n}": TEXTS[t] for n, t in enumerate(names)}
    outs = {}
    for label, mod in PACKAGES.items():
        tracker = mod.CounterResetTracker()
        parsed = {u: mod.parse_exposition(t) for u, t in per.items()}
        merged = mod.merge_samples(parsed, tracker)
        again = mod.merge_samples(parsed, tracker)   # no phantom resets
        untracked = mod.merge_samples(parsed)
        quantiles = {
            (fam, key, q): mod.histogram_quantile(s["buckets"], q)
            for fam, series in merged["histograms"].items()
            for key, s in series.items()
            for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0)}
        outs[label] = (merged, again, untracked, quantiles)
    assert outs["port"] == outs["reference"]


@pytest.mark.parametrize("buckets", [
    {}, {"+Inf": 0.0}, {"10": 1.0, "100": 8.0, "+Inf": 12.0},
    {"+Inf": 5.0}, {"0.5": 2.0, "1": 2.0, "+Inf": 2.0},
    {"1": 0.0, "2": 3.0, "4": 3.0, "+Inf": 7.0}, {"5": 4.0}])
def test_histogram_quantile_equals_the_reference(buckets):
    for q in np.linspace(0.0, 1.0, 21):
        assert port_fleet.histogram_quantile(buckets, float(q)) == \
            ref_fleet.histogram_quantile(buckets, float(q))


def test_counter_reset_tracker_equals_the_reference():
    rng = np.random.default_rng(5)
    trackers = [m.CounterResetTracker() for m in PACKAGES.values()]
    for _ in range(300):
        inst = f"i{int(rng.integers(3))}"
        key = f"k{int(rng.integers(2))}"
        raw = float(rng.integers(0, 50))
        a, b = (t.update(inst, key, raw) for t in trackers)
        assert a == b


@pytest.mark.parametrize("env", [
    {}, {"PIO_FLEET_INSTANCES": ""},
    {"PIO_FLEET_INSTANCES": "http://a:1/, http://b:2 ,,"},
    {"PIO_FLEET_INSTANCES": "http://a:1"}])
def test_fleet_instances_from_env_equals_the_reference(env):
    assert port_fleet.fleet_instances_from_env(env) == \
        ref_fleet.fleet_instances_from_env(env)


# -- the reference's TestFleetMerge cases, on both packages -------------------

@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_counters_sum_and_gauges_keep_instance_label(pkg):
    mod = PACKAGES[pkg]
    merged = mod.merge_samples({
        "http://a": mod.parse_exposition(_expo(counter=10, gen=3)),
        "http://b": mod.parse_exposition(_expo(counter=32, gen=7)),
    })
    assert merged["counters"]["pio_query_requests_total"] == 42.0
    assert merged["gauges"][
        'pio_model_generation{instance="http://a"}'] == 3.0
    assert merged["gauges"][
        'pio_model_generation{instance="http://b"}'] == 7.0
    assert "pio_model_generation" not in merged["counters"]


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_histogram_buckets_add_and_quantile_reads_merged(pkg):
    mod = PACKAGES[pkg]
    merged = mod.merge_samples({
        "a": mod.parse_exposition(_expo(buckets=(1, 2, 4))),
        "b": mod.parse_exposition(_expo(buckets=(0, 6, 8))),
    })
    row = merged["histograms"]["pio_query_latency_ms"][
        "pio_query_latency_ms"]
    assert row["buckets"] == {"10": 1.0, "100": 8.0, "+Inf": 12.0}
    assert row["count"] == 12.0
    assert 10.0 < mod.histogram_quantile(row["buckets"], 0.5) <= 100.0


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_counter_sums_survive_an_instance_restart(pkg):
    mod = PACKAGES[pkg]
    tracker = mod.CounterResetTracker()
    sums = []
    for a, b in ((100, 50), (110, 7), (110, 9)):
        m = mod.merge_samples({"a": mod.parse_exposition(_expo(counter=a)),
                               "b": mod.parse_exposition(_expo(counter=b))},
                              tracker)
        sums.append(m["counters"]["pio_query_requests_total"])
    assert sums == [150.0, 167.0, 169.0]


class _Tick:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


QUALITY = {"enabled": True, "generation": 2, "verdict": "healthy",
           "gate": {"rollback": False, "reasons": []},
           "drift": {"psi": {"fast": 0.01, "slow": 0.02}, "nFast": 64,
                     "tripped": False},
           "recall": {"enabled": True, "k": 10, "rungs": {
               "ivf": {"recallFast": 0.93, "baseline": 0.95, "n": 40}}}}


def _fake_fleet(alive, quality_for):
    def fetch(url):
        if url.startswith("http://dead") or (
                url.startswith("http://b") and not alive["v"]):
            raise OSError("connection refused")
        n = 50 if url.startswith("http://b") else 100
        if url.endswith("/metrics"):
            return _expo(counter=n, gen=n / 50)
        if url.endswith("/stats.json"):
            return json.dumps({"slo": {"degraded": False, "burn": {
                "fast": {"availability": 0.5, "latency": n / 100}}},
                "batcher": {"default": {"dispatches": n}}})
        if url.endswith("/quality.json") and url.startswith(quality_for):
            doc = json.loads(json.dumps(QUALITY))
            doc["recall"]["rungs"]["ivf"]["recallFast"] = n / 107
            return json.dumps(doc)
        raise OSError("optional")
    return fetch


@pytest.mark.parametrize("quality_for", ["http://a", "http://"])
def test_aggregator_payload_equals_the_reference(quality_for):
    """Rows, merged counters, gauges, quantiles and the quality merge of
    one scripted scrape sequence: a live instance, one that dies, one
    that never answered."""
    docs = {}
    for label, mod in PACKAGES.items():
        alive = {"v": True}
        agg = mod.FleetAggregator(
            ["http://a", "http://b", "http://dead:2"],
            fetch=_fake_fleet(alive, quality_for), clock=_Tick(100.0))
        first = agg.scrape()
        alive["v"] = False
        second = agg.scrape()
        agg.close()
        for d in (first, second):
            d.pop("scrapedAt")
        docs[label] = (first, second)
    assert docs["port"] == docs["reference"]
    first, second = docs["port"]
    rows = {r["instance"]: r for r in second["instances"]}
    assert rows["http://b"]["stale"] is True
    assert rows["http://dead:2"]["stale"] is True
    assert "error" in rows["http://dead:2"]
    # no dip: b's last-known counters still count
    assert second["merged"]["counters"]["pio_query_requests_total"] == \
        first["merged"]["counters"]["pio_query_requests_total"] == 150.0


@given(st.lists(st.dictionaries(st.sampled_from(["1", "10", "100", "+Inf"]),
                                st.integers(0, 10 ** 6).map(float),
                                min_size=1), min_size=3, max_size=3))
@settings(max_examples=60, deadline=None)
def test_bucket_merge_is_associative_and_sum_preserving(parts):
    a, b, c = parts
    merge = port_fleet.merge_histogram_buckets
    left = merge([merge([a, b]), c])
    right = merge([a, merge([b, c])])
    flat = merge(parts)
    assert left == right == flat == ref_fleet.merge_histogram_buckets(parts)
    for le in flat:
        assert flat[le] == sum(p.get(le, 0.0) for p in parts)


# -- the reference's TestFleetEndToEnd, on live servers of each package -------

def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _post_query(port, user):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json",
        data=json.dumps({"user": user, "num": 2}).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as resp:
        return resp.status


@pytest.fixture()
def stacks(tmp_path, monkeypatch):
    from predictionio_tpu.data.storage import reset_storage

    monkeypatch.setenv("PIO_HOME", str(tmp_path / "home"))
    for k in list(os.environ):
        if k.startswith(("PIO_STORAGE_", "PIO_FLEET", "PIO_RESULT_CACHE")):
            monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_METADATA_SOURCE", "MEMORY")
    monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE", "MEMORY")
    yield {"reference": _ref_stack, "port": lambda: _port_stack(
        tmp_path / "port")}
    reset_storage()


def _fleet_json_run(pkg, dashboard_cls):
    """Two live engine servers of one package, their dashboard: the
    merged counters equal the per-instance sums, a stopped instance
    reads stale and still counts.  Returns the parts to compare."""
    pkg.wf.run_train(pkg.eng, pkg.variant, pkg.ctx)
    srv1, srv2 = pkg.server(), pkg.server()
    srv1.start()
    srv2.start()
    urls = [f"http://127.0.0.1:{s.port}" for s in (srv1, srv2)]
    dash = dashboard_cls(storage=pkg.ctx.storage, host="127.0.0.1", port=0,
                         fleet=urls)
    dash.start(block=False)
    try:
        for srv, n in ((srv1, 3), (srv2, 2)):
            for i in range(n):
                assert _post_query(srv.port, f"u{i}") == 200
        mod = PACKAGES[pkg.name]
        per_instance = []
        for u in urls:
            _, body = _get(u + "/metrics")
            _, samples = mod.parse_exposition(body.decode())
            per_instance.append(sum(v for name, _, v in samples
                                    if name == "pio_query_requests_total"))
        s, body = _get(f"http://127.0.0.1:{dash.port}/fleet.json")
        assert s == 200
        doc = json.loads(body)
        assert [r["stale"] for r in doc["instances"]] == [False, False]
        assert all("degraded" in r["slo"] for r in doc["instances"])
        assert doc["merged"]["counters"]["pio_query_requests_total"] == \
            sum(per_instance)
        gens = sorted(k for k in doc["merged"]["gauges"]
                      if k.startswith("pio_model_generation{"))
        assert len(gens) == 2
        q = doc["merged"]["histogramQuantiles"]["pio_query_latency_ms"][
            "pio_query_latency_ms"]
        assert q["count"] == sum(per_instance) and q["p99"] > 0
        srv2.stop()
        s, body = _get(f"http://127.0.0.1:{dash.port}/fleet.json")
        after = json.loads(body)
        rows = {r["instance"]: r for r in after["instances"]}
        assert rows[urls[1]]["stale"] is True
        assert after["merged"]["counters"]["pio_query_requests_total"] == \
            sum(per_instance)
        labels = {u: f"<U{n}>" for n, u in enumerate(urls)}
        return {
            "per_instance": per_instance,
            "row_keys": [sorted(r) for r in doc["instances"]],
            "gauges": sorted(g.replace(urls[0], "<U0>").replace(
                urls[1], "<U1>") for g in gens),
            "quantile_count": q["count"],
            "stale_after": [rows[u]["stale"] for u in urls],
            "labels": sorted(labels.values())}
    finally:
        srv1.stop()
        try:
            srv2.stop()
        except Exception:
            pass
        dash.stop()


def test_fleet_json_aggregates_two_live_instances(stacks):
    from predictionio_tpu.server.dashboard import DashboardServer as RefDash
    from predictionio_tpu_torch.server.dashboard import DashboardServer

    ref = _fleet_json_run(stacks["reference"](), RefDash)
    port = _fleet_json_run(stacks["port"](), DashboardServer)
    assert port == ref
