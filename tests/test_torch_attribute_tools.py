"""The port's attribution tools against the reference's, on the CPU.

``predictionio_tpu_torch.tools.attribute_serve`` and
``attribute_quality`` read only what a server writes: the
``PIO_REQUEST_LOG`` wide events, ``/metrics``' ``pio_serve_stage_ms``
and ``/quality.json``.  On the same inputs their standard output (text
and ``--json``) and exit codes must equal the reference's
``tools/attribute_serve.py`` and ``tools/attribute_quality.py``,
character for character.  The inputs are a live port server's log,
exposition and quality document (``device="cpu"``, every query
quality-sampled) and documents written to reach every verdict branch.
"""

import copy
import importlib.util
import json
import os
import time
import urllib.request
from pathlib import Path

import pytest

from predictionio_tpu_torch.tools import attribute_quality, attribute_serve
from test_torch_rollout import _port_stack

ROOT = Path(__file__).resolve().parents[1]


def _reference_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = {"attribute_serve": _reference_tool("attribute_serve"),
       "attribute_quality": _reference_tool("attribute_quality")}
PORT = {"attribute_serve": attribute_serve,
        "attribute_quality": attribute_quality}


def _run(mod, argv, capsys):
    code = mod.main(argv)
    out = capsys.readouterr()
    return code, out.out, out.err


def same_output(name, path, capsys, extra=()):
    runs = [(_run(pkg[name], [str(path), *extra], capsys))
            for pkg in (REF, PORT)]
    assert runs[1] == runs[0]
    return runs[1]


# -- inputs written to reach each branch -------------------------------------

WALL = ("ingress", "queue_wait", "batch_wait", "bind", "cache", "dispatch",
        "resume", "serialize", "shed_check")
LOGS = {
    "retrieval_dominates_dispatch": [
        {"stages": {"dispatch": 100.0, "retrieval": 80.0, "bind": 1.0},
         "totalMs": 101.0}] * 4,
    "reconciles": [
        {"stages": {s: 10.0 + n for s in WALL}, "totalMs": 95.0 + n,
         "serverMs": 85.0 + n} for n in range(9)],
    "queue_bound": [
        {"stages": {"queue_wait": 40.0 + n, "dispatch": 3.0,
                    "retrieval": 0.5, "serialize": 1.0},
         "totalMs": 45.0 + n} for n in range(5)],
}
EXPOSITIONS = {
    "queue_wait": ('pio_serve_stage_ms_sum{stage="queue_wait"} 900\n'
                   'pio_serve_stage_ms_count{stage="queue_wait"} 10\n'
                   'pio_serve_stage_ms_sum{stage="dispatch"} 100\n'
                   'pio_serve_stage_ms_count{stage="dispatch"} 10\n'),
    "nothing": "pio_query_requests_total 3\n",
    "exemplars": ('pio_serve_stage_ms_bucket{stage="dispatch",le="1"} 2 '
                  '# {trace_id="t1"} 0.5\n'
                  'pio_serve_stage_ms_sum{stage="dispatch"} 12.5\n'
                  'pio_serve_stage_ms_count{stage="dispatch"} 5\n'
                  'pio_serve_stage_ms_sum{stage="retrieval"} 10\n'
                  'pio_serve_stage_ms_count{stage="retrieval"} 5\n'),
}

HEALTHY = {
    "enabled": True, "generation": 3, "verdict": "healthy",
    "gate": {"rollback": False, "reasons": []},
    "drift": {"psi": {"fast": 0.012, "slow": 0.02}, "threshold": 0.25,
              "nFast": 64, "nSlow": 256, "tripped": False},
    "shadow": {"active": True, "overlapMean": 0.91, "overlapP10": 0.7,
               "scored": 80, "divergent": False, "minOverlap": 0.5},
    "feedback": {"generations": {"2": {"hitRate": 0.3, "hits": 3,
                                       "misses": 7},
                                 "10": {"hitRate": 0.25, "hits": 5,
                                        "misses": 15}}},
    "diversity": {"topItemShare": 0.1},
    "recall": {"enabled": True, "k": 10, "sample": 0.05, "tolerance": 0.05,
               "rungs": {"ivf": {"recallFast": 0.93, "baseline": 0.95,
                                 "cellMiss": 0.0, "shortlistSaturation": 0.0,
                                 "tripped": False}}},
}


def _variant(**changes):
    doc = copy.deepcopy(HEALTHY)
    for path, value in changes.items():
        node = doc
        keys = path.split("__")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
    return doc


QUALITY = {
    "healthy": HEALTHY,
    "disabled": {"enabled": False},
    "divergent": _variant(shadow__divergent=True,
                          gate__rollback=True, verdict="divergent"),
    "recall_cell_miss": _variant(
        recall__tripped=True, recall__rungs__ivf__tripped=True,
        recall__rungs__ivf__cellMiss=0.4, recall__rungs__ivf__recallFast=0.6),
    "recall_shortlist": _variant(
        recall__tripped=True, recall__rungs__ivf__tripped=True,
        recall__rungs__ivf__shortlistSaturation=0.3),
    "recall_neither": _variant(recall__tripped=True,
                               recall__rungs__ivf__tripped=True),
    "recall_reporting_only": _variant(recall__tripped=True,
                                      recall__reportingOnly=True),
    "drift": _variant(drift__tripped=True, gate__rollback=True,
                      gate__reasons=["drift"], verdict="drift"),
    "reporting_only": _variant(drift__reportingOnly=True,
                               drift__reason="fingerprint_mismatch"),
    "hit_rate_collapse": _variant(feedback__generations={
        "9": {"hitRate": 0.4, "hits": 4, "misses": 6},
        "10": {"hitRate": 0.1, "hits": 1, "misses": 9}}),
    "diversity_collapse": _variant(diversity__topItemShare=0.8),
    "insufficient": _variant(verdict="insufficient", shadow={},
                             feedback={}, recall={}),
    "dashboard_wrapped": {"merged": _variant(verdict="healthy"),
                          "instances": []},
}


@pytest.mark.parametrize("name", sorted(LOGS))
@pytest.mark.parametrize("fmt", ["text", "json"])
def test_attribute_serve_on_wide_event_logs(tmp_path, capsys, name, fmt):
    path = tmp_path / "requests.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in LOGS[name])
                    + "\nnot json\n{}\n")
    code, out, _ = same_output("attribute_serve", path, capsys,
                               ("--json",) if fmt == "json" else ())
    assert code == 0 and out


@pytest.mark.parametrize("name", sorted(EXPOSITIONS))
@pytest.mark.parametrize("fmt", ["text", "json"])
def test_attribute_serve_on_expositions(tmp_path, capsys, name, fmt):
    path = tmp_path / "metrics.txt"
    path.write_text(EXPOSITIONS[name])
    code, _, err = same_output("attribute_serve", path, capsys,
                               ("--json",) if fmt == "json" else ())
    assert code == (1 if name == "nothing" else 0)


@pytest.mark.parametrize("name", sorted(QUALITY))
def test_attribute_quality_on_documents(tmp_path, capsys, name):
    path = tmp_path / "quality.json"
    path.write_text(json.dumps(QUALITY[name]))
    code, out, _ = same_output("attribute_quality", path, capsys)
    assert code == 0 and out


def test_attribute_quality_on_a_missing_file(tmp_path, capsys):
    code, _, err = same_output("attribute_quality", tmp_path / "none.json",
                               capsys)
    assert code == 1 and "cannot load" in err


def _logged_queries(base, log, n, monkeypatch):
    """``n`` queries with ``PIO_REQUEST_LOG`` set, then wait for their
    ``n`` wide events before unsetting it.  A request's wide event is
    written after its answer went out, and the log path is read at the
    write: unset any earlier, and a late write lands nowhere."""
    monkeypatch.setenv("PIO_REQUEST_LOG", str(log))
    for i in range(n):
        req = urllib.request.Request(
            base + "/queries.json", method="POST",
            data=json.dumps({"user": f"u{i}", "num": 3}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.status == 200
    deadline = time.monotonic() + 30
    while not log.exists() or len(log.read_text().splitlines()) < n:
        assert time.monotonic() < deadline
        time.sleep(0.05)
    monkeypatch.delenv("PIO_REQUEST_LOG")


def _live_port_server(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_HOME", str(tmp_path / "home"))
    for k in list(os.environ):
        if k.startswith(("PIO_STORAGE_", "PIO_QUALITY", "PIO_REQUEST_LOG",
                         "PIO_RESULT_CACHE", "PIO_RECALL")):
            monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("PIO_QUALITY_SAMPLE", "1")
    monkeypatch.setenv("PIO_RESULT_CACHE", "0")
    pkg = _port_stack(tmp_path / "port")
    pkg.wf.run_train(pkg.eng, pkg.variant, pkg.ctx)
    srv = pkg.server()
    srv.start()
    return srv


def test_every_wide_event_lands_when_the_log_write_is_late(
        tmp_path, monkeypatch):
    """The wide events of a loaded host, written a while after each
    answer: all of them land in the log the test reads."""
    from predictionio_tpu.data.storage import reset_storage
    from predictionio_tpu_torch.obs import waterfall

    real = waterfall._request_log_write

    def late(doc, sample_u=None):
        time.sleep(0.3)
        real(doc, sample_u)

    monkeypatch.setattr(waterfall, "_request_log_write", late)
    srv = _live_port_server(tmp_path, monkeypatch)
    log = tmp_path / "requests.jsonl"
    try:
        _logged_queries(f"http://127.0.0.1:{srv.port}", log, 3, monkeypatch)
        assert len(log.read_text().splitlines()) == 3
    finally:
        srv.stop()
        reset_storage()


def test_attribute_tools_on_a_live_port_server(tmp_path, monkeypatch,
                                               capsys):
    """A port EngineServer on the CPU writes the wide events, the
    exposition (plain and with exemplars) and /quality.json that both
    packages' tools then read, over HTTP and from files."""
    from predictionio_tpu.data.storage import reset_storage

    log = tmp_path / "requests.jsonl"
    srv = _live_port_server(tmp_path, monkeypatch)
    base = f"http://127.0.0.1:{srv.port}"
    try:
        _logged_queries(base, log, 12, monkeypatch)
        files = {}
        for name, path in (("metrics.txt", "/metrics"),
                           ("exemplars.txt", "/metrics?exemplars=1"),
                           ("quality.json", "/quality.json")):
            with urllib.request.urlopen(base + path, timeout=30) as r:
                files[name] = tmp_path / name
                files[name].write_bytes(r.read())
        for path in (log, files["metrics.txt"], files["exemplars.txt"]):
            for extra in ((), ("--json",)):
                code, out, _ = same_output("attribute_serve", path, capsys,
                                           extra)
                assert code == 0 and "dispatch" in out
        code, out, _ = same_output("attribute_quality",
                                   files["quality.json"], capsys)
        assert code == 0 and out.startswith("generation 1")
        code, out, _ = same_output("attribute_quality", base, capsys)
        assert code == 0
    finally:
        srv.stop()
        reset_storage()
