"""The port's retrieval-recall monitor against the reference's, on the CPU.

``predictionio_tpu_torch.obs.recall`` is held against
``predictionio_tpu.obs.recall`` on the same numpy inputs:

- ``build_recall_scorecard`` over the same factors and the same IVF
  index and PQ codebook (built by the reference, carried into the port
  as ``dataclasses.asdict``): the same per-rung recall@k, nprobe, rerank
  and corpus fingerprint;
- ``RecallDetector``: one script of per-rung recalls under one fake clock
  gives the same verdict series;
- ``RecallMonitor``: each package's own retriever answers the same
  queries on ``ivf``, ``ivf_pq`` and ``pq_flat``; the sampled captures,
  re-ranked exactly off the serving path (drained synchronously here),
  give the same ``recall`` block (live recall per rung and window, miss
  attribution, scanned fraction) and the same folded gate, including a
  regression against a planted baseline;
- the server seam: a generation carried into the port keeps its recall
  scorecard, and ``/quality.json``'s ``recall`` block reads the live
  ``pq_flat`` recall of the served answers.
"""

import dataclasses
import os
from types import SimpleNamespace

import time

import numpy as np
import pytest

import predictionio_tpu.obs as ref_obs
import predictionio_tpu.obs.recall as ref_r
import predictionio_tpu.obs.waterfall as ref_wf
import predictionio_tpu.retrieval as ref_ret
import predictionio_tpu_torch.obs as port_obs
import predictionio_tpu_torch.obs.recall as port_r
import predictionio_tpu_torch.obs.waterfall as port_wf
import predictionio_tpu_torch.retrieval as port_ret

TOL = 1e-12
REF = SimpleNamespace(name="ref", r=ref_r, obs=ref_obs, wf=ref_wf,
                      ret=ref_ret)
PORT = SimpleNamespace(name="port", r=port_r, obs=port_obs, wf=port_wf,
                       ret=port_ret)
PKGS = (REF, PORT)


@pytest.fixture(autouse=True)
def _fresh_observability(monkeypatch):
    for k in ("PIO_RETRIEVAL_RUNG", "PIO_PQ_RERANK", "PIO_IVF_NPROBE",
              "PIO_SERVE_HOST_MACS"):
        monkeypatch.delenv(k, raising=False)
    for p in PKGS:
        p.obs.reset_observability()
    yield
    for p in PKGS:
        p.obs.reset_observability()


def _corpus(n=2000, d=16, seed=0):
    rng = np.random.default_rng(seed)
    it = rng.standard_normal((n, d)).astype(np.float32)
    qv = rng.standard_normal((200, d)).astype(np.float32)
    return it, qv


_STRUCTS = {}


def _structures(n=2000, nlist=32, m=4):
    """The reference's IVF index and PQ codebook (built once)."""
    key = (n, nlist, m)
    if key not in _STRUCTS:
        it, qv = _corpus(n)
        ivf = ref_ret.build_ivf(it, nlist=nlist, seed=0, force=True)
        pq = ref_ret.build_pq(it, m=m, ivf=ivf, seed=0)
        _STRUCTS[key] = (it, qv, ivf, pq)
    return _STRUCTS[key]


def _carry(pkg, ivf, pq):
    if pkg is REF:
        return ivf, pq
    return (port_ret.IVFIndex(**dataclasses.asdict(ivf)) if ivf else None,
            port_ret.PQCodebook(**dataclasses.asdict(pq)) if pq else None)


def _fields(sc):
    d = dataclasses.asdict(sc)
    d.pop("built_at")
    return d


@pytest.mark.parametrize("which", ["ivf", "pq", "both", "none"])
@pytest.mark.parametrize("rerank", [None, "25"], ids=["rerank4k", "rerank25"])
def test_build_recall_scorecard_equals_the_reference(monkeypatch, which,
                                                     rerank):
    if rerank:
        monkeypatch.setenv("PIO_PQ_RERANK", rerank)
    it, qv, ivf, pq = _structures()
    ivf = ivf if which in ("ivf", "both") else None
    pq = pq if which in ("pq", "both") else None
    out = []
    for pkg in PKGS:
        i, p = _carry(pkg, ivf, pq)
        sc = pkg.r.build_recall_scorecard(qv, it, ivf=i, pq=p, sample=64,
                                          seed=3, name="t")
        out.append(None if sc is None else _fields(sc))
    if which == "none":
        assert out == [None, None]
        return
    want, got = out
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "recall":
            assert sorted(got[k]) == sorted(want[k])
            for rung in want[k]:
                assert got[k][rung] == pytest.approx(want[k][rung], abs=TOL)
        else:
            assert got[k] == want[k]
    rungs = {"ivf": {"ivf"}, "pq": {"pq_flat"},
             "both": {"ivf", "pq_flat", "ivf_pq"}}[which]
    assert set(want["recall"]) == rungs


def _detector_series(pkg):
    t = [0.0]
    cfg = pkg.r.RecallConfig(min_samples=10, fast_window=32, reservoir=64,
                             tolerance=0.05, recovery_s=30.0)
    sc = pkg.r.RecallScorecard(recall={"ivf": {1: 0.95, 10: 0.9},
                                       "pq_flat": {10: 0.8}},
                               n_queries=64, fingerprint="fp")
    det = pkg.r.RecallDetector(cfg, sc, clock=lambda: t[0])
    rng = np.random.default_rng(4)
    out = []
    for phase, (mean_ivf, mean_pq, n) in enumerate(
            ((0.9, 0.8, 40), (0.6, 0.8, 80), (0.9, 0.5, 5),
             (0.92, 0.81, 100), (0.92, 0.81, 100))):
        for _ in range(n):
            det.add("ivf", float(np.clip(rng.normal(mean_ivf, 0.05), 0, 1)))
            det.add("pq_flat", float(np.clip(rng.normal(mean_pq, 0.05),
                                             0, 1)))
        t[0] += 20.0
        out.append(det.tick(force=True))
        out.append(det.tick())
    return out


def test_recall_detector_series_equals_the_reference():
    want = _detector_series(REF)
    assert _detector_series(PORT) == want
    trips = [s["rungs"]["ivf"]["tripped"] for s in want[::2]]
    assert trips[:2] == [False, True]
    assert not any(s["rungs"]["pq_flat"]["tripped"] for s in want[:2])


@pytest.mark.parametrize("env", [
    {}, {"PIO_RECALL": "off", "PIO_RECALL_SAMPLE": "2", "PIO_RECALL_K": "0",
         "PIO_RECALL_MAX_ROWS": "-3", "PIO_RECALL_GATE": "no"},
    {"PIO_RECALL_TOLERANCE": "0.2", "PIO_RECALL_MIN_SAMPLES": "x",
     "PIO_RECALL_FAST_WINDOW": "8", "PIO_RECALL_RECOVERY_S": "1"},
])
def test_recall_config_from_env_as_the_reference(env):
    assert dataclasses.asdict(port_r.RecallConfig.from_env(env)) == \
        dataclasses.asdict(ref_r.RecallConfig.from_env(env))


def _live(pkg, rung, baseline, gate=True, batches=24):
    """Serve ``batches`` query batches of 4 on ``rung`` through the
    package's own retriever with the capture hook armed; drain the
    captures synchronously; return the recall block and the folded
    gate."""
    it, qv, ivf, pq = _structures()
    i, p = _carry(pkg, ivf, pq)
    kw = {} if pkg is REF else {"device": "cpu"}
    if baseline is None:
        sc = ref_r.build_recall_scorecard(qv, it, ivf=ivf, pq=pq, seed=0)
        sc = sc if pkg is REF else port_r.recall_scorecard_from_mapping(
            dataclasses.asdict(sc))
    else:
        sc = pkg.r.RecallScorecard(
            recall={rung: {1: baseline, 10: baseline}}, n_queries=64)

    class Wrap:
        def __init__(self):
            self.item_vecs = it
            self.recall = sc
            self._r = pkg.ret.Retriever(it, ivf=i, pq=p, name="t", **kw)
            pkg.ret.cached_retriever(self, lambda: self._r)

        def retriever(self):
            return pkg.ret.cached_retriever(self, lambda: self._r)

    w = Wrap()
    mon = pkg.r.RecallMonitor(pkg.r.RecallConfig(
        sample=0.5, k=10, fast_window=64, reservoir=256, min_samples=10,
        tolerance=0.05, recovery_s=30.0, gate=gate),
        registry=pkg.obs.get_registry(), clock=lambda: 0.0)
    mon._ensure_thread = lambda: None        # drained synchronously below
    mon.on_generation(2, [w])
    os.environ["PIO_RETRIEVAL_RUNG"] = rung
    try:
        for b in range(batches):
            sink = pkg.wf.Waterfall()
            sink.sample_u = 0.25 if b % 3 else 0.75   # 2 in 3 sampled
            with pkg.wf.dispatch_sink(sink):
                _, _, info = w._r.topk(qv[4 * b:4 * b + 4], 10)
            assert info["rung"] == rung
    finally:
        os.environ.pop("PIO_RETRIEVAL_RUNG", None)
    while mon.drain_once():
        pass
    doc = mon.payload()
    quality = {"enabled": True, "verdict": "healthy",
               "gate": {"enabled": True, "rollback": False, "reasons": []}}
    folded = mon.augment_quality(dict(quality))
    mon.close()
    doc["scorecard"].pop("builtAt", None)
    folded["recall"]["scorecard"].pop("builtAt", None)
    series = pkg.obs.get_registry().get("pio_retrieval_recall").series()
    return doc, folded, series


@pytest.mark.parametrize("rung", ["ivf", "ivf_pq", "pq_flat"])
def test_live_recall_equals_the_reference(rung):
    want = _live(REF, rung, None)
    got = _live(PORT, rung, None)
    assert got == want
    doc = want[0]
    row = doc["rungs"][rung]
    assert doc["captured"] == doc["scored"] == 16
    assert row["nFast"] == 64 and doc["verdict"] == "healthy"
    assert abs(row["recallFast"] - row["baseline"]) <= 0.1


@pytest.mark.parametrize("gate", [True, False], ids=["gate", "report"])
def test_recall_regression_folds_into_the_gate_as_the_reference(gate):
    want = _live(REF, "ivf_pq", 0.999, gate=gate)
    got = _live(PORT, "ivf_pq", 0.999, gate=gate)
    assert got == want
    folded = want[1]
    assert folded["recall"]["tripped"]
    assert folded["gate"]["rollback"] is gate
    assert ("recall_regression" in folded["gate"]["reasons"]) is gate


def test_kill_switch_passes_the_document_through(monkeypatch):
    monkeypatch.setenv("PIO_RECALL", "off")
    mon = port_r.RecallMonitor()
    doc = {"enabled": True, "gate": {"rollback": False}}
    assert mon.augment_quality(doc) is doc
    assert port_obs.get_registry().get("pio_retrieval_recall") is None


def test_pq_flat_recall_through_the_port_server(tmp_path, monkeypatch):
    """A generation carried in with its recall scorecard serves
    ``pq_flat`` (the rung phase 11 of the smoke run serves), and
    ``/quality.json`` reads the live recall of the served answers near
    that baseline."""
    from predictionio_tpu_torch.config import memory_config
    from predictionio_tpu_torch.controller import EngineVariant
    from predictionio_tpu_torch.data.storage import Storage
    from predictionio_tpu_torch.server.engine_server import EngineServer
    from predictionio_tpu_torch.templates.recommendation import (
        engine,
        wrapper_from_numpy,
    )
    from predictionio_tpu_torch.workflow.core_workflow import (
        persist_instance,
    )

    monkeypatch.setenv("PIO_RECALL_SAMPLE", "1")
    monkeypatch.setenv("PIO_RECALL_MIN_SAMPLES", "20")
    monkeypatch.setenv("PIO_RESULT_CACHE", "0")
    it, qv, ivf, pq = _structures()
    users = qv[:40]
    rsc = ref_r.build_recall_scorecard(users, it, pq=pq, seed=0, name="als")
    wrapper = wrapper_from_numpy(
        users, it, [f"u{i}" for i in range(40)],
        [f"i{i}" for i in range(len(it))], rank=it.shape[1],
        pq=dataclasses.asdict(pq), recall=dataclasses.asdict(rsc))
    storage = Storage(memory_config(tmp_path))
    eng = engine()
    variant = EngineVariant.from_dict({
        "id": "default",
        "engineFactory":
            "predictionio_tpu_torch.templates.recommendation:engine",
        "datasource": {"params": {"appName": "recallapp"}},
        "algorithms": [{"name": "als", "params": {"rank": it.shape[1]}}]})
    persist_instance(eng, variant, [wrapper], storage)
    srv = EngineServer(eng, variant, storage, device="cpu")
    try:
        for u in range(40):
            st, _ = srv.handle("POST", "/queries.json",
                               f'{{"user": "u{u}", "num": 10}}'.encode())[:2]
            assert st == 200
        # The monitor's own thread drains the queue too: a capture it has
        # taken but not yet scored is in neither the queue nor the doc,
        # so wait (bounded) until every capture is scored.
        deadline = time.monotonic() + 10.0
        while True:
            while srv.recall.drain_once():
                pass
            doc = srv.handle("GET", "/quality.json", b"")[1]["recall"]
            if doc["rungs"]["pq_flat"]["nFast"] >= 40 \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.02)
    finally:
        srv.stop()
    row = doc["rungs"]["pq_flat"]
    assert doc["scorecard"]["fingerprint"] == rsc.fingerprint
    assert row["baseline"] == round(rsc.recall["pq_flat"][10], 4)
    assert row["nFast"] == 40 and doc["verdict"] == "healthy"
    assert abs(row["recallFast"] - row["baseline"]) <= 0.05
