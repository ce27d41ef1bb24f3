"""The port's ``pio`` console: ``python -m predictionio_tpu_torch.cli``.

Cases of the reference's ``tests/test_cli.py`` for the verbs the port
has (app and channel lifecycle, access keys, import / export with
``--from-line``, build, a bad engine.json, train, eval, status), the
port's ``--device`` rule, and two end-to-end checks:

- the quickstart parity test: the reference's CLI (JAX on the CPU) and
  the port's (``--device cpu``) each run ``app new`` → ``import`` →
  ``train`` → ``batchpredict`` on the same seeded JSONL in their own
  ``PIO_HOME`` (rank 10, 3 iterations): the answers agree, ids equal
  except within ties, scores within atol 1e-4 + rtol 1e-3 (the training
  tolerance of ``tests/test_torch_als_train.py``);
- one across processes: ``deploy --device cpu`` in a subprocess answers
  ``/queries.json`` as the in-process server does from the same storage,
  and exits 0 on ``POST /stop``.

``pio status --fleet`` prints the reference's fleet lines against a live
server of each package (URL, burn rates and latency quantiles masked),
and the fleet verbs' argparse surfaces equal the reference's.
"""

import json
import os
import re
import select
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from predictionio_tpu_torch.cli import main as cli_main
from predictionio_tpu_torch.cli.main import main

ROOT = Path(__file__).resolve().parents[1]
ATOL, RTOL = 1e-4, 1e-3
PORT_FACTORY = "predictionio_tpu_torch.templates.recommendation:engine"
SUBPROCESS_TIMEOUT_S = 180


def _clean_env(monkeypatch, home):
    from predictionio_tpu.data.storage import reset_storage as jax_reset
    from predictionio_tpu_torch.data.storage import reset_storage

    monkeypatch.setenv("PIO_HOME", str(home))
    for k in list(os.environ):
        if k.startswith(("PIO_STORAGE_", "PIO_FOLD_IN", "PIO_IVF", "PIO_PQ",
                         "PIO_EVAL_")) \
                or k in ("PIO_CONFIG_FILE", "PIO_RETRIEVAL_RUNG"):
            monkeypatch.delenv(k, raising=False)
    reset_storage()
    jax_reset()


@pytest.fixture()
def clean_storage(tmp_path, monkeypatch):
    from predictionio_tpu_torch.data.storage import reset_storage

    home = tmp_path / "pio_home"
    home.mkdir()
    _clean_env(monkeypatch, home)
    yield home
    reset_storage()


def run(capsys, *argv):
    code = main(list(argv))
    return code, capsys.readouterr().out


def _variant(path, app="qsapp", factory=PORT_FACTORY, **algo):
    spec = json.loads((ROOT / "examples" / "recommendation" /
                       "engine.json").read_text())
    spec["engineFactory"] = factory
    spec["datasource"]["params"]["appName"] = app
    spec["algorithms"][0]["params"].update(algo)
    path.write_text(json.dumps(spec))
    return path


def _write_events(path, n_users=20, n_items=25, n=300, seed=0):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for k in range(n):
            u, i = int(rng.integers(n_users)), int(rng.zipf(1.3) % n_items)
            buy = rng.random() < 0.15
            ev = {"event": "buy" if buy else "rate", "entityType": "user",
                  "entityId": f"u{u}", "targetEntityType": "item",
                  "targetEntityId": f"i{i}",
                  "eventTime": f"2026-01-01T{k // 3600:02d}:"
                               f"{k // 60 % 60:02d}:{k % 60:02d}Z"}
            if not buy:
                ev["properties"] = {"rating": float(rng.integers(1, 11))
                                    * 0.5}
            f.write(json.dumps(ev) + "\n")
    return path


# -- the reference's verb tests ----------------------------------------------

def test_app_lifecycle(clean_storage, capsys):
    code, out = run(capsys, "app", "new", "myapp")
    assert code == 0 and "Access Key:" in out
    key = re.search(r"Access Key: (\S+)", out).group(1)
    code, out = run(capsys, "app", "list")
    assert "myapp" in out and key in out
    code, out = run(capsys, "accesskey", "new", "myapp", "view", "buy")
    assert code == 0 and "restricted" in out
    code, out = run(capsys, "accesskey", "list", "myapp")
    assert "events=view,buy" in out and "Finished listing 2" in out
    code, out = run(capsys, "accesskey", "delete", key)
    assert code == 0 and "Deleted access key." in out
    code, out = run(capsys, "app", "channel-new", "myapp", "live")
    assert code == 0
    with pytest.raises(SystemExit):
        run(capsys, "app", "channel-new", "myapp", "bad name!")
    with pytest.raises(SystemExit):
        run(capsys, "app", "new", "myapp")
    code, out = run(capsys, "app", "delete", "myapp", "-f")
    assert code == 0 and "Deleted app myapp." in out
    code, out = run(capsys, "app", "list")
    assert "Finished listing 0 app(s)." in out


def test_channel_lifecycle(clean_storage, capsys):
    run(capsys, "app", "new", "capp")
    code, out = run(capsys, "app", "channel-new", "capp", "mobile")
    assert code == 0 and "mobile" in out
    code, out = run(capsys, "app", "channel-delete", "capp", "mobile")
    assert code == 0
    with pytest.raises(SystemExit):
        run(capsys, "app", "channel-delete", "capp", "mobile")


def test_import_export_roundtrip(clean_storage, capsys, tmp_path):
    run(capsys, "app", "new", "impapp")
    run(capsys, "app", "channel-new", "impapp", "side")
    src = tmp_path / "events.ndjson"
    src.write_text("\n".join(
        json.dumps({"event": "rate", "entityType": "user",
                    "entityId": f"u{i}", "targetEntityType": "item",
                    "targetEntityId": "i1",
                    "properties": {"rating": float(i)},
                    "eventTime": f"2026-01-0{i + 1}T00:00:00Z"})
        for i in range(3)))
    code, out = run(capsys, "import", "--appid", "1", "--input", str(src))
    assert code == 0 and "Imported 3 events" in out
    dst = tmp_path / "out.ndjson"
    code, out = run(capsys, "export", "--appid", "1", "--output", str(dst))
    assert code == 0 and "Exported 3 events" in out
    lines = [json.loads(ln) for ln in dst.read_text().splitlines()]
    assert [ln["entityId"] for ln in lines] == ["u0", "u1", "u2"]
    assert lines[0]["properties"]["rating"] == 0.0
    assert lines[2]["eventTime"] == "2026-01-03T00:00:00.000+00:00"
    code, out = run(capsys, "export", "--appid", "1", "--channel", "side",
                    "--output", str(dst))
    assert "Exported 0 events" in out
    code, out = run(capsys, "app", "data-delete", "impapp", "-f")
    assert code == 0 and "Event data deleted." in out
    code, out = run(capsys, "export", "--appid", "1", "--output", str(dst))
    assert "Exported 0 events" in out


def test_import_resume_from_line(clean_storage, capsys, tmp_path,
                                 monkeypatch):
    """A parse error mid-file leaves the chunks committed before it and
    names the resume point; re-running from there imports the rest
    without duplicating the committed prefix."""
    monkeypatch.setattr(cli_main, "IMPORT_CHUNK", 2)
    run(capsys, "app", "new", "resapp")
    src = tmp_path / "events.ndjson"
    good = [json.dumps({"event": "rate", "entityType": "user",
                        "entityId": f"u{i}"}) for i in range(5)]
    src.write_text("\n".join(good[:2] + ["NOT JSON"] + good[2:]))
    with pytest.raises(SystemExit):
        run(capsys, "import", "--appid", "1", "--input", str(src))
    err = capsys.readouterr().err
    assert "2 event(s) up to line 2 were already imported" in err
    m = re.search(r"--from-line (\d+)", err)
    assert m and m.group(1) == "3"
    src.write_text("\n".join(good[:2] + [good[4]] + good[2:]))
    code, out = run(capsys, "import", "--appid", "1", "--input", str(src),
                    "--from-line", m.group(1))
    assert code == 0 and "Imported 4 events" in out
    dst = tmp_path / "out.ndjson"
    run(capsys, "export", "--appid", "1", "--output", str(dst))
    ids = [json.loads(ln)["entityId"] for ln in dst.read_text().splitlines()]
    assert sorted(ids) == ["u0", "u1", "u2", "u3", "u4", "u4"]


def test_import_rejects_an_invalid_event(clean_storage, capsys, tmp_path):
    run(capsys, "app", "new", "valapp")
    src = tmp_path / "events.ndjson"
    src.write_text(json.dumps({"event": "$bogus", "entityType": "user",
                               "entityId": "u1"}))
    with pytest.raises(SystemExit):
        run(capsys, "import", "--appid", "1", "--input", str(src))
    assert "not a supported reserved event name" in capsys.readouterr().err


@pytest.mark.parametrize("params,code", [({"rank": 4}, 0),
                                         ({"rankk": 4}, 1)])
def test_build_validates_engine_json(clean_storage, capsys, tmp_path,
                                     params, code):
    ej = tmp_path / "engine.json"
    ej.write_text(json.dumps({
        "engineFactory": PORT_FACTORY,
        "datasource": {"params": {"appName": "x"}},
        "algorithms": [{"name": "als", "params": params}],
    }))
    got, out = run(capsys, "build", "--engine-json", str(ej))
    assert got == code
    assert ("Build successful" in out) == (code == 0)


def test_bad_engine_json(clean_storage, capsys):
    with pytest.raises(SystemExit):
        run(capsys, "train", "--engine-json", "/nonexistent/engine.json",
            "--device", "cpu")


def test_status(clean_storage, capsys):
    code, out = run(capsys, "status")
    assert code == 0
    assert "METADATA: type=sqlite" in out and "sanity check OK" in out
    assert (clean_storage / "storage" / "pio.db").exists()


@pytest.mark.parametrize("argv", [
    ["train", "--mesh", "data=8"],
    ["eval", "a:b", "c:d", "--mesh", "x"]])
def test_flags_without_substrate_are_rejected(clean_storage, capsys, argv):
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err


def _fleet_lines(text, url):
    """`pio status`'s lines from ``fleet:`` on, with the URL, the burn
    rates and the latency quantiles (timings) masked."""
    lines = text.split("fleet: ", 1)[1].splitlines()
    out = []
    for line in ["fleet: " + lines[0]] + lines[1:]:
        if line.startswith("(sanity check OK)"):
            break
        line = line.replace(url, "<U>")
        line = re.sub(r"a=[0-9.e+-]+/l=[0-9.e+-]+", "a=<b>/l=<b>", line)
        line = re.sub(r"p50 \S+ms p99 \S+ms", "p50 <ms> p99 <ms>", line)
        out.append(line)
    return out


def test_status_fleet_prints_the_reference_lines(tmp_path, monkeypatch,
                                                 capsys):
    """`pio status --fleet URL` against a live server of each package
    prints the reference's fleet summary: instance state, SLO, the
    fleet totals, the latency quantiles, the shared spill queue and the
    journaled rollout line; `--metrics-url` prints one instance's
    snapshot instead, and outranks PIO_FLEET_INSTANCES."""
    from predictionio_tpu.cli.main import main as ref_main
    from test_torch_rollout import _port_stack, _ref_stack

    _clean_env(monkeypatch, tmp_path / "home")
    monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_METADATA_SOURCE", "MEMORY")
    monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE", "MEMORY")
    monkeypatch.delenv("PIO_FLEET_INSTANCES", raising=False)
    journal = tmp_path / "home" / "rollout" / "state.json"
    journal.parent.mkdir(parents=True)
    journal.write_text(json.dumps({
        "rolloutId": "abc123", "status": "rolled_back", "wave": 0,
        "waveCounts": [1, 4], "promoted": ["u1"], "skipped": {"u2": "x"},
        "haltReason": "fleet quality gate: ['drift']"}))
    said = {}
    for label, make, cli in (
            ("reference", _ref_stack, ref_main),
            ("port", lambda: _port_stack(tmp_path / "port"), main)):
        pkg = make()
        pkg.wf.run_train(pkg.eng, pkg.variant, pkg.ctx)
        srv = pkg.server()
        srv.start()
        url = f"http://127.0.0.1:{srv.port}"
        try:
            for n in range(3):
                req = urllib.request.Request(
                    url + "/queries.json", method="POST",
                    data=json.dumps({"user": f"u{n}", "num": 2}).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=30) as r:
                    assert r.status == 200
            assert cli(["status", "--fleet", url]) == 0
            said[label] = _fleet_lines(capsys.readouterr().out, url)
            monkeypatch.setenv("PIO_FLEET_INSTANCES", url)
            assert cli(["status", "--metrics-url", url]) == 0
            one = capsys.readouterr().out
            monkeypatch.delenv("PIO_FLEET_INSTANCES")
            assert "fleet:" not in one
            assert "serving: model generation 1" in one
            assert f"metrics (scraped from {url}/metrics):" in one
        finally:
            srv.stop()
    assert said["port"] == said["reference"]
    lines = said["port"]
    assert lines[0] == "fleet: 1 instance(s)"
    assert lines[1].startswith("  <U>: up, healthy, burn fast")
    assert "    pio_query_requests_total 3" in lines
    assert any(ln.startswith("  fleet pio_query_latency_ms: p50 <ms> p99 "
                             "<ms> over 3 requests") for ln in lines)
    assert any(ln.startswith("  shared spill queue: ") for ln in lines)
    assert lines[-1] == ("  rollout [abc123]: rolled_back — wave 0 of 2, "
                         "1 promoted, 1 skipped, halt: fleet quality "
                         "gate: ['drift']")


def _surface(parser, verb):
    sub = next(a for a in parser._actions
               if isinstance(a, __import__("argparse")._SubParsersAction))
    return sorted(
        (tuple(a.option_strings), a.dest, a.default, a.type, a.nargs,
         a.const, a.choices, a.required, a.metavar)
        for a in sub.choices[verb]._actions)


@pytest.mark.parametrize("verb", ["adminserver", "dashboard", "profile",
                                  "rollout", "status"])
def test_fleet_verbs_parse_as_the_reference(verb):
    """The four fleet-plane verbs and `status`' fleet flags: the same
    options, destinations, defaults, types and metavars."""
    from predictionio_tpu.cli.main import build_parser as ref_parser

    assert _surface(cli_main.build_parser(), verb) == \
        _surface(ref_parser(), verb)


def test_access_keys_never_start_with_a_dash(clean_storage, capsys,
                                            monkeypatch):
    """A key that starts with "-" reads as an option to the CLI, so
    ``pio accesskey delete <key>`` could not name it: one generated key
    in 64 did (``secrets.token_urlsafe``), which made
    ``test_app_lifecycle`` fail at random.  The generator draws again."""
    import secrets

    draws = iter(["-dash" + "x" * 59, "-again" + "y" * 58, "ok" + "z" * 62])
    monkeypatch.setattr(secrets, "token_urlsafe", lambda n: next(draws))
    code, out = run(capsys, "app", "new", "dashapp")
    key = re.search(r"Access Key: (\S+)", out).group(1)
    assert code == 0 and key == "ok" + "z" * 62
    code, out = run(capsys, "accesskey", "delete", key)
    assert code == 0 and "Deleted access key." in out


def test_no_cuda_and_no_device_cpu_is_an_error(clean_storage, capsys,
                                               tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device works")
    run(capsys, "app", "new", "qsapp")
    ej = _variant(tmp_path / "engine.json", rank=2, numIterations=1)
    for verb in (["train"], ["deploy", "--port", "0"],
                 ["batchpredict", "--input", "q", "--output", "p"]):
        with pytest.raises(SystemExit) as e:
            main([*verb, "--engine-json", str(ej)])
        assert e.value.code == 1
        assert "CUDA is not available" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        main(["eval", "predictionio_tpu_torch.templates.recommendation."
              "evaluation:evaluation", "predictionio_tpu_torch.templates."
              "recommendation.evaluation:default_params_generator"])
    from predictionio_tpu_torch.data.storage import get_storage

    assert get_storage().get_engine_instances().get_all() == []


def test_train_via_cli(clean_storage, capsys, tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_PQ", "auto")   # the verb sets it; undone after
    run(capsys, "app", "new", "qsapp")
    src = _write_events(tmp_path / "ev.jsonl", n=120)
    run(capsys, "import", "--appid", "1", "--input", str(src))
    ej = _variant(tmp_path / "engine.json", rank=4, numIterations=2)
    code, out = run(capsys, "train", "--engine-json", str(ej),
                    "--device", "cpu", "--pq", "off")
    assert code == 0 and "Training completed" in out
    iid = re.search(r"Engine instance ID: (\w+)", out).group(1)
    assert os.environ["PIO_PQ"] == "off"
    from predictionio_tpu_torch.data.storage import get_storage

    inst = get_storage().get_engine_instances().get(iid)
    assert inst.status == "COMPLETED"
    assert inst.engine_factory == PORT_FACTORY
    assert list((clean_storage / "storage" / "models").iterdir())
    with pytest.raises(SystemExit):
        main(["train", "--engine-json", str(ej), "--device", "cpu",
              "--pq", "sometimes"])


def test_cli_eval_end_to_end(clean_storage, capsys, tmp_path):
    """``pio eval`` drives the sweep and writes the evaluation instance
    and its JSON results (reference: RunEvaluation)."""
    from predictionio_tpu_torch.data.event import DataMap, Event
    from predictionio_tpu_torch.data.storage import App, get_storage

    storage = get_storage()
    app_id = storage.get_apps().insert(App(id=None, name="testapp"))
    storage.get_events().init(app_id)
    storage.get_events().insert_batch([
        Event(event="rate", entity_type="user", entity_id=f"u{u % 12}",
              target_entity_type="item", target_entity_id=f"i{(u + d) % 8}",
              properties=DataMap({"rating": float(1 + d % 5)}))
        for u in range(12) for d in range(6)], app_id)
    out_json = tmp_path / "eval.json"
    code, out = run(
        capsys, "eval",
        "predictionio_tpu_torch.templates.recommendation.evaluation:"
        "evaluation",
        "predictionio_tpu_torch.templates.recommendation.evaluation:"
        "default_params_generator",
        "--output-json", str(out_json), "--device", "cpu")
    assert code == 0 and "Evaluation instance ID:" in out
    res = json.loads(out_json.read_text())
    assert "bestScore" in res and len(res["candidates"]) == 2
    assert len(storage.get_evaluation_instances().get_completed()) == 1


# -- the quickstart loop, both packages ---------------------------------------

def _quickstart(cli, home, tmp_path, factory, monkeypatch, capsys, *extra):
    """app new → import → train → batchpredict through ``cli`` in
    ``home``; returns the predictions by user."""
    _clean_env(monkeypatch, home)
    src = _write_events(tmp_path / "ev.jsonl")
    ej = _variant(home / "engine.json", factory=factory, rank=10,
                  numIterations=3)
    queries = tmp_path / "q.jsonl"
    queries.write_text("\n".join(json.dumps({"user": f"u{u}", "num": 6})
                                 for u in range(20)) + "\n"
                       + json.dumps({"user": "ghost", "num": 3}) + "\n")
    out = home / "pred.jsonl"
    for argv in (["app", "new", "qsapp"],
                 ["import", "--appid", "1", "--input", str(src)],
                 ["train", "--engine-json", str(ej), *extra],
                 ["batchpredict", "--engine-json", str(ej), "--input",
                  str(queries), "--output", str(out), *extra]):
        assert cli(argv) == 0, argv
    capsys.readouterr()
    return {json.loads(ln)["query"]["user"]: json.loads(ln)["prediction"]
            for ln in out.read_text().splitlines()}


def _agree(got, want):
    """Ids equal except within a tie, scores within the training
    tolerance."""
    gi = [h["item"] for h in got["itemScores"]]
    wi = [h["item"] for h in want["itemScores"]]
    gs = np.array([h["score"] for h in got["itemScores"]])
    ws = np.array([h["score"] for h in want["itemScores"]])
    assert len(gi) == len(wi)
    np.testing.assert_allclose(gs, ws, rtol=RTOL, atol=ATOL)
    tol = ATOL + RTOL * np.abs(ws).max(initial=0.0)
    for j, (a, b) in enumerate(zip(gi, wi)):
        if a != b:
            tied = [k for k, w in enumerate(wi) if w == a]
            assert tied and abs(ws[tied[0]] - ws[j]) <= 2 * tol \
                or abs(ws[j] - ws[-1]) <= 2 * tol, (gi, wi, ws)


def test_quickstart_parity_with_the_reference_cli(tmp_path, monkeypatch,
                                                  capsys):
    from predictionio_tpu.cli.main import main as jax_main
    from predictionio_tpu.data.storage import reset_storage as jax_reset
    from predictionio_tpu_torch.data.storage import reset_storage

    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    try:
        want = _quickstart(jax_main, tmp_path / "jax", tmp_path,
                           "predictionio_tpu.templates.recommendation:engine",
                           monkeypatch, capsys)
        got = _quickstart(main, tmp_path / "port", tmp_path, PORT_FACTORY,
                          monkeypatch, capsys, "--device", "cpu")
    finally:
        jax_reset()
        reset_storage()
    assert sorted(got) == sorted(want) and len(got) == 21
    assert got["ghost"] == want["ghost"] == {"itemScores": []}
    for user in want:
        _agree(got[user], want[user])


def test_deploy_in_a_subprocess_answers_as_in_process(clean_storage,
                                                      capsys, tmp_path):
    from predictionio_tpu_torch.controller import EngineVariant
    from predictionio_tpu_torch.data.storage import get_storage
    from predictionio_tpu_torch.server.engine_server import EngineServer
    from predictionio_tpu_torch.templates.recommendation import engine

    run(capsys, "app", "new", "qsapp")
    run(capsys, "import", "--appid", "1", "--input",
        str(_write_events(tmp_path / "ev.jsonl", n=150)))
    ej = _variant(tmp_path / "engine.json", rank=4, numIterations=2)
    assert main(["train", "--engine-json", str(ej), "--device", "cpu"]) == 0
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.cli", "deploy",
         "--engine-json", str(ej), "--device", "cpu", "--ip", "127.0.0.1",
         "--port", "0"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        ready, _, _ = select.select([proc.stdout], [], [],
                                    SUBPROCESS_TIMEOUT_S)
        line = proc.stdout.readline() if ready else ""
        m = re.search(r"listening on 127\.0\.0\.1:(\d+) \(instance (\w+); "
                      r"device cpu;", line)
        assert m, (line, proc.stderr.read() if proc.poll() is not None
                   else "")
        base = f"http://127.0.0.1:{m.group(1)}"
        with urllib.request.urlopen(base + "/", timeout=30) as r:
            status = json.loads(r.read())
        assert status["device"] == "cpu"
        assert status["engineInstanceId"] == m.group(2)
        local = EngineServer(engine(), EngineVariant.from_file(ej),
                             get_storage(), device="cpu")
        for user in ("u0", "u3", "u7", "ghost"):
            q = {"user": user, "num": 5}
            req = urllib.request.Request(
                base + "/queries.json", data=json.dumps(q).encode(),
                method="POST")
            with urllib.request.urlopen(req, timeout=30) as r:
                assert json.loads(r.read()) == local.query_batch([q])[0]
        req = urllib.request.Request(base + "/stop", data=b"",
                                     method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            assert json.loads(r.read()) == {"status": "stopping"}
        assert proc.wait(timeout=SUBPROCESS_TIMEOUT_S) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()


# -- the serving scheduler's flags and the native frontends -------------------

class _Verb:
    """``python -m predictionio_tpu_torch.cli <argv>`` in a subprocess,
    until its first stdout line matches ``pattern``."""

    def __init__(self, argv, pattern):
        env = {**os.environ, "PYTHONPATH": str(ROOT)}
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch.cli", *argv],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        ready, _, _ = select.select([self.proc.stdout], [], [],
                                    SUBPROCESS_TIMEOUT_S)
        line = self.proc.stdout.readline() if ready else ""
        self.match = re.search(pattern, line)
        if not self.match:
            self.close()
            raise AssertionError((line, self.proc.stderr.read()))
        self.base = f"http://127.0.0.1:{self.match.group(1)}"

    def get(self, path):
        with urllib.request.urlopen(self.base + path, timeout=30) as r:
            return r.status, r.read()

    def post(self, path, obj):
        req = urllib.request.Request(self.base + path,
                                     data=json.dumps(obj).encode(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            return json.loads(r.read())

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)
        self.proc.stdout.close()
        self.proc.stderr.close()


def _trained(capsys, tmp_path):
    run(capsys, "app", "new", "qsapp")
    run(capsys, "import", "--appid", "1", "--input",
        str(_write_events(tmp_path / "ev.jsonl", n=150)))
    ej = _variant(tmp_path / "engine.json", rank=4, numIterations=2)
    assert main(["train", "--engine-json", str(ej), "--device", "cpu"]) == 0
    return ej


def _local_answers(ej, users):
    from predictionio_tpu_torch.controller import EngineVariant
    from predictionio_tpu_torch.data.storage import get_storage
    from predictionio_tpu_torch.server.engine_server import EngineServer
    from predictionio_tpu_torch.templates.recommendation import engine

    local = EngineServer(engine(), EngineVariant.from_file(ej),
                         get_storage(), device="cpu")
    try:
        return local.query_batch([{"user": u, "num": 5} for u in users])
    finally:
        local.stop()


def _close(got, want):
    """Answers of one cohort against another's: the same items, scores
    within float32 rounding (another batch shape sums in another
    order)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [h["item"] for h in g["itemScores"]] == \
            [h["item"] for h in w["itemScores"]]
        np.testing.assert_allclose([h["score"] for h in g["itemScores"]],
                                   [h["score"] for h in w["itemScores"]],
                                   rtol=1e-5, atol=1e-6)


_DEPLOY_LINE = (r"listening on 127\.0\.0\.1:(\d+) \(instance (\w+); "
                r"device cpu;")


def test_deploy_scheduler_flags_reach_the_scheduler(clean_storage, capsys,
                                                    tmp_path):
    """``--max-batch``, ``--batch-window-ms``, ``--queue-depth`` and
    ``--batch-p99-target-ms`` override the PIO_BATCH_* / PIO_QUEUE_*
    knobs (the env sets others, which the flags beat)."""
    ej = _trained(capsys, tmp_path)
    os.environ["PIO_BATCH_MAX"] = "32"
    os.environ["PIO_QUEUE_DEPTH"] = "99"
    try:
        d = _Verb(["deploy", "--engine-json", str(ej), "--device", "cpu",
                   "--ip", "127.0.0.1", "--port", "0", "--max-batch", "8",
                   "--batch-window-ms", "5", "--queue-depth", "7",
                   "--batch-p99-target-ms", "50"], _DEPLOY_LINE)
    finally:
        del os.environ["PIO_BATCH_MAX"], os.environ["PIO_QUEUE_DEPTH"]
    try:
        users = ["u0", "u3", "ghost"]
        got = [d.post("/queries.json", {"user": u, "num": 5})
               for u in users]
        _close(got, _local_answers(ej, users))
        snap = json.loads(d.get("/")[1])["batcher"]["default"]
        assert (snap["batching"], snap["maxBatch"], snap["queueLimit"],
                snap["windowMs"], snap["p99TargetMs"]) == \
            (True, 8, 7, 5.0, 50.0)
        assert snap["requests"] == 3
        assert d.post("/stop", {}) == {"status": "stopping"}
        assert d.proc.wait(timeout=SUBPROCESS_TIMEOUT_S) == 0
    finally:
        d.close()


def test_deploy_no_batcher_dispatches_inline(clean_storage, capsys,
                                             tmp_path):
    ej = _trained(capsys, tmp_path)
    d = _Verb(["deploy", "--engine-json", str(ej), "--device", "cpu",
               "--ip", "127.0.0.1", "--port", "0", "--no-batcher"],
              _DEPLOY_LINE)
    try:
        users = ["u1", "u2", "u1"]
        got = [d.post("/queries.json", {"user": u, "num": 5})
               for u in users]
        _close(got, _local_answers(ej, users))
        root = json.loads(d.get("/")[1])
        snap = root["batcher"]["default"]
        assert snap["batching"] is False and snap["maxBatch"] == 1
        assert (snap["dispatches"], snap["requests"]) == (2, 2)
        assert root["resultCache"]["hits"] == 1      # the repeat of u1
        assert d.post("/stop", {}) == {"status": "stopping"}
        assert d.proc.wait(timeout=SUBPROCESS_TIMEOUT_S) == 0
    finally:
        d.close()


def test_deploy_native_answers_as_in_process(clean_storage, capsys,
                                             tmp_path):
    """``pio deploy --native``: the C++ frontend answers /queries.json
    through the server's batched dispatch, / is its own liveness, other
    routes reach the engine server, POST /stop exits 0."""
    ej = _trained(capsys, tmp_path)
    d = _Verb(["deploy", "--engine-json", str(ej), "--device", "cpu",
               "--ip", "127.0.0.1", "--port", "0", "--native",
               "--max-batch", "4", "--max-wait-us", "500"],
              r"Native engine frontend on 127\.0\.0\.1:(\d+) \(instance "
              r"(\w+); device cpu; continuous batching ≤4;")
    try:
        assert json.loads(d.get("/")[1]) == {"status": "alive",
                                            "frontend": "native"}
        users = ["u0", "u4", "u7", "ghost"]
        got = [d.post("/queries.json", {"user": u, "num": 5})
               for u in users]
        _close(got, _local_answers(ej, users))
        stats = json.loads(d.get("/stats.json")[1])
        assert "batcher" in stats and "resultCache" in stats
        assert b"pio_frontend_batches_total" in d.get("/metrics")[1]
        assert d.post("/stop", {}) == {"status": "stopping"}
        assert d.proc.wait(timeout=SUBPROCESS_TIMEOUT_S) == 0
    finally:
        d.close()


def test_deploy_native_build_failure_exits_with_the_compilers_message(
        clean_storage, capsys, tmp_path, monkeypatch):
    """No fallback to the Python transport: a frontend that does not
    build ends the verb non-zero with g++'s message."""
    from predictionio_tpu_torch.native import build

    ej = _trained(capsys, tmp_path)
    src = tmp_path / "src"
    src.mkdir()
    (src / "serving_frontend.cc").write_text("this is not C++\n")
    monkeypatch.setattr(build, "SOURCE_DIR", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(SystemExit) as e:
        main(["deploy", "--engine-json", str(ej), "--device", "cpu",
              "--ip", "127.0.0.1", "--port", "0", "--native"])
    assert e.value.code == 1
    err = capsys.readouterr().err
    assert "native frontend unavailable: g++ failed" in err
    assert "error" in err.split("g++ failed", 1)[1]


def test_eventserver_native_ingests_and_drains(clean_storage, capsys,
                                               tmp_path):
    """``pio eventserver --native``: SDK single and batch posts through
    the C++ frontend land exactly once (``pio export``), SIGTERM drains
    with exit 0."""
    import signal

    from predictionio_tpu_torch.sdk import EventClient

    code, out = run(capsys, "app", "new", "nativeapp")
    key = re.search(r"Access Key: (\S+)", out).group(1)
    es = _Verb(["eventserver", "--ip", "127.0.0.1", "--port", "0",
                "--native"],
               r"Event Server \(native frontend\) listening on "
               r"127\.0\.0\.1:(\d+) ")
    try:
        client = EventClient(key, es.base, timeout=30)
        evs = [{"event": "rate", "entityType": "user", "entityId": f"u{i}",
                "targetEntityType": "item", "targetEntityId": f"i{i % 3}",
                "properties": {"rating": float(i % 5 + 1)},
                "eventTime": f"2026-01-01T00:00:{i:02d}Z"}
               for i in range(12)]
        res = client.create_events(evs[:10], batch_token="tk1")
        assert [r.status for r in res] == [201] * 10
        assert [r.event_id for r in res] == [f"bttk1.{k}" for k in range(10)]
        again = client.create_events(evs[:10], batch_token="tk1")
        assert [r.event_id for r in again] == [r.event_id for r in res]
        for ev in evs[10:]:
            assert client.create_event(
                ev["event"], "user", ev["entityId"], "item",
                ev["targetEntityId"], ev["properties"],
                ev["eventTime"]).status == 201
        assert json.loads(es.get("/ready")[1])["status"] == "ready"
        es.proc.send_signal(signal.SIGTERM)
        assert es.proc.wait(timeout=SUBPROCESS_TIMEOUT_S) == 0
    finally:
        es.close()
    dst = tmp_path / "out.ndjson"
    code, out = run(capsys, "export", "--appid", "1", "--output", str(dst))
    assert "Exported 12 events" in out
    rows = sorted((e["entityId"], e["properties"]["rating"])
                  for e in map(json.loads, dst.read_text().splitlines()))
    assert rows == sorted((f"u{i}", float(i % 5 + 1)) for i in range(12))
