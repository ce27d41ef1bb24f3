"""The port's console verbs and entry point against the reference's, on
the CPU.

- ``pio storageserver`` hosts a ``PIO_HOME``'s store in a process of its
  own; ``pio app new`` → ``import`` → ``train`` → ``deploy`` then run
  with METADATA, EVENTDATA and MODELDATA all on ``type=pioserver``,
  through each package's CLI (rank 10, 3 iterations): the answers agree
  as the quickstart loop's do (ids equal except within ties, scores
  within atol 1e-4 + rtol 1e-3), and ``pio status`` names ``pioserver``
  for each repository.
- ``pio template get`` writes the same files and prints the same lines
  in both CLIs; the port's ``engine.json`` names the port's factory,
  the one difference.
- ``pio shell`` with piped stdin: the preloaded locals are there.
- Both servers' ``/metrics`` name the same series before the first
  request, once the reference's compile tracker is set aside
  (``start_runtime_introspection``).
- ``entry()`` on the CPU computes what ``__graft_entry__.entry()`` does.
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

from test_torch_cli import _agree, _clean_env, _variant, _write_events

ROOT = Path(__file__).resolve().parents[1]
SECRET = "cli-s3cret"
TIMEOUT_S = 180
PKG = {"reference": "predictionio_tpu", "port": "predictionio_tpu_torch"}
FACTORY = {"reference": "predictionio_tpu.templates.recommendation:engine",
           "port": "predictionio_tpu_torch.templates.recommendation:engine"}
TEMPLATES = sorted(p.name for p in (ROOT / "examples").iterdir()
                   if p.is_dir())


def _cli_main(pkg):
    if pkg == "reference":
        from predictionio_tpu.cli.main import main
    else:
        from predictionio_tpu_torch.cli.main import main
    return main


class _Proc:
    """``python -m <package>.cli <argv>`` in a subprocess, until its
    first stdout line matches ``pattern``.  Its stderr goes to the file
    ``log``, never to a pipe nobody reads, so the process cannot block
    on it, and :meth:`tail` shows it when a step fails."""

    def __init__(self, pkg, argv, pattern, env, log):
        self.log = Path(log)
        self._err = open(self.log, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", f"{PKG[pkg]}.cli", *argv], cwd=ROOT,
            env={**env, "PYTHONPATH": str(ROOT), "PYTHONUNBUFFERED": "1"},
            stdout=subprocess.PIPE, stderr=self._err, text=True)
        ready, _, _ = select.select([self.proc.stdout], [], [], TIMEOUT_S)
        line = self.proc.stdout.readline() if ready else ""
        self.match = re.search(pattern, line)
        if not self.match:
            self.close()
            raise AssertionError((line, self.tail()))

    def tail(self) -> str:
        return f"--- {self.log.name} ---\n" + self.log.read_text(
            errors="replace")[-4000:]

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)
        self.proc.stdout.close()
        self._err.close()


def _post(base, path, obj):
    req = urllib.request.Request(base + path, data=json.dumps(obj).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _complete_the_row(pkg):
    """The train's one engine-instance row, read over the wire: the
    port's is COMPLETED.  The reference's train leaves its row TRAINING
    over ``pioserver`` (its final update goes by the id its insert was
    meant to fill in, which a remote store cannot), so its row is
    completed here as that update meant to, before its deploy."""
    if pkg == "reference":
        from predictionio_tpu.data.storage import get_storage
    else:
        from predictionio_tpu_torch.data.storage import get_storage
    instances = get_storage().get_engine_instances()
    [row] = instances.get_all()
    if pkg == "port":
        assert row.status == "COMPLETED"
        return
    assert row.status == "TRAINING"
    row.status = "COMPLETED"
    assert instances.update(row)


def _remote_loop(pkg, tmp_path, monkeypatch, capsys):
    """The quickstart loop of ``pkg``'s CLI with every repository behind
    ``pkg``'s ``pio storageserver``; returns (answers by user, the
    status lines)."""
    work = tmp_path / pkg
    (work / "server_home").mkdir(parents=True)
    (work / "client_home").mkdir()
    _clean_env(monkeypatch, work / "server_home")
    step = ["storageserver"]     # the step under way, named if it fails
    procs = []
    try:
        return _remote_steps(pkg, work, monkeypatch, capsys, step, procs)
    except Exception as e:
        raise AssertionError(
            "\n".join([f"{pkg} loop, step {step[0]}: {e!r}"]
                      + [p.tail() for p in procs])) from e


def _remote_steps(pkg, work, monkeypatch, capsys, step, procs):
    server = _Proc(pkg, ["storageserver", "--ip", "127.0.0.1", "--port",
                         "0", "--secret", SECRET],
                   r"Storage server listening on 127\.0\.0\.1:(\d+) ",
                   dict(os.environ), work / "storageserver.log")
    procs.append(server)
    try:
        assert server.proc.stdout.readline().startswith(
            "Clients: PIO_STORAGE_SOURCES_REMOTE_TYPE=pioserver "
            "PIO_STORAGE_SOURCES_REMOTE_HOSTS=127.0.0.1 "
            f"PIO_STORAGE_SOURCES_REMOTE_PORTS={server.match.group(1)} ")
        _clean_env(monkeypatch, work / "client_home")
        for k, v in (("TYPE", "pioserver"), ("HOSTS", "127.0.0.1"),
                     ("PORTS", server.match.group(1)), ("SECRET", SECRET)):
            monkeypatch.setenv(f"PIO_STORAGE_SOURCES_REMOTE_{k}", v)
        for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
            monkeypatch.setenv(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE",
                               "REMOTE")
        main = _cli_main(pkg)
        device = ["--device", "cpu"] if pkg == "port" else []
        ej = _variant(work / "engine.json", factory=FACTORY[pkg], rank=10,
                      numIterations=3)
        for argv in (["app", "new", "qsapp"],
                     ["import", "--appid", "1", "--input",
                      str(_write_events(work / "ev.jsonl"))],
                     ["train", "--engine-json", str(ej), *device]):
            step[0] = argv[0]
            assert main(argv) == 0, argv
        step[0] = "the instance row"
        _complete_the_row(pkg)
        step[0] = "status"
        capsys.readouterr()
        assert main(["status"]) == 0
        status = capsys.readouterr().out
        step[0] = "deploy"
        deploy = _Proc(pkg, ["deploy", "--engine-json", str(ej), "--ip",
                             "127.0.0.1", "--port", "0", *device],
                       r"Engine Server listening on 127\.0\.0\.1:(\d+) ",
                       dict(os.environ), work / "deploy.log")
        procs.append(deploy)
        try:
            base = f"http://127.0.0.1:{deploy.match.group(1)}"
            step[0] = "queries"
            answers = {u: _post(base, "/queries.json", {"user": u, "num": 6})
                       for u in [f"u{n}" for n in range(20)] + ["ghost"]}
            step[0] = "stop"
            assert _post(base, "/stop", {}) == {"status": "stopping"}
            assert deploy.proc.wait(timeout=TIMEOUT_S) == 0
        finally:
            deploy.close()
    finally:
        server.close()
    step[0] = "the client's home"
    assert not (work / "client_home" / "storage").exists()
    return answers, status


def test_storageserver_train_and_deploy_through_both_clis(
        tmp_path, monkeypatch, capsys):
    from predictionio_tpu.data.storage import reset_storage as jax_reset
    from predictionio_tpu_torch.data.storage import reset_storage

    try:
        want, want_status = _remote_loop("reference", tmp_path, monkeypatch,
                                         capsys)
        jax_reset()
        got, got_status = _remote_loop("port", tmp_path, monkeypatch, capsys)
    finally:
        jax_reset()
        reset_storage()
    for status in (want_status, got_status):
        for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
            assert f"  {repo}: type=pioserver path=-" in status
    assert sorted(got) == sorted(want) and len(got) == 21
    assert got["ghost"] == want["ghost"] == {"itemScores": []}
    for user in want:
        _agree(got[user], want[user])


@pytest.mark.parametrize("template", TEMPLATES)
def test_template_get_through_both_clis(tmp_path, monkeypatch, capsys,
                                        template):
    out = {}
    for pkg in PKG:
        (tmp_path / pkg).mkdir()
        monkeypatch.chdir(tmp_path / pkg)
        assert _cli_main(pkg)(["template", "get", template, "mine"]) == 0
        out[pkg] = capsys.readouterr().out
    assert out["port"] == out["reference"]
    assert out["port"].startswith(f"Template {template!r} copied to mine/")
    files = {pkg: sorted(p.name for p in (tmp_path / pkg / "mine").iterdir())
             for pkg in PKG}
    assert files["port"] == files["reference"]
    for name in files["port"]:
        ref = (tmp_path / "reference" / "mine" / name).read_text()
        port = (tmp_path / "port" / "mine" / name).read_text()
        if name != "engine.json":
            assert port == ref
            continue
        diff = [(a, b) for a, b in zip(ref.splitlines(), port.splitlines())
                if a != b]
        assert len(ref.splitlines()) == len(port.splitlines())
        assert diff == [(
            f'  "engineFactory": "predictionio_tpu.templates.{template}'
            ':engine",',
            f'  "engineFactory": "predictionio_tpu_torch.templates.'
            f'{template}:engine",')]
        factory = json.loads(port)["engineFactory"]
        from predictionio_tpu_torch.controller import load_engine_factory

        assert load_engine_factory(factory)().__class__.__module__ \
            .startswith("predictionio_tpu_torch.")


@pytest.mark.parametrize("case", ["unknown", "not_empty"])
def test_template_get_refuses_as_the_reference(tmp_path, monkeypatch,
                                               capsys, case):
    out = {}
    for pkg in PKG:
        (tmp_path / pkg / "mine").mkdir(parents=True)
        monkeypatch.chdir(tmp_path / pkg)
        name = "nosuch" if case == "unknown" else "recommendation"
        if case == "not_empty":
            (tmp_path / pkg / "mine" / "keep.txt").write_text("x")
        with pytest.raises(SystemExit) as e:
            _cli_main(pkg)(["template", "get", name, "mine"])
        out[pkg] = (e.value.code, capsys.readouterr().err)
    assert out["port"] == out["reference"]
    assert out["port"][0] == 1


def test_shell_with_piped_stdin(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PIO_STORAGE_")}
    env.update(PIO_HOME=str(tmp_path), PYTHONPATH=str(ROOT),
               JAX_PLATFORMS="cpu")
    script = ("print('LOCALS', sorted(k for k in dir() "
              "if not k.startswith('_')))\n"
              "print('PKG', pio.__name__, type(storage).__name__, "
              "np.arange(3).sum(), config.__name__)\n")
    seen = {}
    for pkg in PKG:
        proc = subprocess.run(
            [sys.executable, "-m", f"{PKG[pkg]}.cli", "shell"], input=script,
            cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=TIMEOUT_S)
        assert proc.returncode == 0, proc.stderr
        # the prompts (">>> ") go to stdout with a piped stdin
        seen[pkg] = {m.group(1): m.group(0) for m in re.finditer(
            r"(LOCALS|PKG) .*", proc.stdout)}
        assert f"{PKG[pkg]} shell" in proc.stderr     # the banner
    assert seen["port"]["LOCALS"] == \
        "LOCALS ['config', 'np', 'pio', 'storage', 'torch']"
    assert seen["reference"]["LOCALS"] == \
        "LOCALS ['config', 'jax', 'jnp', 'np', 'pio', 'storage']"
    assert seen["port"]["PKG"] == \
        "PKG predictionio_tpu_torch Storage 3 predictionio_tpu_torch.config"
    assert seen["reference"]["PKG"] == \
        "PKG predictionio_tpu Storage 3 predictionio_tpu.config"


def _metric_names(base):
    with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
        text = r.read().decode()
    return {ln.split()[2] for ln in text.splitlines()
            if ln.startswith("# TYPE ")}


# The reference's compile tracker (the port has none: eager PyTorch
# compiles nothing).
REFERENCE_ONLY = {"pio_xla_compile_ms", "pio_xla_compile_total"}
INTROSPECTION = {"pio_device_mem_bytes", "pio_device_mem_peak_bytes",
                 "pio_hbm_headroom_warn_total"}


@pytest.mark.parametrize("server", ["engine", "event"])
def test_servers_name_the_same_series_before_the_first_request(
        tmp_path, monkeypatch, server):
    import predictionio_tpu.obs as ref_obs
    import predictionio_tpu_torch.obs as port_obs
    from predictionio_tpu.data.storage import get_storage as jax_storage
    from predictionio_tpu.data.storage import reset_storage
    from predictionio_tpu.server.event_server import EventServer as RefES
    from predictionio_tpu_torch.config import memory_config
    from predictionio_tpu_torch.data.storage import Storage
    from predictionio_tpu_torch.server.event_server import EventServer
    from test_torch_rollout import _port_stack, _ref_stack

    monkeypatch.setenv("PIO_HOME", str(tmp_path / "home"))
    monkeypatch.delenv("PIO_SEGMENTS", raising=False)
    for k in list(os.environ):
        if k.startswith("PIO_STORAGE_"):
            monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_METADATA_SOURCE", "MEMORY")
    monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE", "MEMORY")
    names = {}
    try:
        for pkg, obs in (("reference", ref_obs), ("port", port_obs)):
            if server == "engine":
                stack = _ref_stack() if pkg == "reference" \
                    else _port_stack(tmp_path / "port")
                stack.wf.run_train(stack.eng, stack.variant, stack.ctx)
                obs.get_registry().reset()
                srv = stack.server()
            else:
                obs.get_registry().reset()
                srv = RefES(jax_storage(), host="127.0.0.1", port=0) \
                    if pkg == "reference" else EventServer(
                        Storage(memory_config(tmp_path / "es")),
                        host="127.0.0.1", port=0)
            srv.start()
            try:
                names[pkg] = _metric_names(f"http://127.0.0.1:{srv.port}")
            finally:
                srv.stop()
    finally:
        reset_storage()
    assert INTROSPECTION <= names["port"]
    assert names["port"] == names["reference"] - REFERENCE_ONLY


def test_entry_on_the_cpu_computes_the_reference_forward():
    import __graft_entry__ as graft
    from predictionio_tpu_torch.entry import entry

    forward, args = entry(device="cpu")
    scores, ids = forward(*args)
    ref_forward, ref_args = graft.entry()
    ref_scores, ref_ids = (np.asarray(a) for a in ref_forward(*ref_args))
    assert tuple(scores.shape) == ref_scores.shape == (8, 10)
    assert scores.dtype.is_floating_point and str(ids.dtype) == "torch.int32"
    np.testing.assert_allclose(scores.numpy(), ref_scores, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(ids.numpy(), ref_ids)
    assert args[1].device.type == "cpu"


def _segment_lines(out: str) -> list:
    """`pio status`'s lines from ``segments:`` through ``ingest:``."""
    lines = out.splitlines()
    start = next(i for i, ln in enumerate(lines)
                 if ln.startswith("segments:"))
    end = next(i for i, ln in enumerate(lines) if ln.startswith("ingest:"))
    return lines[start:end + 1]


@pytest.mark.parametrize("segments", ["on", "off"])
def test_status_prints_the_segment_lines_of_the_reference(
        tmp_path, monkeypatch, capsys, segments):
    """One segment root (a directory each package's store wrote, and a
    damaged manifest both skip) and the admission knobs: both CLIs print
    the same ``segments:`` and ``ingest:`` lines."""
    import datetime as dt

    from predictionio_tpu.data import Event as RefEvent
    from predictionio_tpu.data.columnar import SegmentStore as RefStore
    from predictionio_tpu_torch.data.columnar import SegmentStore
    from predictionio_tpu_torch.data.event import Event

    for k in list(os.environ):
        if k.startswith(("PIO_STORAGE_", "PIO_SEGMENT", "PIO_INGEST",
                         "PIO_MAX_BATCH", "PIO_DISK", "PIO_FLEET")):
            monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("PIO_HOME", str(tmp_path / "home"))
    root = tmp_path / "segs"
    monkeypatch.setenv("PIO_SEGMENT_DIR", str(root))
    monkeypatch.setenv("PIO_INGEST_QUEUE_BUDGET", "5000")
    monkeypatch.setenv("PIO_DISK_MIN_FREE_BYTES", "1024")
    t = dt.datetime.now(dt.timezone.utc)
    for store, ev, app in ((RefStore, RefEvent, 1), (SegmentStore, Event, 2)):
        st = store(root, grace_s=0.0)
        st.append_events(app, None, [ev(
            event="view", entity_type="user", entity_id=f"u{k}",
            event_time=t + dt.timedelta(seconds=k)) for k in range(3)])
        st.seal_all()
    (root / "app_3" / "ch_1").mkdir(parents=True)
    (root / "app_3" / "ch_1" / "manifest.json").write_text("{broken")
    if segments == "off":
        monkeypatch.setenv("PIO_SEGMENTS", "off")
    out = {}
    for pkg in PKG:
        assert _cli_main(pkg)(["status"]) == 0
        out[pkg] = _segment_lines(capsys.readouterr().out)
    assert out["port"] == out["reference"]
    if segments == "on":
        assert out["port"][0] == (f"segments: root={root} dirs=2 sealed=2 "
                                  "rows=6")
        assert out["port"][1].startswith("  app_1/default: segments=1 "
                                         "rows=3 bytes=")
    else:
        assert out["port"][0] == "segments: off (PIO_SEGMENTS=off)"
    assert out["port"][-1] == ("ingest: admission budget=5000 max batch=50 "
                               "disk min free bytes=1024")
