"""The recommendation loop on a device mesh through the port's ``pio``,
against the reference's (``tests/test_mesh_e2e.py``).

``RuntimeContext`` builds its mesh from ``PIO_MESH``; ``pio train
--mesh data=8 --device cpu`` trains over the 8 CPU shards the test
bootstrap asks for and prints the reference's ``Mesh:`` line; a deploy
over the same mesh row-shards the corpus (``PIO_SERVE_SHARD_ABOVE=0``)
and its plan names the ``sharded`` rung; its answers equal the meshless
train's and the reference CLI's mesh train on the same events (ids
equal except within ties, scores within the training tolerance of
``tests/test_torch_cli.py``).  The engines with no mesh path yet refuse
a mesh, naming ROADMAP Queue 1 item 10b.
"""

import json
import re
import urllib.request

import numpy as np
import pytest

from predictionio_tpu_torch.cli.main import main
from tests.test_torch_cli import (
    _agree,
    _clean_env,
    _variant,
    _write_events,
)

USERS = [f"u{u}" for u in range(20)]


@pytest.fixture()
def clean_storage(tmp_path, monkeypatch):
    from predictionio_tpu_torch.data.storage import reset_storage

    home = tmp_path / "pio_home"
    home.mkdir()
    _clean_env(monkeypatch, home)
    monkeypatch.delenv("PIO_MESH", raising=False)
    yield home
    reset_storage()


def _store(tmp_path, capsys, app="meshapp"):
    assert main(["app", "new", app]) == 0
    src = _write_events(tmp_path / "ev.jsonl")
    assert main(["import", "--appid", "1", "--input", str(src)]) == 0
    capsys.readouterr()


def _train(ej, capsys, *extra):
    assert main(["train", "--engine-json", str(ej), "--device", "cpu",
                 *extra]) == 0
    out = capsys.readouterr().out
    return out, re.search(r"Engine instance ID: (\w+)", out).group(1)


def _serve(ej, iid, mesh_spec=None, device="cpu"):
    """Answers of an engine server on ``iid`` (over ``mesh_spec``) to
    every user, and the rung its retriever plans for them."""
    from predictionio_tpu_torch.controller import EngineVariant
    from predictionio_tpu_torch.data.storage import get_storage
    from predictionio_tpu_torch.server.engine_server import EngineServer
    from predictionio_tpu_torch.templates.recommendation import engine

    srv = EngineServer(engine(), EngineVariant.from_file(ej), get_storage(),
                       device=device, mesh_spec=mesh_spec, instance_id=iid)
    try:
        answers = srv.query_batch([{"user": u, "num": 6} for u in USERS])
        model = srv._models[0]
        rung = model.retriever().plan(len(USERS), 6).rung
        return answers, rung, srv
    finally:
        srv.stop()


def test_runtime_context_builds_its_mesh_from_the_env(clean_storage,
                                                      monkeypatch):
    import torch

    from predictionio_tpu_torch.controller import RuntimeContext

    monkeypatch.setenv("PIO_MESH", "data=8")
    ctx = RuntimeContext.create(device="cpu")
    assert ctx.mesh is not None and dict(ctx.mesh.shape) == {"data": 8}
    assert set(ctx.mesh.devices.flat) == {torch.device("cpu")}
    # An explicit spec beats the env; "none" turns the mesh off.
    assert RuntimeContext.create(device="cpu", mesh_spec="none").mesh is None
    assert dict(RuntimeContext.create(
        device="cpu", mesh_spec="data=2").mesh.shape) == {"data": 2}


def test_pio_train_and_deploy_on_a_mesh(clean_storage, capsys, tmp_path,
                                        monkeypatch):
    """The reference's e2e bar: ``pio train --mesh`` then a deploy over
    the mesh answers ``/queries.json``, through the sharded rung, as
    the meshless train's deploy does."""
    from predictionio_tpu_torch.controller import EngineVariant
    from predictionio_tpu_torch.data.storage import get_storage
    from predictionio_tpu_torch.server.engine_server import EngineServer
    from predictionio_tpu_torch.templates.recommendation import engine

    _store(tmp_path, capsys)
    ej = _variant(tmp_path / "engine.json", app="meshapp", rank=8,
                  numIterations=4, seed=3)
    out, meshed = _train(ej, capsys, "--mesh", "data=8")
    assert "Mesh: {'data': 8} over 8 device(s)" in out
    assert "Training completed" in out
    _, plain = _train(ej, capsys)
    monkeypatch.setenv("PIO_SERVE_SHARD_ABOVE", "0")
    monkeypatch.setenv("PIO_SERVE_HOST_MACS", "1")
    got, rung, _ = _serve(ej, meshed, "data=8")
    assert rung == "sharded"
    want, rung, _ = _serve(ej, plain)
    assert rung == "device"
    for g, w in zip(got, want):
        _agree(g, w)
    srv = EngineServer(engine(), EngineVariant.from_file(ej), get_storage(),
                       host="127.0.0.1", port=0, device="cpu",
                       mesh_spec="data=8", instance_id=meshed)
    assert dict(srv.ctx.mesh.shape) == {"data": 8}
    srv.start(block=False)
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/queries.json",
            data=json.dumps({"user": "u0", "num": 6}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            body = json.loads(r.read())
        assert srv._models[0].retriever().sharded
    finally:
        srv.stop()
    _agree(body, got[0])


def _reference_mesh_answers(home, tmp_path, monkeypatch, capsys, **algo):
    """The reference CLI's mesh train on the same events, served over its
    own 8-device mesh."""
    from predictionio_tpu.cli.main import main as jax_main
    from predictionio_tpu.controller import EngineVariant as RefVariant
    from predictionio_tpu.controller import load_engine_factory
    from predictionio_tpu.data.storage import get_storage as jax_storage
    from predictionio_tpu.server import EngineServer as RefServer

    _clean_env(monkeypatch, home)
    src = _write_events(tmp_path / "ev.jsonl")
    ej = _variant(home / "engine.json", app="meshapp",
                  factory="predictionio_tpu.templates.recommendation:engine",
                  **algo)
    for argv in (["app", "new", "meshapp"],
                 ["import", "--appid", "1", "--input", str(src)],
                 ["train", "--engine-json", str(ej), "--mesh", "data=8"]):
        assert jax_main(argv) == 0, argv
    capsys.readouterr()
    variant = RefVariant.from_file(ej)
    srv = RefServer(load_engine_factory(variant.engine_factory)(), variant,
                    jax_storage(), mesh_spec="data=8")
    try:
        return srv.query_batch([{"user": u, "num": 6} for u in USERS])
    finally:
        srv.stop()


@pytest.mark.parametrize("sharding", ["auto", "sharded"])
def test_served_answers_equal_the_reference_cli_on_a_mesh(
        tmp_path, monkeypatch, capsys, sharding):
    """``factorSharding`` through engine.json (``sharded``: blocked ALS)
    in both packages' mesh trains; the port's deploy serves from the
    row-sharded corpus."""
    from predictionio_tpu.data.storage import reset_storage as jax_reset
    from predictionio_tpu_torch.data.storage import reset_storage

    algo = dict(rank=8, numIterations=4, seed=3, factorSharding=sharding)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    monkeypatch.delenv("PIO_MESH", raising=False)
    monkeypatch.setenv("PIO_SERVE_SHARD_ABOVE", "0")
    monkeypatch.setenv("PIO_SERVE_HOST_MACS", "1")
    try:
        want = _reference_mesh_answers(tmp_path / "jax", tmp_path,
                                       monkeypatch, capsys, **algo)
        _clean_env(monkeypatch, tmp_path / "port")
        _store(tmp_path, capsys)
        ej = _variant(tmp_path / "port" / "engine.json", app="meshapp",
                      **algo)
        _, iid = _train(ej, capsys, "--mesh", "data=8")
        got, rung, _ = _serve(ej, iid, "data=8")
        _, plain = _train(ej, capsys)
        meshless, _, _ = _serve(ej, plain)
    finally:
        jax_reset()
        reset_storage()
    assert rung == "sharded"
    assert len(got) == len(want) == len(USERS)
    for g, w, m in zip(got, want, meshless):
        _agree(g, w)
        _agree(g, m)


def test_batchpredict_and_eval_take_the_mesh(clean_storage, capsys,
                                             tmp_path):
    _store(tmp_path, capsys, app="qsapp")
    ej = _variant(tmp_path / "engine.json", rank=4, numIterations=2)
    _train(ej, capsys, "--mesh", "data=2")
    queries = tmp_path / "q.jsonl"
    queries.write_text(json.dumps({"user": "u1", "num": 3}) + "\n")
    out = tmp_path / "p.jsonl"
    assert main(["batchpredict", "--engine-json", str(ej), "--input",
                 str(queries), "--output", str(out), "--device", "cpu",
                 "--mesh", "data=2"]) == 0
    pred = json.loads(out.read_text().splitlines()[0])["prediction"]
    assert len(pred["itemScores"]) == 3
    with pytest.raises(SystemExit) as e:
        main(["deploy", "--engine-json", str(ej), "--device", "cpu",
              "--mesh", "data=16"])
    assert e.value.code == 1
    assert "need 16 devices but 8 are available" in capsys.readouterr().err


# -- the engines with no mesh path yet -------------------------------------------

def _cpu_mesh():
    from predictionio_tpu_torch.parallel.mesh import make_mesh

    return make_mesh({"data": 2}, device="cpu")


def _refusals():
    from predictionio_tpu_torch.models import dlrm, linear, naive_bayes
    from predictionio_tpu_torch.models import two_tower as tt

    x = np.zeros((4, 3), np.float32)
    y = np.array([0, 1, 0, 1])
    ids = np.array([0, 1, 2, 3])
    return {
        "two_tower.train": lambda m: tt.train(
            ids, ids, tt.TwoTowerConfig(n_users=4, n_items=4), mesh=m,
            device="cpu"),
        "two_tower.init_state": lambda m: tt.init_state(
            tt.TwoTowerConfig(n_users=4, n_items=4), m, device="cpu"),
        "dlrm.train": lambda m: dlrm.train(
            x, np.zeros((4, 2), np.int64), y,
            dlrm.DLRMConfig(vocab_sizes=(4, 4), n_dense=3, embed_dim=32), m,
            device="cpu"),
        "linear.train": lambda m: linear.train(
            x, y, linear.LogisticRegressionConfig(n_classes=2), mesh=m,
            device="cpu"),
        "naive_bayes.train_gaussian": lambda m: naive_bayes.train_gaussian(
            x, y, 2, mesh=m, device="cpu"),
        "naive_bayes.train_multinomial":
            lambda m: naive_bayes.train_multinomial(x, y, 2, mesh=m,
                                                    device="cpu"),
    }


@pytest.mark.parametrize("name", sorted(_refusals()))
def test_engines_without_a_mesh_path_refuse_a_mesh(name):
    with pytest.raises(NotImplementedError, match="item 10b"):
        _refusals()[name](_cpu_mesh())
