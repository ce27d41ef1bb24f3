"""The recommendation loop on a device mesh through the port's ``pio``,
against the reference's (``tests/test_mesh_e2e.py``).

``RuntimeContext`` builds its mesh from ``PIO_MESH``; ``pio train
--mesh data=8 --device cpu`` trains over the 8 CPU shards the test
bootstrap asks for and prints the reference's ``Mesh:`` line; a deploy
over the same mesh row-shards the corpus (``PIO_SERVE_SHARD_ABOVE=0``)
and its plan names the ``sharded`` rung; its answers equal the meshless
train's and the reference CLI's mesh train on the same events (ids
equal except within ties, scores within the training tolerance of
``tests/test_torch_cli.py``).  The engines that refused a mesh before
ROADMAP Queue 1 item 10b train on one like the reference (model level,
against the reference's mesh calls), and the two-tower, DLRM and
classification templates train and serve through ``pio train --mesh``
and a deploy over the mesh as their meshless trains do.
"""

import json
import re
import urllib.request
from pathlib import Path

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


# -- every engine that takes a mesh trains on one like the reference --------------

TT_CFG = dict(n_users=32, n_items=16, embed_dim=8, hidden_dims=(16,),
              out_dim=8, batch_size=64, epochs=2, seed=4)
DLRM_CFG = dict(vocab_sizes=(16, 8), n_dense=3, embed_dim=4,
                bottom_mlp=(8, 4), top_mlp=(8,), epochs=1, batch_size=64,
                seed=3)


def _xy(n=64, d=3, c=4, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, c, n)
    x = rng.poisson(2.0, (n, d)).astype(np.float32) + y[:, None]
    return x, y


def _tt_data(seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 32, 192), rng.integers(0, 16, 192)


def _dlrm_data(n=256, seed=2):
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((n, 3)).astype(np.float32)
    cat = np.stack([rng.integers(0, 16, n), rng.integers(0, 8, n)], axis=1)
    labels = (rng.random(n) < 0.3).astype(np.float32)
    return dense, cat, labels


def _leaves_np(tree):
    from predictionio_tpu_torch.parallel.mesh import ShardedTensor

    import jax

    return [x.to_host() if isinstance(x, ShardedTensor) else np.asarray(x)
            for x in jax.tree.leaves(tree, is_leaf=lambda t: isinstance(
                t, ShardedTensor))]


def _mesh_cases():
    """Each former refusal, now a (port call, reference call, check) on
    the mesh the reference's model needs."""
    from predictionio_tpu.models import dlrm as ref_dlrm
    from predictionio_tpu.models import linear as ref_linear
    from predictionio_tpu.models import naive_bayes as ref_nb
    from predictionio_tpu.models import two_tower as ref_tt
    from predictionio_tpu_torch.models import dlrm, linear, naive_bayes
    from predictionio_tpu_torch.models import two_tower as tt

    x, y = _xy()
    users, items = _tt_data()
    dense, cat, labels = _dlrm_data()

    def close(atol):
        def check(got, want):
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, w, rtol=0, atol=atol)
        return check

    return {
        # the port's meshless bounds against the reference
        # (tests/test_torch_two_tower.py, test_torch_dlrm.py,
        # test_torch_classification.py)
        "two_tower.train": ({"data": 4, "model": 2}, lambda m: _leaves_np(
            tt.train(users, items, tt.TwoTowerConfig(**TT_CFG), mesh=m,
                     data_source="numpy").params), lambda m: _leaves_np(
            ref_tt.train(users, items, ref_tt.TwoTowerConfig(**TT_CFG),
                         mesh=m, data_source="numpy").params), close(1e-3)),
        "two_tower.init_state": ({"data": 2, "model": 4}, lambda m:
            _leaves_np(tt.init_state(tt.TwoTowerConfig(**TT_CFG), m).params),
            lambda m: _leaves_np(ref_tt.init_state(
                ref_tt.TwoTowerConfig(**TT_CFG), m).params), close(1e-6)),
        "dlrm.train": ({"expert": 8}, lambda m: dlrm.predict_proba(
            dlrm.train(dense, cat, labels, dlrm.DLRMConfig(**DLRM_CFG), m,
                       data_source="numpy"), dense, cat,
            dlrm.DLRMConfig(**DLRM_CFG), mesh=m).numpy()[None],
            lambda m: np.asarray(ref_dlrm.predict_proba(
                ref_dlrm.train(dense, cat, labels,
                               ref_dlrm.DLRMConfig(**DLRM_CFG), m,
                               data_source="numpy"), dense, cat,
                ref_dlrm.DLRMConfig(**DLRM_CFG), mesh=m))[None],
            close(2.0 ** -6)),
        "linear.train": ({"data": 8}, lambda m: [
            t.numpy() for t in vars(linear.train(
                x, y, linear.LogisticRegressionConfig(n_classes=4),
                mesh=m, device="cpu")).values()],
            lambda m: [np.asarray(t) for t in vars(ref_linear.train(
                x, y, ref_linear.LogisticRegressionConfig(n_classes=4),
                mesh=m)).values()], close(1e-4)),
        "naive_bayes.train_gaussian": ({"data": 8}, lambda m: [
            naive_bayes.train_gaussian(x, y, 4, mesh=m).means.numpy(),
            naive_bayes.train_gaussian(x, y, 4, mesh=m).variances.numpy()],
            lambda m: [np.asarray(ref_nb.train_gaussian(x, y, 4, mesh=m)
                                  .means),
                       np.asarray(ref_nb.train_gaussian(x, y, 4, mesh=m)
                                  .variances)], close(1e-5)),
        "naive_bayes.train_multinomial": ({"data": 8}, lambda m: [
            naive_bayes.train_multinomial(x, y, 4, mesh=m)
            .feature_log_prob.numpy()],
            lambda m: [np.asarray(ref_nb.train_multinomial(x, y, 4, mesh=m)
                                  .feature_log_prob)], close(1e-5)),
    }


@pytest.mark.parametrize("name", sorted(_mesh_cases()))
def test_trains_on_a_mesh_like_the_reference(name, monkeypatch):
    """The engines that refused a mesh before item 10b: each on the mesh
    its reference model takes, against the reference's call on its own
    8-device mesh, within the port's meshless bound; two port runs are
    equal bit for bit."""
    from predictionio_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from predictionio_tpu_torch.parallel.mesh import make_mesh

    for k in ("PIO_FUSE_STEPS", "PIO_BATCH_AUTOSCALE", "PIO_PREFETCH_DEPTH",
              "PIO_STEP_TIMEOUT_S"):
        monkeypatch.delenv(k, raising=False)
    sizes, port_call, ref_call, check = _mesh_cases()[name]
    mesh = make_mesh(sizes, device="cpu")
    got = port_call(mesh)
    check(got, ref_call(jax_make_mesh(sizes)))
    for a, b in zip(got, port_call(mesh)):
        assert np.array_equal(a, b)


def _engine_events(kind, path):
    """A small JSONL of the engine's events: every user and item seen,
    counts that divide the mesh."""
    rng = np.random.default_rng(11)
    lines = []
    if kind == "twotower":
        for k in range(480):
            u, i = k % 24 if k < 24 else rng.integers(24), \
                k % 16 if k < 16 else rng.integers(16)
            lines.append({"event": "rate", "entityType": "user",
                          "entityId": f"u{u}", "targetEntityType": "item",
                          "targetEntityId": f"i{i}",
                          "properties": {"rating": 4.0}})
    elif kind == "dlrm":
        for k in range(512):
            dense = [round(float(v), 3) for v in rng.standard_normal(4)]
            lines.append({"event": "impression", "entityType": "user",
                          "entityId": f"u{rng.integers(20)}",
                          "targetEntityType": "item",
                          "targetEntityId": f"i{rng.integers(30)}",
                          "properties": {"clicked": bool(dense[0] > 0),
                                         "dense": dense}})
    else:
        for u in range(64):
            plan = float(u % 4)
            lines.append({"event": "$set", "entityType": "user",
                          "entityId": f"u{u}", "properties": {
                              "attr0": float(rng.poisson(2) + plan),
                              "attr1": float(rng.poisson(2)),
                              "attr2": float(rng.poisson(2) + 2 * plan),
                              "plan": plan}})
    with open(path, "w") as f:
        for k, ev in enumerate(lines):
            ev["eventTime"] = f"2026-01-01T00:{k // 60 % 60:02d}:" \
                              f"{k % 60:02d}Z"
            f.write(json.dumps(ev) + "\n")
    return path


ENGINES = {
    # engine: (mesh spec, algorithm params, queries, comparison)
    "twotower": ("data=4,model=2",
                 {"embedDim": 8, "hiddenDims": [16], "outDim": 8,
                  "epochs": 2, "batchSize": 32, "seed": 3},
                 [{"user": f"u{u}", "num": 4} for u in range(6)]),
    "dlrm": ("expert=8",
             {"embedDim": 8, "bottomMlp": [16, 8], "topMlp": [16],
              "epochs": 2, "batchSize": 64, "seed": 3},
             [{"user": f"u{u}", "items": ["i1", "i2", "i3"],
               "dense": [0.5, -1.0, 0.0, 1.0]} for u in range(6)]),
    "classification": ("data=8", None,
                       [{"attr0": float(a), "attr1": 2.0,
                         "attr2": float(2 * a)} for a in range(4)]),
}


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_the_templates_train_and_serve_on_a_mesh(kind, clean_storage,
                                                 tmp_path, capsys):
    """``pio train --mesh`` and a deploy over the same mesh for the
    two-tower, DLRM and classification engines, against the same
    engine's meshless train and deploy: two-tower scores and DLRM
    probabilities within 2^-6 (the templates' train bounds against the
    reference), classification labels equal."""
    from predictionio_tpu_torch.controller import EngineVariant
    from predictionio_tpu_torch.controller import load_engine_factory
    from predictionio_tpu_torch.data.storage import get_storage
    from predictionio_tpu_torch.server.engine_server import EngineServer

    spec_mesh, algo, queries = ENGINES[kind]
    shipped = json.loads((Path(__file__).resolve().parents[1] /
                          "predictionio_tpu_torch" / "templates" / kind /
                          "engine.json").read_text())
    app = shipped["datasource"]["params"]["appName"]
    if kind == "dlrm":
        shipped["datasource"]["params"].update(userVocab=8, itemVocab=8)
    if algo is not None:
        shipped["algorithms"][0]["params"].update(algo)
    ej = tmp_path / "engine.json"
    ej.write_text(json.dumps(shipped))
    assert main(["app", "new", app]) == 0
    src = _engine_events(kind, tmp_path / "ev.jsonl")
    assert main(["import", "--appid", "1", "--input", str(src)]) == 0
    capsys.readouterr()
    out, meshed = _train(ej, capsys, "--mesh", spec_mesh)
    assert "Mesh: " in out
    _, plain = _train(ej, capsys)
    variant = EngineVariant.from_file(ej)
    answers = {}
    for iid, spec in ((meshed, spec_mesh), (plain, None)):
        srv = EngineServer(load_engine_factory(variant.engine_factory)(),
                           variant, get_storage(), device="cpu",
                           mesh_spec=spec, instance_id=iid)
        try:
            answers[spec] = srv.query_batch(queries)
        finally:
            srv.stop()
    for got, want in zip(answers[spec_mesh], answers[None]):
        if kind == "classification":
            assert got == want
            continue
        key = "score"
        gs = [h[key] for h in got["itemScores"]]
        ws = [h[key] for h in want["itemScores"]]
        np.testing.assert_allclose(sorted(gs), sorted(ws), rtol=0,
                                   atol=2.0 ** -6)
