"""The port's deep models and the classification models on a device
mesh, against the reference's on its own mesh.

The reference runs on the 8 virtual CPU devices of ``tests/conftest.py``;
the port on 8 CPU positions (``make_mesh(device="cpu")`` reads the same
setting).  Both take the same seeded numpy inputs.  Tolerances:

- two-tower (``tests/test_two_tower.py:63``'s config, ``data=4 x
  model=2``): per-step losses within one bfloat16 ulp (2^-8) relative,
  tables within one Adam step (the learning rate, 1e-3) and encoded items
  within 2^-8 — the port's meshless bounds against the reference
  (``tests/test_torch_two_tower.py``); measured: 9e-8 on the tables;
- DLRM (``tests/test_dlrm.py:18, 58``'s configs, ``expert=8``): the
  sharded lookup equal to the reference's bit for bit (each row one
  shard's row plus exact zeros); one step's loss within 1e-5 relative
  and its parameters within 1e-5; a 1-epoch train's probabilities
  within 2^-6 (``tests/test_torch_dlrm.py``'s train bound);
- the reference's sharded state carried in by ``state_from_host`` equal
  bit for bit, laid out as the reference's ``param_shardings``;
- two mesh trains of the port from the same inputs ``torch.equal``, a
  K=4 fused one too, and a resumed one equal to an uninterrupted one;
- ``dryrun_multichip(8, device="cpu")`` passes;
- the two-tower template's serving mesh: the reference's trained model
  carried in, served by the port over ``data=8`` through the
  ``sharded`` rung, answers as the reference's server over its mesh:
  ids equal except within a tie, scores within 1e-5;
- training on a mesh that spans processes in another layout than the
  gang's is refused (a gang's trains: ``tests/test_torch_gang_models.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.models import dlrm as ref_dlrm
from predictionio_tpu.models import two_tower as ref_tt
from predictionio_tpu.parallel.mesh import make_mesh as jax_make_mesh
from predictionio_tpu_torch.models import dlrm
from predictionio_tpu_torch.models import two_tower as tt
from predictionio_tpu_torch.parallel.mesh import (
    Mesh,
    PartitionSpec,
    ShardedTensor,
    make_mesh,
    put_sharded,
)

CPU = torch.device("cpu")
TT_LOSS_RTOL = 2.0 ** -8
TT_ATOL = 1e-3
TT_ENCODE_ATOL = 2.0 ** -8
DLRM_LOSS_RTOL = 1e-5
DLRM_STEP_ATOL = 1e-5
DLRM_TRAIN_ATOL = 2.0 ** -6
SERVE_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _unfused(monkeypatch):
    """K from the caller only (the CLI sets these in-process)."""
    for k in ("PIO_FUSE_STEPS", "PIO_BATCH_AUTOSCALE", "PIO_PREFETCH_DEPTH",
              "PIO_STEP_TIMEOUT_S"):
        monkeypatch.delenv(k, raising=False)


def _clique(n_users=32, n_items=16, per_user=6, seed=3):
    """``tests/test_two_tower.py``'s data: even users with even items."""
    rng = np.random.default_rng(seed)
    users, items = [], []
    for u in range(n_users):
        pool = [i for i in range(n_items) if i % 2 == u % 2]
        for i in rng.choice(pool, size=per_user, replace=True):
            users.append(u)
            items.append(int(i))
    return np.array(users), np.array(items)


TT_CFG = dict(n_users=32, n_items=16, embed_dim=8, hidden_dims=(16,),
              out_dim=8, batch_size=64, epochs=2, seed=4)


def _ctr(n=512, seed=2):
    """``tests/test_dlrm.py``'s data: one field and one dense feature
    carry the signal."""
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((n, 4)).astype(np.float32)
    cat = np.stack([rng.integers(0, 16, n), rng.integers(0, 8, n)], axis=1)
    logit = (cat[:, 0] % 2) * 2.0 - 1.0 + dense[:, 0]
    labels = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    return dense, cat, labels


DLRM_CFG = dict(vocab_sizes=(16, 8), n_dense=4, embed_dim=4,
                bottom_mlp=(8, 4), top_mlp=(8,), epochs=1, batch_size=128,
                seed=3)


def _meshes(sizes):
    return jax_make_mesh(sizes), make_mesh(sizes, device="cpu")


def _recorded(mod, monkeypatch):
    losses = []
    real = mod.train_step

    def recording(*a):
        s, loss = real(*a)
        losses.append(float(loss))
        return s, loss

    monkeypatch.setattr(mod, "train_step", recording)
    return losses


def _host_leaves(leaves, tree):
    return [x.to_host() if isinstance(x, ShardedTensor)
            else np.asarray(x) for x in leaves(tree)]


# -- two-tower ----------------------------------------------------------------

def test_two_tower_mesh_train_matches_the_reference_mesh_train(monkeypatch):
    jmesh, mesh = _meshes({"data": 4, "model": 2})
    users, items = _clique()
    want_losses = _recorded(ref_tt, monkeypatch)
    want = ref_tt.train(users, items, ref_tt.TwoTowerConfig(**TT_CFG),
                        mesh=jmesh, data_source="numpy")
    got_losses = _recorded(tt, monkeypatch)
    got = tt.train(users, items, tt.TwoTowerConfig(**TT_CFG), mesh=mesh,
                   data_source="numpy")
    assert len(got_losses) == len(want_losses) > 0
    np.testing.assert_allclose(got_losses, want_losses, rtol=TT_LOSS_RTOL)
    assert isinstance(got.params["user_embed"], ShardedTensor)
    assert tuple(got.params["user_embed"].spec) == ("model", None)
    for name in ("user_embed", "item_embed"):
        np.testing.assert_allclose(got.params[name].to_host(),
                                   np.asarray(want.params[name]), rtol=0,
                                   atol=TT_ATOL)
    ids = np.arange(TT_CFG["n_items"])
    np.testing.assert_allclose(
        tt.encode_items(got.params, ids).numpy(),
        np.asarray(ref_tt.encode_items(want.params, jnp.asarray(ids))),
        rtol=0, atol=TT_ENCODE_ATOL)


def test_two_tower_mesh_step_matches_the_reference_step():
    """``__graft_entry__.dryrun_multichip``'s DP + TP step: the loss
    within 1e-5 / 1e-6 and the user table within 1e-5 / 1e-6 of the
    reference's mesh step."""
    jmesh, mesh = _meshes({"data": 4, "model": 2})
    cfg = dict(n_users=64, n_items=32, embed_dim=16, hidden_dims=(32,),
               out_dim=16, batch_size=16, seed=0)
    rng = np.random.default_rng(0)
    u = rng.integers(0, 64, 16).astype(np.int32)
    i = rng.integers(0, 32, 16).astype(np.int32)
    w = np.ones(16, np.float32)
    jcfg = ref_tt.TwoTowerConfig(**cfg)
    jstate, jloss = ref_tt.train_step(ref_tt.init_state(jcfg, jmesh),
                                      jnp.asarray(u), jnp.asarray(i),
                                      jnp.asarray(w), jcfg)
    pcfg = tt.TwoTowerConfig(**cfg)
    state, loss = tt.train_step(
        tt.init_state(pcfg, mesh),
        *(put_sharded(a, mesh, PartitionSpec("data")) for a in (u, i, w)),
        pcfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(state.params["user_embed"].to_host(),
                               np.asarray(jstate.params["user_embed"]),
                               rtol=1e-5, atol=1e-6)


def test_two_tower_state_from_host_takes_the_reference_sharded_state():
    jmesh, mesh = _meshes({"data": 4, "model": 2})
    cfg = dict(TT_CFG, n_users=40, n_items=24)
    jstate = ref_tt.init_state(ref_tt.TwoTowerConfig(**cfg), jmesh)
    snap = ref_tt.state_to_host(jstate)
    state = tt.state_from_host(snap, mesh=mesh)
    shardings = tt.param_shardings(tt.TwoTowerConfig(**cfg), mesh)
    for got, sh, want in zip(tt._leaves(state.params),
                             tt._leaves(shardings),
                             tt._leaves(snap["params"])):
        assert tuple(got.spec) == tuple(sh.spec)
        np.testing.assert_array_equal(got.to_host(), want)
    for name in ("user_embed", "item_embed"):
        assert tuple(jstate.params[name].sharding.spec) == \
            tuple(state.params[name].spec)
    back = tt.state_to_host(state)
    np.testing.assert_array_equal(back["params"]["user_embed"],
                                  snap["params"]["user_embed"])


def test_two_tower_mesh_trains_are_equal_run_to_run_and_fused():
    mesh = make_mesh({"data": 4, "model": 2}, device="cpu")
    users, items = _clique(seed=5)
    cfg = tt.TwoTowerConfig(**TT_CFG)
    runs = [tt.train(users, items, cfg, mesh=mesh, data_source="numpy",
                     fuse_steps=k) for k in (1, 1, 4)]
    first = _host_leaves(tt._leaves, runs[0].params)
    for other in runs[1:]:
        for a, b in zip(first, _host_leaves(tt._leaves, other.params)):
            assert np.array_equal(a, b)
        assert other.step == runs[0].step


def test_two_tower_mesh_resume_equals_the_uninterrupted_train(tmp_path,
                                                              monkeypatch):
    """A mesh train's checkpoints hold each block with its spec; a train
    killed mid-run resumes onto the same layout, bit for bit."""
    mesh = make_mesh({"data": 4, "model": 2}, device="cpu")
    users, items = _clique(seed=6)
    cfg = tt.TwoTowerConfig(**TT_CFG)
    want = tt.train(users, items, cfg, mesh=mesh, data_source="numpy")
    real = tt.train_step
    calls = [0]

    def dying(*a):
        calls[0] += 1
        if calls[0] == 4:
            raise RuntimeError("killed")
        return real(*a)

    monkeypatch.setattr(tt, "train_step", dying)
    with pytest.raises(RuntimeError, match="killed"):
        tt.train(users, items, cfg, mesh=mesh, data_source="numpy",
                 checkpoint_dir=tmp_path, save_every=2)
    monkeypatch.setattr(tt, "train_step", real)
    got = tt.train(users, items, cfg, mesh=mesh, data_source="numpy",
                   checkpoint_dir=tmp_path, save_every=2)
    for a, b in zip(_host_leaves(tt._leaves, got.params),
                    _host_leaves(tt._leaves, want.params)):
        assert np.array_equal(a, b)


# -- DLRM ----------------------------------------------------------------------

def test_sharded_embedding_lookup_matches_the_reference():
    jmesh, mesh = _meshes({"expert": 8})
    rng = np.random.default_rng(0)
    table = rng.standard_normal((64, 4)).astype(np.float32)
    idx = rng.integers(0, 64, (16, 3)).astype(np.int32)
    want = np.asarray(ref_dlrm.sharded_embedding_lookup(
        jmesh, jnp.asarray(table), jnp.asarray(idx)))
    got = dlrm.sharded_embedding_lookup(mesh, torch.from_numpy(table),
                                        torch.from_numpy(idx))
    assert tuple(got.spec) == ("expert", None, None)
    np.testing.assert_array_equal(got.full().numpy(), want)
    np.testing.assert_array_equal(got.full().numpy(), table[idx])


def test_the_lookup_asks_for_a_padded_vocab():
    mesh = make_mesh({"expert": 8}, device="cpu")
    with pytest.raises(AssertionError, match="pad vocab"):
        dlrm.sharded_embedding_lookup(mesh, torch.zeros(60, 4),
                                      torch.zeros(8, 1, dtype=torch.int32))


def test_dlrm_mesh_step_matches_the_reference_step():
    jmesh, mesh = _meshes({"expert": 8})
    dense, cat, labels = _ctr()
    b = DLRM_CFG["batch_size"]
    jcfg = ref_dlrm.DLRMConfig(**DLRM_CFG)
    pcfg = dlrm.DLRMConfig(**DLRM_CFG)
    rows = (cat[:b] + jcfg.offsets[None, :]).astype(np.int32)
    batch = (dense[:b], rows, labels[:b], np.ones(b, np.float32))
    jstate, jloss = ref_dlrm.train_step(
        ref_dlrm.init_state(jcfg, jmesh), *map(jnp.asarray, batch), jcfg,
        jmesh)
    state, loss = dlrm.train_step(
        dlrm.init_state(pcfg, mesh),
        *(put_sharded(a, mesh, PartitionSpec("expert")) for a in batch),
        pcfg, mesh)
    np.testing.assert_allclose(float(loss), float(jloss),
                               rtol=DLRM_LOSS_RTOL)
    for got, want in zip(_host_leaves(dlrm._leaves, state.params),
                         _host_leaves(dlrm._leaves, jstate.params)):
        np.testing.assert_allclose(got, want, rtol=0, atol=DLRM_STEP_ATOL)


def test_dlrm_mesh_train_matches_the_reference_mesh_train():
    jmesh, mesh = _meshes({"expert": 8})
    dense, cat, labels = _ctr()
    want = ref_dlrm.train(dense, cat, labels,
                          ref_dlrm.DLRMConfig(**DLRM_CFG), jmesh,
                          data_source="numpy")
    cfg = dlrm.DLRMConfig(**DLRM_CFG)
    got = dlrm.train(dense, cat, labels, cfg, mesh, data_source="numpy")
    again = dlrm.train(dense, cat, labels, cfg, mesh, data_source="numpy")
    for a, b in zip(_host_leaves(dlrm._leaves, got.params),
                    _host_leaves(dlrm._leaves, again.params)):
        assert np.array_equal(a, b)
    p_want = np.asarray(ref_dlrm.predict_proba(
        want, dense[:64], cat[:64], ref_dlrm.DLRMConfig(**DLRM_CFG),
        mesh=jmesh))
    p_got = dlrm.predict_proba(got, dense[:64], cat[:64], cfg,
                               mesh=mesh).numpy()
    np.testing.assert_allclose(p_got, p_want, rtol=0, atol=DLRM_TRAIN_ATOL)
    # served without the mesh (the template's pickled state): gathered
    np.testing.assert_array_equal(
        dlrm.predict_proba(got, dense[:64], cat[:64], cfg).numpy(), p_got)


def test_dlrm_state_from_host_takes_the_reference_sharded_state():
    jmesh, mesh = _meshes({"expert": 8})
    jstate = ref_dlrm.init_state(ref_dlrm.DLRMConfig(**DLRM_CFG), jmesh)
    snap = jax.tree.map(np.asarray, (jstate.params, jstate.opt_state,
                                     jstate.step))
    state = dlrm.state_from_host(snap, mesh=mesh)
    assert tuple(state.params["embed"].spec) == ("expert", None)
    assert tuple(jstate.params["embed"].sharding.spec) == ("expert", None)
    for got, want in zip(_host_leaves(dlrm._leaves, state.params),
                         _host_leaves(dlrm._leaves, snap[0])):
        np.testing.assert_array_equal(got, want)


# -- the multi-chip dry run, serving, processes ------------------------------------

def test_dryrun_multichip_on_eight_cpu_positions():
    from predictionio_tpu_torch.entry import dryrun_multichip

    gaps = dryrun_multichip(8, device="cpu")
    assert set(gaps) == {"two_tower_loss", "two_tower_user_embed",
                         "dlrm_loss", "ring_attention", "als_replicated",
                         "als_sharded", "als_windowed",
                         "als_windowed_vs_meshless"}


def test_two_tower_serving_mesh_answers_as_the_reference(tmp_path,
                                                         monkeypatch):
    """The reference's trained generation carried into the port, served
    over ``data=8`` with the corpus sharded, against the reference's
    server over its own 8-device mesh."""
    from predictionio_tpu.controller import EngineVariant as JaxVariant
    from predictionio_tpu.controller import RuntimeContext as JaxContext
    from predictionio_tpu.data.storage import reset_storage as jax_reset
    from predictionio_tpu.server.engine_server import (
        EngineServer as JaxServer,
    )
    from predictionio_tpu.templates.twotower import engine as jax_engine
    from predictionio_tpu.workflow.core_workflow import (
        load_models as jax_load_models,
    )
    from predictionio_tpu.workflow.core_workflow import (
        run_train as jax_run_train,
    )
    from predictionio_tpu_torch.config import memory_config
    from predictionio_tpu_torch.controller import EngineVariant
    from predictionio_tpu_torch.data.storage import Storage
    from predictionio_tpu_torch.server.engine_server import EngineServer
    from predictionio_tpu_torch.templates.twotower import (
        engine,
        model_from_numpy,
    )
    from predictionio_tpu_torch.workflow.core_workflow import (
        persist_instance,
    )
    from tests.test_torch_twotower_template import (
        JaxApp,
        JaxDataMap,
        JaxEvent,
        PORT_SHIPPED,
        SHIPPED,
        _agree,
        _insert,
        _queries,
        _rows,
        _spec,
    )

    monkeypatch.setenv("PIO_HOME", str(tmp_path))
    for k in ("PIO_RETRIEVAL_RUNG", "PIO_MESH", "PIO_IVF", "PIO_PQ"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_METADATA_SOURCE", "MEMORY")
    monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE", "MEMORY")
    monkeypatch.setenv("PIO_SERVE_SHARD_ABOVE", "0")
    monkeypatch.setenv("PIO_SERVE_HOST_MACS", "1")
    monkeypatch.setenv("PIO_RESULT_CACHE", "0")
    jax_reset()
    try:
        jctx = JaxContext.create()
        _insert(jctx.storage, JaxApp, JaxEvent, JaxDataMap, _rows())
        jeng = jax_engine()
        jvariant = JaxVariant.from_dict(_spec(SHIPPED))
        jiid = jax_run_train(jeng, jvariant, jctx)
        [jmodel] = jax_load_models(
            jeng, jctx.storage.get_engine_instances().get(jiid), jctx)
        jsrv = JaxServer(jeng, jvariant, jctx.storage, mesh_spec="data=8")
        want = jsrv.query_batch(_queries())
        jsrv.stop()
    finally:
        jax_reset()
    storage = Storage(memory_config(tmp_path / "port"))
    variant = EngineVariant.from_dict(_spec(PORT_SHIPPED))
    persist_instance(engine(), variant, [model_from_numpy(
        jmodel.user_vecs, jmodel.item_vecs, jmodel.user_index,
        jmodel.item_index)], storage)
    srv = EngineServer(engine(), variant, storage, device="cpu",
                       mesh_spec="data=8")
    try:
        got = srv.query_batch(_queries())
        retriever = srv._models[0].retriever()
        assert retriever.sharded
        assert retriever.plan(len(_queries()), 4).rung == "sharded"
    finally:
        srv.stop()
    for g, w in zip(got, want):
        _agree(g, w, 0.0, SERVE_ATOL)


@pytest.mark.parametrize("kind", ["two_tower", "dlrm"])
def test_training_on_a_mesh_across_processes_is_refused(kind):
    axis = "data" if kind == "two_tower" else "expert"
    two = Mesh(np.array([CPU, CPU], dtype=object), (axis,),
               np.array([1, 0]))
    if kind == "two_tower":
        users, items = _clique()
        call = lambda: tt.train(users, items,  # noqa: E731
                                tt.TwoTowerConfig(**TT_CFG), mesh=two)
    else:
        dense, cat, labels = _ctr()
        call = lambda: dlrm.train(dense, cat, labels,  # noqa: E731
                                  dlrm.DLRMConfig(**DLRM_CFG), two)
    with pytest.raises(ValueError, match="first axis"):
        call()


# -- the mesh's own surfaces --------------------------------------------------

def test_a_spec_naming_an_axis_the_mesh_lacks_raises_as_jax_does():
    from jax.sharding import NamedSharding as JaxNamedSharding
    from jax.sharding import PartitionSpec as JaxSpec

    from predictionio_tpu_torch.parallel.mesh import NamedSharding

    jmesh, mesh = _meshes({"data": 8})
    with pytest.raises(ValueError) as want:
        JaxNamedSharding(jmesh, JaxSpec("model", None))
    with pytest.raises(ValueError) as got:
        NamedSharding(mesh, PartitionSpec("model", None))
    assert str(got.value).split(" of ")[0] == \
        str(want.value).split(" of ")[0] == "Resource axis: model"
    with pytest.raises(ValueError, match="Resource axis: model"):
        tt.init_state(tt.TwoTowerConfig(**TT_CFG), mesh)


def test_pio_mesh_devices_lays_a_cli_mesh_over_named_devices(monkeypatch):
    from predictionio_tpu_torch.controller import RuntimeContext

    monkeypatch.setenv("PIO_MESH_DEVICES", ",".join(["cpu"] * 12))
    ctx = RuntimeContext.create(device="cpu", mesh_spec="data=12")
    assert dict(ctx.mesh.shape) == {"data": 12}
    assert list(ctx.mesh.devices.flat) == [CPU] * 12
    monkeypatch.setenv("PIO_MESH_DEVICES", "cpu,cuda:0")
    with pytest.raises(ValueError, match="not cpu devices"):
        RuntimeContext.create(device="cpu", mesh_spec="data=2")


def test_a_checkpoint_restores_onto_the_layout_it_was_saved_from(tmp_path):
    from predictionio_tpu_torch.workflow.checkpoint import TrainCheckpointer

    mesh = make_mesh({"data": 4}, device="cpu")
    x = put_sharded(np.arange(16, dtype=np.float32).reshape(8, 2), mesh,
                    PartitionSpec("data"))
    rep = put_sharded(np.ones(3, np.float32), mesh, PartitionSpec())
    ck = TrainCheckpointer(tmp_path, save_every=1, fingerprint="f")
    ck.save(1, {"x": x, "rep": rep, "step": 1})
    ck = TrainCheckpointer(tmp_path, save_every=1, fingerprint="f")
    assert ck.restore_step({"x": x, "rep": rep, "step": 0}) == 1
    got = ck.restored_state
    np.testing.assert_array_equal(got["x"].to_host(), x.to_host())
    assert tuple(got["x"].spec) == ("data",)
    assert all(t is got["rep"].shards[0] for t in got["rep"].shards)
    other = put_sharded(np.zeros((8, 2), np.float32), mesh, PartitionSpec())
    ck = TrainCheckpointer(tmp_path, save_every=1, fingerprint="f")
    with pytest.raises(ValueError, match="laid out"):
        ck.restore_step({"x": other, "rep": rep, "step": 0})
