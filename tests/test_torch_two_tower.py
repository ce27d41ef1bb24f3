"""The port's two-tower model against the reference's.

Small shapes (50 users x 40 items, embed 8, hidden (16,), out 8, batch
16, 2 epochs), inputs made by numpy from a seed, the reference run on
the CPU.  Tolerances, each measured on these inputs:

- init and ``grow_state``'s new rows: within 4 float32 ulps of
  ``jax.random`` (the bound ``tests/test_torch_threefry.py`` holds the
  normals to; the largest gap measured over seeds 0-5 is 3 ulps, from
  the ``log1p`` inside erfinv);
- ``encode_users`` / ``encode_items`` on the reference's carried params:
  1e-5 absolute (bfloat16 towers, float32 sums in another order);
- the loss on one batch with duplicate items and weight-0 pads: 1e-5
  relative; the gradients: one bfloat16 ulp (2^-8) of each leaf's
  largest magnitude (measured: equal bit for bit);
- Adam given the reference's gradients: 1e-7 absolute of
  ``optax.adam``'s update;
- a 2-epoch train from the same init on the same source, from numpy
  and from the feeder: per-step losses within one bfloat16 ulp (2^-8)
  relative, final parameters within one Adam step's largest move (the
  learning rate, 1e-3) and encoded items within one bfloat16 ulp of
  their unit norm (2^-8).  The runs agree to about 1e-7 until a tower
  activation sits on a bfloat16 rounding boundary that the other order
  of float32 summation rounds the other way; the largest gaps measured
  over seeds 1, 2 and 6 are 1.04e-3 (loss), 9.8e-5 (parameters) and
  3.5e-4 (encoded items);
- K=4 fused equals K=1 bit for bit, as does the fused window against
  four ``train_step`` calls.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from predictionio_tpu.models import two_tower as ref
from predictionio_tpu_torch.models import two_tower as port

N_USERS, N_ITEMS, N_ROWS = 50, 40, 400
INIT_ULPS = 4
ENCODE_ATOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_REL = 2.0 ** -8
ADAM_ATOL = 1e-7
TRAIN_LOSS_RTOL = 2.0 ** -8
TRAIN_ATOL = 1e-3
TRAIN_ENCODE_ATOL = 2.0 ** -8


def _cfgs(**kw):
    base = dict(n_users=N_USERS, n_items=N_ITEMS, embed_dim=8,
                hidden_dims=(16,), out_dim=8, batch_size=16, epochs=2,
                seed=3)
    base.update(kw)
    return ref.TwoTowerConfig(**base), port.TwoTowerConfig(**base)


def _data(seed=0, n=N_ROWS):
    rng = np.random.default_rng(seed)
    return rng.integers(0, N_USERS, n), rng.integers(0, N_ITEMS, n)


def _ref_leaves(tree):
    """The reference tree's leaves in the port's :func:`_leaves` order."""
    out = [tree["user_embed"], tree["item_embed"]]
    for tower in ("user_mlp", "item_mlp"):
        for layer in tree[tower]["layers"]:
            out += [layer["w"], layer["b"]]
    return [np.asarray(x) for x in out]


def _np(leaves):
    return [x.detach().cpu().numpy() for x in leaves]


def _carry(tree):
    """A reference params tree as port tensors (same values)."""
    return port._map(lambda a: torch.from_numpy(np.array(a, np.float32)),
                     jax.tree.map(np.asarray, tree))


# -- init -------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 42])
@pytest.mark.parametrize("dims", [(8, (16,), 8), (16, (32, 24), 12)])
def test_init_within_ulps_of_jax(seed, dims):
    embed, hidden, out = dims
    rc, pc = _cfgs(seed=seed, embed_dim=embed, hidden_dims=hidden,
                   out_dim=out)
    want = _ref_leaves(ref.init_params(rc))
    got = _np(port._leaves(port.init_params(pc, "cpu")))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_array_max_ulp(g, w, maxulp=INIT_ULPS)


def test_init_state_mirrors_optax():
    rc, pc = _cfgs()
    st = port.init_state(pc, device="cpu")
    ref_st = ref.init_state(rc)
    adam, empty = st.opt_state
    assert isinstance(adam, port.AdamState) and empty == port.EmptyState()
    assert adam.count == int(ref_st.opt_state[0].count) == 0
    for m in _np(port._leaves(adam.mu)) + _np(port._leaves(adam.nu)):
        assert not m.any()
    assert st.step == 0


def test_grow_state_new_rows_and_moments():
    rc, pc = _cfgs()
    users, items = _data()
    ref_state = ref.train(users, items, rc, data_source="numpy")
    snap = ref.state_to_host(ref_state)
    grown_rc = dataclasses.replace(rc, n_users=N_USERS + 7,
                                   n_items=N_ITEMS + 3)
    grown_pc = dataclasses.replace(pc, n_users=N_USERS + 7,
                                   n_items=N_ITEMS + 3)
    want = ref.grow_state(ref.state_from_host(snap), grown_rc)
    got = port.grow_state(port.state_from_host(snap, "cpu"), grown_pc)
    for g, w in zip(_np(port._leaves(got.params)),
                    _ref_leaves(want.params)):
        assert g.shape == w.shape
        np.testing.assert_array_max_ulp(g, w, maxulp=INIT_ULPS)
    # trained rows and their moments carried exactly; new moments zero
    np.testing.assert_array_equal(
        got.params["user_embed"][:N_USERS].numpy(),
        snap["params"]["user_embed"])
    for g, w in ((got.opt_state[0].mu, want.opt_state[0].mu),
                 (got.opt_state[0].nu, want.opt_state[0].nu)):
        for a, b in zip(_np(port._leaves(g)), _ref_leaves(w)):
            np.testing.assert_array_equal(a, b)
    assert got.step == int(want.step) and \
        got.opt_state[0].count == int(want.opt_state[0].count)
    assert port.grow_state(got, grown_pc).params["user_embed"] is \
        got.params["user_embed"]         # nothing new: unchanged


# -- forward, loss, gradients, Adam -------------------------------------------------

def _batch():
    rng = np.random.default_rng(11)
    u = rng.integers(0, N_USERS, 16).astype(np.int32)
    i = rng.integers(0, N_ITEMS, 16).astype(np.int32)
    i[3] = i[5] = i[9]                   # duplicate items in the batch
    w = np.ones(16, np.float32)
    w[-4:] = 0.0                         # weight-0 tail padding
    u[-4:] = 0
    i[-4:] = 0
    return u, i, w


def test_encode_on_the_reference_params():
    rc, _ = _cfgs()
    users, items = _data(seed=4)
    params = ref.train(users, items, rc, data_source="numpy").params
    carried = _carry(params)
    ids = np.arange(N_USERS)
    np.testing.assert_allclose(
        port.encode_users(carried, ids).numpy(),
        np.asarray(ref.encode_users(params, jnp.asarray(ids))),
        rtol=0, atol=ENCODE_ATOL)
    ids = np.arange(N_ITEMS)
    got = port.encode_items(carried, torch.from_numpy(ids))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(ref.encode_items(params, jnp.asarray(ids))),
        rtol=0, atol=ENCODE_ATOL)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=1), 1.0,
                               atol=1e-5)


def test_loss_and_gradients_match_jax_grad():
    rc, _ = _cfgs()
    params = ref.init_params(rc)
    u, i, w = _batch()
    want_loss, want_grads = jax.value_and_grad(ref._loss)(
        params, jnp.asarray(u), jnp.asarray(i), jnp.asarray(w),
        rc.temperature)
    carried = _carry(params)
    leaves = [p.requires_grad_(True) for p in port._leaves(carried)]
    loss = port._loss(port._unflatten(carried, leaves), torch.from_numpy(u),
                      torch.from_numpy(i), torch.from_numpy(w),
                      rc.temperature)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(want_loss)) <= \
        LOSS_RTOL * abs(float(want_loss))
    for g, want in zip(_np(grads), _ref_leaves(want_grads)):
        np.testing.assert_allclose(
            g, want, rtol=0, atol=GRAD_REL * float(np.abs(want).max()))
    # the pad rows carry no gradient into their (item 0) embedding row
    # beyond what real rows put there: a batch with the pads dropped
    # gives the same loss
    keep = w > 0
    loss_kept = port._loss(carried, torch.from_numpy(u[keep]),
                           torch.from_numpy(i[keep]),
                           torch.from_numpy(w[keep]), rc.temperature)
    np.testing.assert_allclose(float(loss_kept), float(loss.detach()),
                               rtol=1e-6)


def test_eval_loss_matches():
    rc, pc = _cfgs()
    params = ref.init_params(rc)
    u, i = _data(seed=5, n=64)
    want = ref.eval_loss(params, u, i, rc)
    got = port.eval_loss(_carry(params), u, i, pc)
    assert abs(got - want) <= LOSS_RTOL * abs(want)


def test_adam_equals_optax_given_the_reference_gradients():
    rc, pc = _cfgs(learning_rate=3e-3)
    params = ref.init_params(rc)
    tx = optax.adam(rc.learning_rate)
    opt = tx.init(params)
    state = port.init_state(pc, device="cpu")
    state = port.TwoTowerState(_carry(params), state.opt_state, 0)
    rng = np.random.default_rng(2)
    for step in range(3):
        grads = jax.tree.map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape)
                                  .astype(np.float32)), params)
        updates, opt = tx.update(grads, opt, params)
        params = optax.apply_updates(params, updates)
        new, adam = port._adam(
            port._leaves(state.params),
            [torch.from_numpy(np.array(g)) for g in
             _ref_leaves(grads)], state.opt_state[0], pc.learning_rate)
        state = port.TwoTowerState(port._unflatten(state.params, new),
                                   (adam, port.EmptyState()), step + 1)
        for g, w in zip(_np(new), _ref_leaves(params)):
            np.testing.assert_allclose(g, w, rtol=0, atol=ADAM_ATOL)
        for g, w in zip(_np(port._leaves(adam.mu)), _ref_leaves(opt[0].mu)):
            np.testing.assert_allclose(g, w, rtol=0, atol=ADAM_ATOL)
        assert adam.count == int(opt[0].count) == step + 1


# -- training -------------------------------------------------------------------------

def _recorded(mod, monkeypatch):
    losses = []
    real = mod.train_step

    def recording(*a):
        s, loss = real(*a)
        losses.append(float(loss))
        return s, loss

    monkeypatch.setattr(mod, "train_step", recording)
    return losses


@pytest.mark.parametrize("source", ["numpy", "feeder"])
def test_two_epochs_match_the_reference(source, monkeypatch):
    rc, pc = _cfgs()
    users, items = _data(seed=6)
    ref_losses = _recorded(ref, monkeypatch)
    want = ref.train(users, items, rc, data_source=source)
    port_losses = _recorded(port, monkeypatch)
    got = port.train(users, items, pc, data_source=source, device="cpu")
    assert len(port_losses) == len(ref_losses) == 2 * N_ROWS // 16
    np.testing.assert_allclose(port_losses, ref_losses,
                               rtol=TRAIN_LOSS_RTOL)
    assert got.step == int(want.step)
    for g, w in zip(_np(port._leaves(got.params)),
                    _ref_leaves(want.params)):
        np.testing.assert_allclose(g, w, rtol=0, atol=TRAIN_ATOL)
    ids = np.arange(N_ITEMS)
    np.testing.assert_allclose(
        port.encode_items(got.params, ids).numpy(),
        np.asarray(ref.encode_items(want.params, jnp.asarray(ids))),
        rtol=0, atol=TRAIN_ENCODE_ATOL)


def test_auto_source_is_the_feeder():
    _, pc = _cfgs()
    users, items = _data(seed=7)
    auto = port.train(users, items, pc, device="cpu")
    feeder = port.train(users, items, pc, data_source="feeder",
                        device="cpu")
    numpy_ = port.train(users, items, pc, data_source="numpy",
                        device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(port._leaves(auto.params), port._leaves(feeder.params)))
    assert not torch.equal(auto.params["user_embed"],
                           numpy_.params["user_embed"])


def test_a_failed_feeder_build_raises(monkeypatch):
    import predictionio_tpu_torch.native.build as build

    def broken(name, build_dir=None):
        raise RuntimeError(f"g++ failed for {name}.cc (exit 1):\nboom")

    monkeypatch.setattr(build, "load_library", broken)
    _, pc = _cfgs()
    users, items = _data()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for feeder"):
        port.train(users, items, pc, device="cpu")


def test_k4_fused_equals_k1_bit_for_bit():
    _, pc = _cfgs()
    users, items = _data(seed=8)
    for source in ("numpy", "feeder"):
        a = port.train(users, items, pc, data_source=source, fuse_steps=1,
                       device="cpu")
        b = port.train(users, items, pc, data_source=source, fuse_steps=4,
                       device="cpu")
        for x, y in zip(
                port._leaves(a.params) + port._leaves(a.opt_state[0].mu)
                + port._leaves(a.opt_state[0].nu),
                port._leaves(b.params) + port._leaves(b.opt_state[0].mu)
                + port._leaves(b.opt_state[0].nu)):
            assert torch.equal(x, y)
        assert (a.step, a.opt_state[0].count) == \
            (b.step, b.opt_state[0].count)


def test_fused_window_equals_sequential_steps():
    _, pc = _cfgs()
    rng = np.random.default_rng(0)
    k, bs = 4, pc.batch_size
    u = torch.from_numpy(rng.integers(0, N_USERS, (k, bs)).astype(np.int32))
    i = torch.from_numpy(rng.integers(0, N_ITEMS, (k, bs)).astype(np.int32))
    w = torch.ones((k, bs))
    seq = port.init_state(pc, device="cpu")
    losses = []
    for j in range(k):
        seq, loss = port.train_step(seq, u[j], i[j], w[j], pc)
        losses.append(loss)
    fused, fl = port.train_steps_fused(port.init_state(pc, device="cpu"),
                                       u, i, w, pc)
    assert fl.shape == (k,) and torch.equal(fl, torch.stack(losses))
    for x, y in zip(port._leaves(seq.params), port._leaves(fused.params)):
        assert torch.equal(x, y)


def test_a_step_leaves_its_input_state_untouched():
    _, pc = _cfgs()
    st = port.init_state(pc, device="cpu")
    before = [x.clone() for x in port._leaves(st.params)]
    u, i, w = _batch()
    new, _ = port.train_step(st, torch.from_numpy(u), torch.from_numpy(i),
                             torch.from_numpy(w), pc)
    assert all(torch.equal(a, b)
               for a, b in zip(before, port._leaves(st.params)))
    assert new.step == 1 and st.step == 0


# -- carrying a generation across packages ----------------------------------------

def test_state_round_trips_within_the_port():
    _, pc = _cfgs()
    users, items = _data(seed=9)
    st = port.train(users, items, pc, data_source="numpy", device="cpu")
    snap = port.state_to_host(st)
    assert snap["step"].dtype == np.int32 and \
        snap["opt_state"][0].count.dtype == np.int32
    back = port.state_from_host(snap, "cpu")
    for x, y in zip(port._leaves(st.params), port._leaves(back.params)):
        assert torch.equal(x, y)
    assert (back.step, back.opt_state[0].count) == (st.step, st.step)


def test_state_carries_between_the_packages():
    """The reference's snapshot continues in the port, and the port's in
    the reference, each within the train tolerance of continuing at
    home."""
    rc, pc = _cfgs(epochs=1)
    users, items = _data(seed=10)
    ref_snap = ref.state_to_host(ref.train(users, items, rc,
                                           data_source="numpy"))
    home = ref.train(users, items, rc, data_source="numpy",
                     warm_state=ref.state_from_host(ref_snap))
    away = port.train(users, items, pc, data_source="numpy", device="cpu",
                      warm_state=port.state_from_host(ref_snap, "cpu"))
    for g, w in zip(_np(port._leaves(away.params)),
                    _ref_leaves(home.params)):
        np.testing.assert_allclose(g, w, rtol=0, atol=TRAIN_ATOL)
    port_snap = port.state_to_host(away)
    cont = ref.train(users, items, rc, data_source="numpy",
                     warm_state=ref.state_from_host(port_snap))
    assert int(cont.step) == 3 * N_ROWS // 16
    assert np.isfinite(np.asarray(cont.params["item_embed"])).all()


# -- retrieval ----------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [None, 16])
def test_retrieve_matches_the_reference(chunk):
    rc, _ = _cfgs()
    users, items = _data(seed=12)
    params = ref.train(users, items, rc, data_source="numpy").params
    ids = np.arange(10)
    ws, wi = ref.retrieve(params, jnp.asarray(ids), N_ITEMS, 5, chunk=chunk)
    gs, gi = port.retrieve(_carry(params), ids, N_ITEMS, 5, chunk=chunk)
    assert gi.dtype == torch.int32 and gs.shape == (10, 5)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=0,
                               atol=ENCODE_ATOL)
    ws, wi = np.asarray(ws), np.asarray(wi)
    for row in range(10):
        for j in range(5):
            if gi[row, j] != wi[row, j]:     # only within a tie
                assert abs(ws[row, j] - gs[row, j].item()) <= 2 * ENCODE_ATOL


def _two_processes(axis):
    """A mesh whose first position another process drives: processes out
    of rank order, a layout a gang does not take."""
    from predictionio_tpu_torch.parallel.mesh import Mesh

    cpu = torch.device("cpu")
    return Mesh(np.array([cpu, cpu], dtype=object), (axis,),
                np.array([1, 0]))


def test_mesh_is_not_ported():
    """Across processes: a mesh that spans processes in another layout
    than the gang's (``data`` split over them in rank order) is refused;
    one process's mesh trains (tests/test_torch_mesh_models.py), and so
    does a gang's (tests/test_torch_gang_models.py)."""
    _, pc = _cfgs()
    with pytest.raises(ValueError, match="first axis"):
        port.train(*_data(), pc, mesh=_two_processes("data"), device="cpu")
    with pytest.raises(ValueError, match="data_source"):
        port.train(*_data(), pc, data_source="parquet", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port.init_state(pc)
