"""The port's DLRM model against the reference's.

Small shapes (vocabularies 48 and 32, 4 dense features, embed 8, bottom
(16, 8), top (16, 8), batch 32, 400 rows x 2 epochs), inputs made by
numpy from a seed, the reference run on the CPU.  Tolerances, each
measured on these inputs:

- init: within 4 float32 ulps of ``jax.random`` (the bound
  ``tests/test_torch_threefry.py`` holds the normals to; 3 measured);
- the loss of one batch with duplicate rows and weight-0 pads: 1e-5
  relative (measured 1 ulp: XLA's ``exp``/``log1p`` inside the
  log-sigmoid are its own approximations); the gradients: 1e-5 of each
  leaf's largest magnitude (measured: the MLP weights' equal bit for
  bit, the embedding's and one bias's within 6e-8 relative — float32
  sums of the interaction in another order);
- one Adagrad update: the accumulator bit for bit; the update within 4
  ulps of ``optax.adagrad``'s (XLA's CPU ``rsqrt`` and PyTorch's are each
  within 1 ulp of the correctly rounded value, so up to 2 apart, and two
  roundings follow; 4 measured over 2^20 elements, 2 on these) and
  equal bit for bit when both take the same ``rsqrt``;
- a 2-epoch train from the same init on the same source, numpy and
  feeder, with and without dense features: per-step losses within one
  bfloat16 ulp (2^-8) relative, final parameters and accumulators and
  predicted probabilities within 2^-6 absolute.  The runs agree to about
  2e-7 until an MLP input sits on a bfloat16 rounding boundary that the
  other order of float32 summation rounds the other way; the largest
  gaps measured over seeds 1-12 are 8.3e-4 (loss), 2.9e-3 (parameters),
  2.1e-3 (accumulators) and 8.6e-3 (probabilities), all at seed 6,
  which the numpy case uses; without dense features no flip was seen;
- K=8 fused equals K=1 bit for bit, from numpy and from the feeder, as
  does the fused window against eight ``train_step`` calls; a resumed
  train equals an uninterrupted one bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from predictionio_tpu.models import dlrm as ref
from predictionio_tpu_torch.models import dlrm as port

VOCAB, N_DENSE, N_ROWS = (48, 32), 4, 400
INIT_ULPS = 4
LOSS_RTOL = 1e-5
GRAD_REL = 1e-5
ADAGRAD_ULPS = 4
TRAIN_LOSS_RTOL = 2.0 ** -8
TRAIN_ATOL = 2.0 ** -6


@pytest.fixture(autouse=True)
def _unfused(monkeypatch):
    """K from the caller only (the CLI sets these in-process)."""
    for k in ("PIO_FUSE_STEPS", "PIO_BATCH_AUTOSCALE", "PIO_PREFETCH_DEPTH",
              "PIO_STEP_TIMEOUT_S"):
        monkeypatch.delenv(k, raising=False)


def _cfgs(**kw):
    base = dict(vocab_sizes=VOCAB, n_dense=N_DENSE, embed_dim=8,
                bottom_mlp=(16, 8), top_mlp=(16, 8), batch_size=32,
                epochs=2, seed=3)
    base.update(kw)
    return ref.DLRMConfig(**base), port.DLRMConfig(**base)


def _data(seed=0, n=N_ROWS, n_dense=N_DENSE):
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((n, n_dense)).astype(np.float32)
    cat = np.stack([rng.integers(0, VOCAB[0], n),
                    rng.integers(0, VOCAB[1], n)], axis=1)
    labels = (rng.random(n) < 0.3).astype(np.float32)
    return dense, cat, labels


def _ref_leaves(tree):
    """The reference tree's leaves in the port's :func:`_leaves` order."""
    out = [tree["embed"]]
    for mlp in ("bottom", "top"):
        for layer in tree[mlp]:
            out += [layer["w"], layer["b"]]
    return [np.asarray(x) for x in out]


def _np(leaves):
    return [x.detach().cpu().numpy() for x in leaves]


def _carry(tree):
    """A reference params tree as port tensors (same values)."""
    return port._map(lambda a: torch.from_numpy(np.array(a, np.float32)),
                     jax.tree.map(np.asarray, tree))


def _state_leaves(state):
    return (port._leaves(state.params)
            + port._leaves(state.opt_state[0].sum_of_squares))


# -- init ---------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 42])
@pytest.mark.parametrize("dims", [(4, 8, (16, 8), (16, 8)),
                                  (0, 8, (16, 8), (16,)),
                                  (13, 16, (32, 16), (32, 24))])
def test_init_within_ulps_of_jax(seed, dims):
    n_dense, embed, bottom, top = dims
    rc, pc = _cfgs(seed=seed, n_dense=n_dense, embed_dim=embed,
                   bottom_mlp=bottom, top_mlp=top)
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
    rss, empty = st.opt_state
    assert isinstance(rss, port.RssState) and empty == port.EmptyState()
    for g, w in zip(_np(port._leaves(rss.sum_of_squares)),
                    _ref_leaves(ref_st.opt_state[0].sum_of_squares)):
        np.testing.assert_array_equal(g, w)
    assert st.step == int(ref_st.step) == 0
    with pytest.raises(ValueError, match="embed_dim"):
        port.DLRMConfig(vocab_sizes=VOCAB, n_dense=1, embed_dim=8,
                        bottom_mlp=(16, 4))
    np.testing.assert_array_equal(pc.offsets, rc.offsets)
    assert pc.total_vocab == rc.total_vocab == sum(VOCAB)


# -- forward, loss, gradients, Adagrad ----------------------------------------

def _batch(cfg):
    dense, cat, labels = _data(seed=11, n=32)
    cat = (cat + cfg.offsets[None, :]).astype(np.int32)
    cat[3] = cat[5] = cat[9]             # duplicate rows in the batch
    w = np.ones(32, np.float32)
    w[-4:] = 0.0                         # weight-0 tail padding
    dense[-4:] = 0.0
    cat[-4:] = 0
    labels[-4:] = 0.0
    return dense, cat, labels, w


def test_loss_and_gradients_match_jax_grad():
    rc, pc = _cfgs()
    params = ref.init_params(rc)
    dense, cat, labels, w = _batch(pc)
    want_loss, want_grads = jax.value_and_grad(ref._loss)(
        params, jnp.asarray(dense), jnp.asarray(cat), jnp.asarray(labels),
        jnp.asarray(w), None)
    carried = _carry(params)
    leaves = [p.requires_grad_(True) for p in port._leaves(carried)]
    loss = port._loss(port._unflatten(carried, leaves),
                      torch.from_numpy(dense), torch.from_numpy(cat),
                      torch.from_numpy(labels), torch.from_numpy(w))
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(want_loss)) <= \
        LOSS_RTOL * abs(float(want_loss))
    for g, want in zip(_np(grads), _ref_leaves(want_grads)):
        np.testing.assert_allclose(
            g, want, rtol=0, atol=GRAD_REL * float(np.abs(want).max()))
    # the weight-0 pads change nothing: the batch without them gives
    # the same loss
    keep = w > 0
    kept = port._loss(carried, *(torch.from_numpy(a[keep])
                                 for a in (dense, cat, labels, w)))
    np.testing.assert_allclose(float(kept.detach()), float(loss.detach()),
                               rtol=1e-6)


def test_predict_proba_on_the_reference_params():
    rc, pc = _cfgs()
    dense, cat, labels = _data(seed=4)
    state = ref.train(dense, cat, labels, rc, data_source="numpy")
    want = np.asarray(ref.predict_proba(state, dense, cat, rc))
    carried = port.state_from_host(
        jax.tree.map(np.asarray, (state.params, state.opt_state,
                                  state.step)), "cpu")
    got = port.predict_proba(carried, dense, cat, pc)
    assert got.shape == (N_ROWS,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=LOSS_RTOL,
                               atol=LOSS_RTOL)


@pytest.mark.parametrize("rsqrt", ["torch", "jax"])
def test_adagrad_update_equals_optax(rsqrt, monkeypatch):
    """Three updates from optax's init: the accumulator bit for bit, the
    updates within 4 ulps — and bit for bit when the port takes XLA's
    ``rsqrt`` too."""
    rc, pc = _cfgs()
    params = ref.init_params(rc)
    tx = optax.adagrad(rc.learning_rate)
    opt = tx.init(params)
    rss = port.init_state(pc, device="cpu").opt_state[0]
    if rsqrt == "jax":
        def xla_rsqrt_(ts):
            for t in ts:
                t.copy_(torch.from_numpy(np.array(
                    jax.lax.rsqrt(jnp.asarray(t.numpy())))))

        monkeypatch.setattr(torch, "_foreach_rsqrt_", xla_rsqrt_)
    rng = np.random.default_rng(2)
    for _ in range(3):
        grads = jax.tree.map(
            lambda x: jnp.asarray(rng.standard_normal(x.shape)
                                  .astype(np.float32)), params)
        want, opt = tx.update(grads, opt, params)
        got, rss = port._adagrad_update(
            [torch.from_numpy(np.array(g)) for g in _ref_leaves(grads)],
            rss, pc.learning_rate)
        for a, b in zip(_np(port._leaves(rss.sum_of_squares)),
                        _ref_leaves(opt[0].sum_of_squares)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(_np(got), _ref_leaves(want)):
            if rsqrt == "jax":
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_array_max_ulp(a, b, maxulp=ADAGRAD_ULPS)


# -- training -----------------------------------------------------------------

def _recorded(mod, monkeypatch):
    losses = []
    real = mod.train_step

    def recording(*a, **k):
        s, loss = real(*a, **k)
        losses.append(float(loss))
        return s, loss

    monkeypatch.setattr(mod, "train_step", recording)
    return losses


@pytest.mark.parametrize("source,n_dense,seed", [
    ("numpy", N_DENSE, 6), ("feeder", N_DENSE, 11), ("feeder", 0, 8)])
def test_two_epochs_match_the_reference(source, n_dense, seed,
                                        monkeypatch):
    rc, pc = _cfgs(n_dense=n_dense)
    dense, cat, labels = _data(seed=seed, n_dense=n_dense)
    ref_losses = _recorded(ref, monkeypatch)
    want = ref.train(dense, cat, labels, rc, data_source=source)
    port_losses = _recorded(port, monkeypatch)
    got = port.train(dense, cat, labels, pc, data_source=source,
                     device="cpu")
    assert len(port_losses) == len(ref_losses) == 2 * -(-N_ROWS // 32)
    np.testing.assert_allclose(port_losses, ref_losses,
                               rtol=TRAIN_LOSS_RTOL)
    assert got.step == int(want.step)
    for g, w in zip(_np(_state_leaves(got)),
                    _ref_leaves(want.params)
                    + _ref_leaves(want.opt_state[0].sum_of_squares)):
        np.testing.assert_allclose(g, w, rtol=0, atol=TRAIN_ATOL)
    np.testing.assert_allclose(
        port.predict_proba(got, dense, cat, pc).numpy(),
        np.asarray(ref.predict_proba(want, dense, cat, rc)), rtol=0,
        atol=TRAIN_ATOL)


def test_auto_source_is_the_feeder():
    _, pc = _cfgs(epochs=1)
    data = _data(seed=7)
    auto = port.train(*data, pc, device="cpu")
    feeder = port.train(*data, pc, data_source="feeder", device="cpu")
    numpy_ = port.train(*data, pc, data_source="numpy", device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(_state_leaves(auto), _state_leaves(feeder)))
    assert not torch.equal(auto.params["embed"], numpy_.params["embed"])


def test_a_failed_feeder_build_raises(monkeypatch):
    import predictionio_tpu_torch.native.build as build

    def broken(name, build_dir=None):
        raise RuntimeError(f"g++ failed for {name}.cc (exit 1):\nboom")

    monkeypatch.setattr(build, "load_library", broken)
    _, pc = _cfgs()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for feeder"):
        port.train(*_data(), pc, device="cpu")


@pytest.mark.parametrize("source", ["numpy", "feeder"])
def test_k8_fused_equals_k1_bit_for_bit(source):
    _, pc = _cfgs()
    data = _data(seed=8)
    a = port.train(*data, pc, data_source=source, fuse_steps=1,
                   device="cpu")
    b = port.train(*data, pc, data_source=source, fuse_steps=8,
                   device="cpu")
    for x, y in zip(_state_leaves(a), _state_leaves(b)):
        assert torch.equal(x, y)
    assert a.step == b.step == 2 * -(-N_ROWS // 32)


def test_fused_window_equals_sequential_steps():
    _, pc = _cfgs()
    k, bs = 8, pc.batch_size
    dense, cat, labels = _data(seed=9, n=k * bs)
    d = torch.from_numpy(dense).reshape(k, bs, N_DENSE)
    c = torch.from_numpy((cat + pc.offsets[None, :]).astype(np.int32)
                         ).reshape(k, bs, 2)
    y = torch.from_numpy(labels).reshape(k, bs)
    w = torch.ones((k, bs))
    seq = port.init_state(pc, device="cpu")
    losses = []
    for j in range(k):
        seq, loss = port.train_step(seq, d[j], c[j], y[j], w[j], pc)
        losses.append(loss)
    fused, fl = port.train_steps_fused(port.init_state(pc, device="cpu"),
                                       d, c, y, w, pc)
    assert fl.shape == (k,) and torch.equal(fl, torch.stack(losses))
    for x, z in zip(_state_leaves(seq), _state_leaves(fused)):
        assert torch.equal(x, z)
    assert seq.step == fused.step == k


def test_a_step_leaves_its_input_state_untouched():
    _, pc = _cfgs()
    st = port.init_state(pc, device="cpu")
    before = [x.clone() for x in _state_leaves(st)]
    dense, cat, labels, w = _batch(pc)
    new, _ = port.train_step(st, *(torch.from_numpy(a)
                                   for a in (dense, cat, labels, w)), pc)
    assert all(torch.equal(a, b) for a, b in zip(before, _state_leaves(st)))
    assert new.step == 1 and st.step == 0


# -- supervision and resume ---------------------------------------------------

def test_crash_and_resume_equals_an_uninterrupted_train(tmp_path,
                                                         monkeypatch):
    _, pc = _cfgs()
    data = _data(seed=1)
    expected = port.train(*data, pc, data_source="feeder", device="cpu")
    real = port.train_step
    calls = {"n": 0}

    def dying_step(*a, **k):
        calls["n"] += 1
        if calls["n"] > 17:                # mid-epoch 2
            raise RuntimeError("injected trainer crash")
        return real(*a, **k)

    ck = tmp_path / "ck"
    monkeypatch.setattr(port, "train_step", dying_step)
    with pytest.raises(RuntimeError, match="injected"):
        port.train(*data, pc, data_source="feeder", device="cpu",
                   checkpoint_dir=ck, save_every=5)
    monkeypatch.setattr(port, "train_step", real)
    resumed = port.train(*data, pc, data_source="feeder", device="cpu",
                         checkpoint_dir=ck, save_every=5)
    for x, y in zip(_state_leaves(expected), _state_leaves(resumed)):
        assert torch.equal(x, y)
    assert resumed.step == expected.step
    assert not [p for p in ck.iterdir() if p.name.endswith(".pt")]


def test_a_nan_batch_raises_train_diverged():
    from predictionio_tpu_torch.resilience.supervision import TrainDiverged

    _, pc = _cfgs()
    dense, cat, labels = _data(seed=2)
    dense[100, 2] = np.nan
    with pytest.raises(TrainDiverged, match="dlrm"):
        port.train(dense, cat, labels, pc, data_source="numpy",
                   fuse_steps=4, device="cpu")


# -- carrying a generation across packages ------------------------------------

def test_state_round_trips_within_the_port():
    _, pc = _cfgs(epochs=1)
    st = port.train(*_data(seed=9), pc, data_source="numpy", device="cpu")
    snap = port.state_to_host(st)
    assert snap["step"].dtype == np.int32 and \
        isinstance(snap["opt_state"][0], port.RssState)
    back = port.state_from_host(snap, "cpu")
    for x, y in zip(_state_leaves(st), _state_leaves(back)):
        assert torch.equal(x, y)
    assert back.step == st.step


def test_warm_continuation_matches_the_reference():
    """The reference's state, carried in, continues in the port on a
    delta window as it continues at home; the port's carried back
    continues in the reference."""
    rc, pc = _cfgs(epochs=1)
    base = ref.train(*_data(seed=10), rc, data_source="numpy")
    delta = _data(seed=12, n=96)
    tree = jax.tree.map(np.asarray, (base.params, base.opt_state,
                                     base.step))
    home = ref.train(*delta, rc, data_source="feeder",
                     warm_state=ref.DLRMState(*jax.tree.map(jnp.asarray,
                                                            tree)))
    carried = port.state_from_host(tree, "cpu")
    before = [x.clone() for x in _state_leaves(carried)]
    away = port.train(*delta, pc, data_source="feeder", warm_state=carried)
    assert all(torch.equal(a, b)
               for a, b in zip(before, _state_leaves(carried)))
    assert away.step == int(home.step) == int(base.step) + 3
    for g, w in zip(_np(_state_leaves(away)),
                    _ref_leaves(home.params)
                    + _ref_leaves(home.opt_state[0].sum_of_squares)):
        np.testing.assert_allclose(g, w, rtol=0, atol=TRAIN_ATOL)
    snap = port.state_to_host(away)
    back = ref.train(*delta, rc, data_source="numpy",
                     warm_state=ref.DLRMState(*jax.tree.map(
                         jnp.asarray, (snap["params"], snap["opt_state"],
                                       snap["step"]))))
    assert int(back.step) == away.step + 3
    assert np.isfinite(np.asarray(back.params["embed"])).all()


def test_mesh_is_not_ported():
    _, pc = _cfgs()
    with pytest.raises(NotImplementedError, match="item 10"):
        port.train(*_data(), pc, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        port.init_state(pc, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="data_source"):
        port.train(*_data(), pc, data_source="parquet", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port.init_state(pc)
