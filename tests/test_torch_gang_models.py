"""The deep models, linear, naive Bayes and sequence-parallel attention
on a mesh that spans a gang of processes.

Two gloo processes with 2 CPU positions each beside one process with
all 4 (the harness of ``tests/test_torch_gang_collectives.py``), each
process making autograd leaves for its own positions only:

- two-tower on ``data=2 × model=2`` and DLRM on ``expert=4``, 6 and 4
  steps: the per-step losses and the trained states (parameters and
  optimizer moments) of the gang ``torch.equal`` to the one process's,
  and so are the item vectors encoded from the gang's state (its tables
  gathered from both processes);
- logistic regression and naive Bayes (multinomial, gaussian) on
  ``data=4``: the gang's models equal the one process's, and stay within
  the meshless bounds of ``tests/test_torch_mesh_cli.py`` against the
  reference's mesh train;
- ring and Ulysses attention on ``sequence=4``, causal and not: the
  outputs and the gradients of ``Σ out²`` equal the one process's, and
  are within 1e-5 of the reference's outputs and of ``jax.grad``'s.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_gang_collectives import (
    assert_equal_trees,
    merged,
    run_gang,
)

N = 4
ATTN_ATOL = 1e-5
TT_CFG = dict(n_users=32, n_items=16, embed_dim=8, hidden_dims=(16,),
              out_dim=8, batch_size=64, epochs=2, seed=4)
DLRM_CFG = dict(vocab_sizes=(16, 8), n_dense=4, embed_dim=4,
                bottom_mlp=(8, 4), top_mlp=(8,), epochs=1, batch_size=128,
                seed=3)


def _clique(n_users=32, n_items=16, per_user=6, seed=3):
    rng = np.random.default_rng(seed)
    users, items = [], []
    for u in range(n_users):
        pool = [i for i in range(n_items) if i % 2 == u % 2]
        for i in rng.choice(pool, size=per_user, replace=True):
            users.append(u)
            items.append(int(i))
    return np.array(users), np.array(items)


def _ctr(n=512, seed=2):
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((n, 4)).astype(np.float32)
    cat = np.stack([rng.integers(0, 16, n), rng.integers(0, 8, n)], axis=1)
    logit = (cat[:, 0] % 2) * 2.0 - 1.0 + dense[:, 0]
    labels = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    return dense, cat, labels


def _xy(n=400, d=3, c=4, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, c, n)
    x = rng.poisson(1.0 + 3.0 * np.eye(c, d)[y]).astype(np.float32)
    return x, y.astype(np.int64)


def _qkv(seed=2, b=2, s=16, h=8, d=8):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(3)]


def _unfused():
    import os

    for k in ("PIO_FUSE_STEPS", "PIO_BATCH_AUTOSCALE", "PIO_PREFETCH_DEPTH",
              "PIO_STEP_TIMEOUT_S"):
        os.environ.pop(k, None)


def _recording(mod):
    """``mod.train_step`` wrapped to keep every step's loss."""
    losses, real = [], mod.train_step

    def step(*a, **k):
        s, loss = real(*a, **k)
        losses.append(loss.detach().clone())
        return s, loss

    mod.train_step = step
    return losses, lambda: setattr(mod, "train_step", real)


# -- the cases (run in every process) -----------------------------------------


def case_deep() -> dict:
    """Two-tower and DLRM trains: per-step losses and whole states."""
    from predictionio_tpu_torch.models import dlrm
    from predictionio_tpu_torch.models import two_tower as tt
    from predictionio_tpu_torch.parallel.mesh import make_mesh

    _unfused()
    out = {}
    users, items = _clique()
    losses, undo = _recording(tt)
    try:
        state = tt.train(users, items, tt.TwoTowerConfig(**TT_CFG),
                         mesh=make_mesh({"data": 2, "model": 2},
                                        device="cpu"),
                         data_source="numpy")
    finally:
        undo()
    out["two_tower"] = {"losses": losses,
                        "state": tt.state_to_host(state),
                        "items": tt.encode_items(state.params,
                                                 np.arange(16))}
    dense, cat, labels = _ctr()
    losses, undo = _recording(dlrm)
    try:
        state = dlrm.train(dense, cat, labels, dlrm.DLRMConfig(**DLRM_CFG),
                           make_mesh({"expert": N}, device="cpu"),
                           data_source="numpy")
    finally:
        undo()
    out["dlrm"] = {"losses": losses, "state": dlrm.state_to_host(state)}
    return out


def case_shallow() -> dict:
    """Logistic regression and naive Bayes on ``data=4``."""
    from predictionio_tpu_torch.models import linear, naive_bayes
    from predictionio_tpu_torch.parallel.mesh import make_mesh

    x, y = _xy()
    mesh = make_mesh({"data": N}, device="cpu")
    lr = linear.train(x, y, linear.LogisticRegressionConfig(n_classes=4),
                      mesh=mesh, device="cpu")
    g = naive_bayes.train_gaussian(x, y, 4, mesh=mesh)
    m = naive_bayes.train_multinomial(x, y, 4, mesh=mesh)
    return {"linear": [t.clone() for t in vars(lr).values()],
            "gaussian": [g.means, g.variances, g.class_log_prior],
            "multinomial": [m.feature_log_prob, m.class_log_prior]}


def case_attention() -> dict:
    """Ring and Ulysses on ``sequence=4``: this process's output blocks
    and its sequence slices of the gradients of ``Σ out²``."""
    from predictionio_tpu_torch.parallel import ring_attention
    from predictionio_tpu_torch.parallel import ulysses_attention
    from predictionio_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh({"sequence": N}, device="cpu")
    local = mesh.local_positions()
    out = {}
    for kind, fn in (("ring", ring_attention), ("ulysses",
                                                ulysses_attention)):
        for causal in (False, True):
            leaves = [torch.from_numpy(a).requires_grad_(True)
                      for a in _qkv()]
            got = fn(*leaves, mesh, causal=causal)
            total = sum((got.shards[p] ** 2).sum() for p in local)
            total.backward()
            sl = leaves[0].shape[1] // N
            out[f"{kind}-{causal}"] = {
                p: (got.shards[p].detach(),
                    [x.grad[:, p * sl:(p + 1) * sl] for x in leaves])
                for p in local}
    return out


# -- the tests ----------------------------------------------------------------


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    return run_gang("tests.test_torch_gang_models:"
                    "case_deep,case_shallow,case_attention",
                    tmp_path_factory.mktemp("gang_models"))


@pytest.mark.parametrize("model,steps", [("two_tower", 6), ("dlrm", 4)])
def test_gang_deep_models_equal_one_process(gang, model, steps):
    want = gang["one"]["case_deep"][model]
    assert len(want["losses"]) == steps
    for r in gang["gang"]:
        assert_equal_trees(r["case_deep"][model], want, model)


@pytest.mark.parametrize("model", ["linear", "gaussian", "multinomial"])
def test_gang_linear_and_naive_bayes_equal_one_process(gang, model):
    want = gang["one"]["case_shallow"][model]
    for r in gang["gang"]:
        assert_equal_trees(r["case_shallow"][model], want, model)
    from predictionio_tpu.models import linear as ref_linear
    from predictionio_tpu.models import naive_bayes as ref_nb
    from predictionio_tpu.parallel.mesh import make_mesh as jax_make_mesh

    x, y = _xy()
    jmesh = jax_make_mesh({"data": N})
    if model == "linear":
        ref = [np.asarray(t) for t in vars(ref_linear.train(
            x, y, ref_linear.LogisticRegressionConfig(n_classes=4),
            mesh=jmesh)).values()]
        atol = 1e-4
    elif model == "gaussian":
        g = ref_nb.train_gaussian(x, y, 4, mesh=jmesh)
        ref = [np.asarray(g.means), np.asarray(g.variances),
               np.asarray(g.class_log_prior)]
        atol = 1e-5
    else:
        m = ref_nb.train_multinomial(x, y, 4, mesh=jmesh)
        ref = [np.asarray(m.feature_log_prob), np.asarray(m.class_log_prior)]
        atol = 1e-5
    for g, w in zip(want, ref):
        np.testing.assert_allclose(np.asarray(g), w, rtol=0, atol=atol)


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_gang_attention_equals_one_process_and_the_reference(gang, kind,
                                                             causal):
    import jax
    import jax.numpy as jnp

    from predictionio_tpu.parallel import ring as ref
    from predictionio_tpu.parallel.mesh import make_mesh as jax_make_mesh

    key = f"{kind}-{causal}"
    got = merged(gang["gang"], "case_attention", key)
    want = gang["one"]["case_attention"][key]
    assert sorted(got) == sorted(want) == list(range(N))
    assert_equal_trees(got, want, key)
    jfn = {"ring": ref.ring_attention, "ulysses": ref.ulysses_attention}[kind]
    jmesh = jax_make_mesh({"sequence": N})
    qkv = [jnp.asarray(a) for a in _qkv()]
    out = np.asarray(jfn(*qkv, jmesh, causal=causal))
    grads = jax.grad(lambda q, k, v: jnp.sum(
        jfn(q, k, v, jmesh, causal=causal) ** 2), argnums=(0, 1, 2))(*qkv)
    sl = out.shape[1] // N
    for p in range(N):
        o, gs = got[p]
        np.testing.assert_allclose(o.numpy(), out[:, p * sl:(p + 1) * sl],
                                   rtol=0, atol=ATTN_ATOL)
        for g, w in zip(gs, grads):
            np.testing.assert_allclose(
                g.numpy(), np.asarray(w)[:, p * sl:(p + 1) * sl], rtol=0,
                atol=ATTN_ATOL)
