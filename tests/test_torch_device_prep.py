"""Bucketing on the training device: the PyTorch port vs the JAX package.

The port's ``ops/device_prep.py`` and the device route of
``models/als.prepare_als_inputs`` take the same seeded COO triplets
(numpy) as the reference's, on the CPU.  Checks:

- ``degree_histogram`` / ``plan_buckets``: the same plan, field by
  field, for ``split_above`` 64 and 8192, with and without chunking;
- ``build_buckets``: arrays identical to the reference's (values and
  dtypes) for the same plan, and the port's chunk list identical to the
  reference's ``_expand_chunks`` of its device buckets;
- the contents equal the port's host ``bucket_by_length`` entity by
  entity (within-row event order and split segments included), nnz is
  conserved, and no split bucket appears when every row is short;
- ``_plan_side`` gives one plan from host and from device statistics,
  and the reference's plan, also for ids outside ``[0, n_rows)``;
- ``train_als(device_prep=True, device="cpu")`` is bitwise the host
  route (atol 1e-5 is the stated tolerance; the layouts are the same,
  so the sums run in the same order), and within atol 1e-4 + rtol 1e-3
  of the reference's ``train_als(device_prep=True)`` after 3 iterations;
- the dispatch: ``"auto"`` takes the device route on the card only.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.models import als as jax_als
from predictionio_tpu.ops import device_prep as jax_dp
from predictionio_tpu_torch.models import als as port_als
from predictionio_tpu_torch.ops import device_prep as dp
from predictionio_tpu_torch.ops.ragged import bucket_by_length

ATOL = 1e-4       # training, port vs reference (PERF.md §2)
RTOL = 1e-3
SELF_ATOL = 1e-5  # training, device route vs host route in the port
CPU = torch.device("cpu")


def _coo(seed=3, n_rows=400, n_cols=300, n=20_000, zipf=1.3):
    rng = np.random.default_rng(seed)
    rows = (rng.zipf(zipf, n) % n_rows).astype(np.int32)
    cols = rng.integers(0, n_cols, n).astype(np.int32)
    vals = rng.random(n).astype(np.float32)
    return rows, cols, vals


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _plans(rows, n_rows, split_above, max_block_floats):
    """(port plan, reference plan) from each package's device stats."""
    kw = dict(split_above=split_above, max_block_floats=max_block_floats,
              rank=8)
    counts = np.bincount(rows, minlength=n_rows)
    over_deg = counts[counts > split_above]
    hist, n_over, n_part = dp.degree_histogram(
        torch.bincount(_t(rows).long(), minlength=n_rows), split_above)
    port = dp.plan_buckets(hist, n_over, n_part, n_rows,
                           over_degrees=over_deg, **kw)
    jhist, jn_over, jn_part = jax_dp.degree_histogram(
        jnp.zeros(n_rows, jnp.int32).at[jnp.asarray(rows)].add(1),
        split_above)
    assert np.array_equal(hist, jhist)
    assert (n_over, n_part) == (jn_over, jn_part)
    ref = jax_dp.plan_buckets(jhist, jn_over, jn_part, n_rows,
                              over_degrees=over_deg, **kw)
    return port, ref


def _same_arrays(got, want, what):
    assert len(got) == len(want), what
    for j, (g, w) in enumerate(zip(got, want)):
        g, w = _np(g), np.asarray(w)
        assert g.dtype == w.dtype, (what, j, g.dtype, w.dtype)
        assert g.shape == w.shape, (what, j, g.shape, w.shape)
        assert np.array_equal(g, w), (what, j)


PLAN_CASES = [(64, None), (64, 1 << 14), (8192, None), (8192, 1 << 14)]


@pytest.mark.parametrize("split_above,max_block_floats", PLAN_CASES)
def test_plan_matches_the_reference(split_above, max_block_floats):
    rows, _, _ = _coo()
    port, ref = _plans(rows, 400, split_above, max_block_floats)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    if max_block_floats:
        assert len(port.plain_chunks) == len(port.bounds)


@pytest.mark.parametrize("split_above,max_block_floats", PLAN_CASES)
def test_build_buckets_identical_to_the_reference(split_above,
                                                   max_block_floats):
    rows, cols, vals = _coo()
    port, ref = _plans(rows, 400, split_above, max_block_floats)
    plain, split = dp.build_buckets(_t(rows), _t(cols), _t(vals), port)
    jplain, jsplit = jax_dp.build_buckets(jnp.asarray(rows),
                                          jnp.asarray(cols),
                                          jnp.asarray(vals), ref)
    assert len(plain) == len(jplain)
    for j, (g, w) in enumerate(zip(plain, jplain)):
        _same_arrays(g, w, f"plain block {j}")
    if jsplit is None:
        assert split is None and split_above == 8192
        return
    assert len(split) == len(jsplit)
    for j, (g, w) in enumerate(zip(split, jsplit)):
        _same_arrays(g, w, f"split block {j}")


@pytest.fixture(scope="module")
def reference_device_inputs():
    """The reference's device-prep inputs (buckets and chunk specs) on
    a COO with split and chunked buckets, and that COO."""
    rows, cols, vals = _coo(seed=7, n_rows=96, n_cols=64, n=9000, zipf=1.2)
    cfg = jax_als.ALSConfig(rank=8, iterations=1, seed=1, device_prep=True,
                            split_above=32, max_block_floats=1 << 14)
    inputs = jax_als.prepare_als_inputs(rows, cols, vals, 96, 64, cfg)
    if inputs.loop_warm is not None:      # let its compile thread end
        inputs.loop_warm.result(timeout=600)
    return (rows, cols, vals), inputs


def test_chunk_list_identical_to_reference_expand_chunks(
        reference_device_inputs):
    (rows, cols, vals), inputs = reference_device_inputs
    cfg = port_als.ALSConfig(rank=8, seed=1, split_above=32,
                             max_block_floats=1 << 14)
    sides = ((rows, cols, 96, inputs.user_buckets, inputs.chunk_specs[0]),
             (cols, rows, 64, inputs.item_buckets, inputs.chunk_specs[1]))
    n_merged = 0
    for r, c, n_rows, buckets, specs in sides:
        want = jax_als._expand_chunks(tuple(tuple(b[1:]) for b in buckets),
                                      specs)
        plan = port_als._plan_side(_t(r), n_rows, cfg, host_rows=r)
        got = port_als._device_side_chunks(_t(r), _t(c), _t(vals), plan)
        assert len(got) == len(want)
        assert len(got) > len(buckets)         # some bucket was chunked
        for j, ((kind, g), w) in enumerate(zip(got, want)):
            assert kind == ("merged" if len(w) == 5 else "plain")
            _same_arrays(g, w, f"chunk {j}")
            n_merged += kind == "merged"
        # plain chunks are views of their bucket's block, not copies
        blocks = [g for kind, g in got if kind == "plain"]
        bases = {b[0].untyped_storage().data_ptr() for b in blocks}
        assert len(bases) == 1
    assert n_merged > 1


@pytest.mark.parametrize("split_above", [64, 8192])
def test_contents_match_the_host_bucketing(split_above):
    """Entity by entity, the device layout holds what the port's host
    ``bucket_by_length`` holds (reference: tests/test_device_prep.py)."""
    rows, cols, vals = _coo()
    n_rows = 400
    host = bucket_by_length(rows.astype(np.int64), cols.astype(np.int64),
                            vals, n_rows, split_above=split_above,
                            pad_rows_to=8)
    plan, _ = _plans(rows, n_rows, split_above, None)
    plain, split = dp.build_buckets(_t(rows), _t(cols), _t(vals), plan)
    host_plain = [p for p in host if not p.split]
    assert len(host_plain) == len(plain)
    for hp, blocks in zip(host_plain, plain):
        idx, val, msk, rid = [_np(x) for x in blocks]
        hmap = {int(r): i for i, r in enumerate(hp.row_ids) if r >= 0}
        dmap = {int(r): i for i, r in enumerate(rid) if r >= 0}
        assert set(hmap) == set(dmap)
        for r in hmap:
            hi, di = hmap[r], dmap[r]
            assert np.array_equal(hp.indices[hi][hp.mask[hi]],
                                  idx[di][msk[di]])
            assert np.array_equal(hp.values[hi][hp.mask[hi]],
                                  val[di][msk[di]])
    host_split = [p for p in host if p.split]
    if not host_split:
        assert split is None
        return
    hs = host_split[0]
    assert len(split) == 1
    didx, _, dmsk, dseg, dent = [_np(x) for x in split[0]]
    for e_h, ent_id in enumerate(hs.ent_ids):
        if ent_id < 0:
            continue
        h_rows = np.where(hs.seg_ids == e_h)[0]
        h_seq = np.concatenate([hs.indices[r][hs.mask[r]] for r in h_rows])
        (e_d,) = np.where(dent == ent_id)
        d_rows = np.where(dseg == e_d[0])[0]
        d_seq = np.concatenate([didx[r][dmsk[r]] for r in d_rows])
        assert np.array_equal(h_seq, d_seq)


def test_nnz_conserved():
    rows, cols, vals = _coo(seed=7)
    plan, _ = _plans(rows, 400, 64, 1 << 14)
    plain, split = dp.build_buckets(_t(rows), _t(cols), _t(vals), plan)
    tot = sum(int(p[2].sum()) for p in plain)
    tot += sum(int(c[2].sum()) for c in split or ())
    assert tot == len(rows)
    assert split is not None


def test_no_split_when_all_short():
    rows = np.arange(100, dtype=np.int32)
    plan, _ = _plans(rows, 100, 4096, None)
    plain, split = dp.build_buckets(_t(rows), _t(rows),
                                    torch.ones(100), plan)
    assert split is None
    assert sum(int(p[2].sum()) for p in plain) == 100


def test_plan_side_host_and_device_stats_agree():
    rows, _, _ = _coo(seed=11, n_rows=200, n_cols=50, n=30_000, zipf=1.2)
    cfg = port_als.ALSConfig(rank=8, split_above=64,
                             max_block_floats=1 << 14)
    dev_plan = port_als._plan_side(_t(rows), 200, cfg)
    host_plan = port_als._plan_side(_t(rows), 200, cfg, host_rows=rows)
    assert dev_plan == host_plan
    assert dev_plan.split_chunks                 # the chunked split path
    jcfg = jax_als.ALSConfig(rank=8, split_above=64,
                             max_block_floats=1 << 14)
    ref = jax_als._plan_side(jnp.asarray(rows), 200, jcfg)
    assert dataclasses.asdict(dev_plan) == dataclasses.asdict(ref)


def test_ids_outside_the_range():
    """An id in [-n_rows, 0) counts as id + n_rows and an id outside
    [-n_rows, n_rows) is dropped, as the reference counts them in
    ``_plan_side`` (both branches); the port's build places exactly the
    entries its plan counted, where they would be with the ids
    normalized."""
    rows, cols, vals = _coo(seed=5, n_rows=50, n_cols=40, n=3000, zipf=1.2)
    odd = rows.copy()
    odd[::7] -= 50                      # wrapped: the same entities
    odd[3::11] = 50 + odd[3::11]        # out of range: dropped
    odd[5::13] = -51 - odd[5::13] % 4   # below -n_rows: dropped
    keep = (odd >= -50) & (odd < 50)
    norm = np.where(odd < 0, odd + 50, odd)[keep]
    cfg = port_als.ALSConfig(rank=8, split_above=32,
                             max_block_floats=1 << 14)
    jcfg = jax_als.ALSConfig(rank=8, split_above=32,
                             max_block_floats=1 << 14)
    plan = port_als._plan_side(_t(odd), 50, cfg)
    assert plan == port_als._plan_side(_t(odd), 50, cfg, host_rows=odd)
    assert plan == port_als._plan_side(_t(norm), 50, cfg)
    for ref in (jax_als._plan_side(jnp.asarray(odd), 50, jcfg),
                jax_als._plan_side(None, 50, jcfg, host_rows=odd)):
        assert dataclasses.asdict(plan) == dataclasses.asdict(ref)
    got = port_als._device_side_chunks(_t(odd), _t(cols), _t(vals), plan)
    want = port_als._device_side_chunks(_t(norm), _t(cols[keep]),
                                        _t(vals[keep]), plan)
    for (kg, g), (kw, w) in zip(got, want, strict=True):
        assert kg == kw
        _same_arrays(g, w, "normalized ids")
    assert sum(int(g[2].sum()) for _, g in got) == int(keep.sum())


def _ratings(seed=0, n_users=70, n_items=50, n=1500):
    rng = np.random.default_rng(seed)
    users = rng.integers(0, n_users, n)
    items = (rng.zipf(1.25, n) % n_items).astype(np.int64)
    ratings = (rng.integers(1, 11, n) * 0.5).astype(np.float32)
    return users, items, ratings


TRAIN_CASES = {
    "explicit": {},
    "implicit": {"implicit": True, "alpha": 0.5},
    "split_chunked": {"split_above": 16, "max_block_floats": 16 * 16 * 8},
}


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_device_prep_trains_as_the_host_route_and_the_reference(case):
    users, items, ratings = _ratings()
    cfg = dict(rank=8, iterations=3, reg=0.05, seed=5, **TRAIN_CASES[case])
    dev = port_als.train_als(users, items, ratings, 70, 50,
                             port_als.ALSConfig(device_prep=True, **cfg),
                             device=CPU)
    host = port_als.train_als(users, items, ratings, 70, 50,
                              port_als.ALSConfig(device_prep=False, **cfg),
                              device=CPU)
    for a, b in ((dev.user_factors, host.user_factors),
                 (dev.item_factors, host.item_factors)):
        np.testing.assert_allclose(a, b, rtol=0, atol=SELF_ATOL)
    want = jax_als.train_als(users, items, ratings, 70, 50,
                             jax_als.ALSConfig(device_prep=True, **cfg))
    err = 0.0
    for a, b in ((dev.user_factors, want.user_factors),
                 (dev.item_factors, want.item_factors)):
        b = np.asarray(jax.device_get(b))
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
        err = max(err, float(np.abs(a - b).max()))
    print(f"{case}: device vs host route bitwise "
          f"{np.array_equal(dev.user_factors, host.user_factors)}, "
          f"vs the reference max |err| {err:.3g}")


def test_device_prep_inputs_live_on_the_training_device():
    users, items, ratings = _ratings()
    cfg = port_als.ALSConfig(rank=8, device_prep=True, split_above=16)
    inputs = port_als.prepare_als_inputs(users, items, ratings, 70, 50, cfg,
                                         device=CPU)
    chunks = inputs.user_buckets + inputs.item_buckets
    assert any(c.kind == "merged" for c in chunks)
    for c in chunks:
        assert c.indices.dtype == torch.int32
        assert c.values.dtype == torch.float32
        assert c.mask.dtype == torch.bool
        assert c.keep.dtype == c.targets.dtype == torch.int64
        if c.kind == "merged":
            assert int(c.seg_ids.max()) <= c.n_seg
    # tensors as input: the plan is made from device statistics
    t_inputs = port_als.prepare_als_inputs(
        torch.from_numpy(users), torch.from_numpy(items), ratings, 70, 50,
        cfg, device=CPU)
    for a, b in zip(chunks, t_inputs.user_buckets + t_inputs.item_buckets):
        assert torch.equal(a.indices, b.indices)
        assert torch.equal(a.targets, b.targets)


def test_dispatch(monkeypatch):
    """"auto" buckets on the card (no max_degree) and on the host on the
    CPU; True on any device; max_degree and unknown values refuse the
    device route instead of falling back."""
    users, items, ratings = _ratings()
    taken = []

    def fake_device(*args):
        taken.append(args[-1])
        return "device route"

    monkeypatch.setattr(port_als, "_prepare_als_inputs_device", fake_device)
    monkeypatch.setattr(port_als, "resolve_device", torch.device)  # no card
    prep = port_als.prepare_als_inputs
    cfg = port_als.ALSConfig(rank=4)
    cuda = torch.device("cuda")
    assert prep(users, items, ratings, 70, 50, cfg, device=cuda) == \
        "device route"
    assert taken == [cuda]
    host = prep(users, items, ratings, 70, 50, cfg, device=CPU)
    assert isinstance(host, port_als.ALSInputs) and len(taken) == 1
    assert prep(users, items, ratings, 70, 50,
                dataclasses.replace(cfg, device_prep=True),
                device=CPU) == "device route"
    # with max_degree, "auto" goes to the host route, which then needs
    # the card this machine lacks
    with pytest.raises((AssertionError, RuntimeError)):
        prep(users, items, ratings, 70, 50,
             dataclasses.replace(cfg, max_degree=8), device=cuda)
    assert len(taken) == 2
    with pytest.raises(NotImplementedError, match="truncate"):
        prep(users, items, ratings, 70, 50,
             dataclasses.replace(cfg, device_prep=True, max_degree=8),
             device=CPU)
    with pytest.raises(ValueError, match="device_prep"):
        prep(users, items, ratings, 70, 50,
             dataclasses.replace(cfg, device_prep="yes"), device=CPU)
