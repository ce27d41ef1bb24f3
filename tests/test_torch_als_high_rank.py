"""ALS above K1's ranks, and with ``use_pallas=False``: the library route.

The reference trains a bucket through its Pallas gram only where
``use_pallas`` is on and ``fits_vmem`` (``k <= 256``); elsewhere through
``fused_gram_vector_xla``, two einsums outside any kernel.  The port
chooses the same way (``models.als._resolve_loop_statics``): K1's
dispatcher, or ``ops.fused_gram.fused_gram_vector_library`` (the gather
and two float32 ``torch.bmm`` calls).

- The port and the reference train the same seeded COO on the CPU at
  ranks 257 and 300 (explicit, implicit, a split bucket, a mesh) and at
  rank 64 with ``use_pallas=False``: factors within the ALS parity
  tolerance (atol 1e-4 + rtol 1e-3), every gram through the library
  route and none through K1's.
- The route choice, for a CUDA device (nothing allocated), is the
  reference's ``_bucket_pallas`` at every rank and ``use_pallas``.
- The three ALS templates train at rank 300 through ``pio train``.

On the card, a K1 that fails to load raises and takes no library route
(``tests/test_torch_cuda_kernels.py``, which imports no JAX).
"""

import jax
import numpy as np
import pytest
import torch

from predictionio_tpu.models import als as jax_als
from predictionio_tpu_torch.models import als as port_als
from predictionio_tpu_torch.ops import fused_gram as fg
from predictionio_tpu_torch.parallel.mesh import make_mesh

ATOL = 1e-4
RTOL = 1e-3
N_USERS, N_ITEMS, N_RATINGS = 90, 60, 2000
CPU = torch.device("cpu")


def _ratings(seed=0):
    rng = np.random.default_rng(seed)
    users = rng.integers(0, N_USERS, N_RATINGS)
    items = (rng.zipf(1.25, N_RATINGS) % N_ITEMS).astype(np.int64)
    ratings = (rng.integers(1, 11, N_RATINGS) * 0.5).astype(np.float32)
    return users, items, ratings


@pytest.fixture()
def routes(monkeypatch):
    """Counts of the sweep's gram calls by route."""
    calls = {"k1": 0, "library": 0}
    for name, route in (("fused_gram_vector", "k1"),
                        ("fused_gram_vector_library", "library")):
        real = getattr(fg, name)

        def counted(*args, _real=real, _route=route):
            calls[_route] += 1
            return _real(*args)

        monkeypatch.setattr(fg, name, counted)
    return calls


CASES = {
    "rank300": dict(rank=300),
    "rank257": dict(rank=257),
    "rank300_implicit": dict(rank=300, implicit=True, alpha=0.5),
    "rank300_split": dict(rank=300, split_above=16),
    "rank64_use_pallas_false": dict(rank=64, use_pallas=False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_library_route_trains_as_the_reference(case, routes):
    users, items, ratings = _ratings()
    cfg = dict(iterations=3, reg=0.05, seed=5, **CASES[case])
    want = jax_als.train_als(users, items, ratings, N_USERS, N_ITEMS,
                             jax_als.ALSConfig(**cfg))
    got = port_als.train_als(users, items, ratings, N_USERS, N_ITEMS,
                             port_als.ALSConfig(**cfg), device=CPU)
    assert routes["library"] > 0 and routes["k1"] == 0
    for g, w in ((got.user_factors, want.user_factors),
                 (got.item_factors, want.item_factors)):
        w = np.asarray(jax.device_get(w))
        print(f"{case}: max |port - JAX| {np.abs(g - w).max():.3g}")
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    assert got.rank == cfg["rank"]


def test_library_route_on_a_mesh_trains_as_the_reference_mesh(routes):
    from predictionio_tpu.parallel.mesh import make_mesh as jmake_mesh

    users, items, ratings = _ratings(1)
    cfg = dict(rank=300, iterations=3, reg=0.05, seed=9,
               factor_sharding="sharded")
    want = jax_als.train_als(users, items, ratings, N_USERS, N_ITEMS,
                             jax_als.ALSConfig(**cfg),
                             mesh=jmake_mesh({"data": 4}))
    got = port_als.train_als(users, items, ratings, N_USERS, N_ITEMS,
                             port_als.ALSConfig(**cfg),
                             mesh=make_mesh({"data": 4}, device="cpu"))
    assert routes["library"] > 0 and routes["k1"] == 0
    np.testing.assert_allclose(got.user_factors,
                               np.asarray(jax.device_get(want.user_factors)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.item_factors,
                               np.asarray(jax.device_get(want.item_factors)),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rank", [16, 300])
def test_library_gram_computes_k1s_function(rank, dtype):
    rng = np.random.default_rng(rank)
    factors = torch.from_numpy(
        rng.standard_normal((50, rank)).astype(np.float32)).to(dtype)
    idx = torch.from_numpy(rng.integers(0, 50, (7, 13)).astype(np.int32))
    w = torch.from_numpy(rng.random((7, 13)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((7, 13)).astype(np.float32))
    a, b = fg.fused_gram_vector_library(factors, idx, w, c)
    want_a, want_b = fg.fused_gram_vector_reference(factors, idx, w, c)
    assert a.dtype == b.dtype == torch.float32
    assert a.shape == (7, rank, rank) and b.shape == (7, rank)
    torch.testing.assert_close(a, want_a, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(b, want_b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_pallas", [None, True, False])
@pytest.mark.parametrize("rank", [1, 8, 64, 128, 255, 256, 257, 300, 512])
def test_gram_route_is_the_references_bucket_choice(rank, use_pallas,
                                                    monkeypatch):
    """The reference's choice as on a TPU (``pallas_supported`` true, the
    backend where ``use_pallas=None`` turns the kernel on), the port's
    for a CUDA device: K1 exactly where the reference takes its kernel."""
    monkeypatch.setattr(jax_als, "pallas_supported", lambda: True)
    bucket = [("plain", np.zeros((8, 16), np.int32))]
    ref = jax_als._resolve_loop_statics(
        jax_als.ALSConfig(rank=rank, use_pallas=use_pallas), bucket, bucket)
    port = port_als._resolve_loop_statics(
        port_als.ALSConfig(rank=rank, use_pallas=use_pallas),
        torch.device("cuda"))
    assert ref["pallas_flags"] == ((port["gram_route"] == "k1",),) * 2
    assert port["gram_route"] == (
        "k1" if use_pallas is not False and rank <= 256 else "library")


@pytest.mark.parametrize("template", ["recommendation", "similarproduct",
                                      "ecommerce"])
def test_templates_train_at_rank_300_through_pio_train(
        template, tmp_path, monkeypatch, capsys, routes):
    import json
    from pathlib import Path

    from predictionio_tpu_torch.cli.main import main
    from predictionio_tpu_torch.data.storage import (get_storage,
                                                     reset_storage)
    from test_torch_cli import _clean_env, _write_events

    root = Path(__file__).resolve().parents[1]
    home = tmp_path / "home"
    home.mkdir()
    _clean_env(monkeypatch, home)
    try:
        assert main(["app", "new", "qsapp"]) == 0
        events = _write_events(tmp_path / "ev.jsonl")
        if template != "recommendation":
            # similarproduct and ecommerce read view/buy events
            lines = [json.loads(x) for x in events.read_text().splitlines()]
            for ev in lines:
                ev["event"] = "view" if ev["event"] == "rate" else "buy"
                ev.pop("properties", None)
            events.write_text("".join(json.dumps(ev) + "\n" for ev in lines))
        assert main(["import", "--appid", "1", "--input", str(events)]) == 0
        spec = json.loads((root / "predictionio_tpu_torch" / "templates" /
                           template / "engine.json").read_text())
        spec["datasource"]["params"]["appName"] = "qsapp"
        params = spec["algorithms"][0]["params"]
        params.update(rank=300, numIterations=2)
        if "appName" in params:
            params["appName"] = "qsapp"      # ecommerce's algorithm reads it
        ej = tmp_path / "engine.json"
        ej.write_text(json.dumps(spec))
        assert main(["train", "--engine-json", str(ej), "--device",
                     "cpu"]) == 0
        assert "Training completed." in capsys.readouterr().out
        [row] = get_storage().get_engine_instances().get_all()
        assert row.status == "COMPLETED"
    finally:
        reset_storage()
    assert routes["library"] > 0 and routes["k1"] == 0
