"""Entry points: one forward step on the flagship model, and the
multi-device dry run.

Port of ``entry()`` and ``dryrun_multichip()`` in the repository's
``__graft_entry__.py``.  ``entry()``: the
two-tower retrieval model at the same shape (512 users × 1,024 items,
embed 64, hidden (128,), out 64, seed 0) encodes a batch of users and
takes the MIPS top-10 over the whole item corpus, through
:func:`predictionio_tpu_torch.ops.topk.top_k_scores`.  The reference's
forward reaches no Pallas kernel, and neither does this one.

Usage::

    from predictionio_tpu_torch.entry import entry

    forward, args = entry()              # on the CUDA card
    scores, ids = forward(*args)         # [8, 10] float32, [8, 10] int32
    forward, args = entry(device="cpu")  # the same on the CPU

``dryrun_multichip(n)`` runs the reference's parts on an n-position
mesh at its shapes, each held against the meshless port at the
reference's tolerances (an ``AssertionError`` names the part that
disagrees): one two-tower step with the production shardings on
``data × model`` (DP + TP), one DLRM step with the table row-sharded
over ``expert`` (EP), causal ring attention on ``sequence`` (SP), and
ALS on ``data`` — replicated, row-sharded, and row-sharded with windowed
gathers (whose user side must window).  On the card the n positions
share ``cuda:0`` (the ALS part launches the fused gram and ridge-solve
kernels on every shard); with ``device="cpu"`` they are n CPU
positions.  Returns each part's largest gap.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from predictionio_tpu_torch.device import device as resolve_device
from predictionio_tpu_torch.models.two_tower import (
    TwoTowerConfig,
    encode_items,
    encode_users,
    init_state,
)
from predictionio_tpu_torch.ops.topk import top_k_scores

__all__ = ["entry", "dryrun_multichip", "ENTRY_CONFIG"]

ENTRY_CONFIG = TwoTowerConfig(n_users=512, n_items=1024, embed_dim=64,
                              hidden_dims=(128,), out_dim=64, seed=0)


def entry(device: Optional[Union[str, torch.device]] = None
          ) -> Tuple[Callable[..., Tuple[torch.Tensor, torch.Tensor]],
                     Tuple[Any, ...]]:
    """``(forward, example_args)``: ``forward(params, user_ids)`` returns
    the top-10 ``(scores, ids)`` of each user over every item.  Runs on
    the CUDA card unless ``device="cpu"``; no CUDA and no ``"cpu"``
    raises."""
    dev = resolve_device(device)
    cfg = ENTRY_CONFIG
    state = init_state(cfg, device=dev)
    item_ids = torch.arange(cfg.n_items, device=dev)

    def forward(params, user_ids):
        q = encode_users(params, user_ids)
        corpus = encode_items(params, item_ids)
        return top_k_scores(q, corpus, 10)

    example_args = (state.params, torch.arange(8, device=dev))
    return forward, example_args


def _close(got, want, rtol: float, atol: float, what: str) -> float:
    got, want = (np.asarray(x.detach().cpu().numpy()
                            if isinstance(x, torch.Tensor) else x)
                 for x in (got, want))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)
    return float(np.max(np.abs(got - want))) if got.size else 0.0


def dryrun_multichip(n_devices: int,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> Dict[str, float]:
    """The reference's multi-chip dry run on ``n_devices`` mesh positions
    of ``device`` (the card unless ``"cpu"``); see the module
    docstring."""
    from predictionio_tpu_torch.models import als, dlrm
    from predictionio_tpu_torch.models import two_tower as tt
    from predictionio_tpu_torch.parallel.mesh import (
        AXIS_DATA,
        AXIS_EXPERT,
        AXIS_MODEL,
        AXIS_SEQUENCE,
        PartitionSpec as P,
        make_mesh,
        put_sharded,
    )
    from predictionio_tpu_torch.parallel.ring import (
        local_attention,
        ring_attention,
    )

    dev = resolve_device(device)
    if dev.type == "cuda":
        from predictionio_tpu_torch.device import set_float32_precision

        set_float32_precision()
    devices = [dev] * n_devices

    def mesh_of(sizes):
        return make_mesh(sizes, devices=devices)

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    gaps: Dict[str, float] = {}
    rng = np.random.default_rng(0)

    # -- DP + TP: two-tower train step on a data x model mesh --------------
    model_size = 2 if n_devices % 2 == 0 else 1
    mesh = mesh_of({AXIS_DATA: n_devices // model_size,
                    AXIS_MODEL: model_size})
    cfg = tt.TwoTowerConfig(n_users=64, n_items=32, embed_dim=16,
                            hidden_dims=(32,), out_dim=16, batch_size=16,
                            seed=0)
    u = rng.integers(0, 64, 16).astype(np.int32)
    i = rng.integers(0, 32, 16).astype(np.int32)
    w = np.ones(16, np.float32)
    state, loss = tt.train_step(
        tt.init_state(cfg, mesh),
        *(put_sharded(a, mesh, P(AXIS_DATA)) for a in (u, i, w)), cfg)
    ref_state, ref_loss = tt.train_step(tt.init_state(cfg, device=dev),
                                        on(u), on(i), on(w), cfg)
    gaps["two_tower_loss"] = _close(loss, ref_loss, 1e-5, 1e-6,
                                    "two-tower loss")
    gaps["two_tower_user_embed"] = _close(
        state.params["user_embed"].to_host(),
        ref_state.params["user_embed"], 1e-5, 1e-6, "two-tower user_embed")

    # -- EP: DLRM train step with expert-sharded embedding tables ----------
    emesh = mesh_of({AXIS_EXPERT: n_devices})
    dcfg = dlrm.DLRMConfig(vocab_sizes=(8 * n_devices, 8 * n_devices),
                           n_dense=4, embed_dim=8, bottom_mlp=(16, 8),
                           top_mlp=(16,), batch_size=2 * n_devices, seed=0)
    bs = dcfg.batch_size
    dense = rng.standard_normal((bs, 4)).astype(np.float32)
    cat = rng.integers(0, 8 * n_devices, (bs, 2)).astype(np.int32)
    y = np.ones(bs, np.float32)
    wts = np.ones(bs, np.float32)
    _, dloss = dlrm.train_step(
        dlrm.init_state(dcfg, emesh),
        *(put_sharded(a, emesh, P(AXIS_EXPERT))
          for a in (dense, cat, y, wts)), dcfg, emesh)
    _, dref_loss = dlrm.train_step(dlrm.init_state(dcfg, device=dev),
                                   on(dense), on(cat), on(y), on(wts), dcfg)
    gaps["dlrm_loss"] = _close(dloss, dref_loss, 1e-5, 1e-6, "DLRM loss")

    # -- SP: ring attention over a sequence-sharded context ----------------
    smesh = mesh_of({AXIS_SEQUENCE: n_devices})
    qkv = on(rng.standard_normal((1, 4 * n_devices, 2, 8)).astype(np.float32))
    out = ring_attention(qkv, qkv, qkv, smesh, causal=True).full()
    gaps["ring_attention"] = _close(
        out, local_attention(qkv, qkv, qkv, causal=True), 1e-4, 1e-5,
        "causal ring attention")

    # -- DP over solve rows: ALS on a data mesh ----------------------------
    amesh = mesh_of({AXIS_DATA: n_devices})
    n_u, n_i, n_r = 8 * n_devices, 16, 64 * n_devices
    au = rng.integers(0, n_u, n_r)
    ai = rng.integers(0, n_i, n_r)
    ar = rng.integers(1, 6, n_r).astype(np.float32)
    acfg = als.ALSConfig(rank=8, iterations=2, seed=0)
    aref = als.train_als(au, ai, ar, n_u, n_i, acfg, device=dev)
    amodel = als.train_als(au, ai, ar, n_u, n_i, acfg, mesh=amesh)
    gaps["als_replicated"] = max(
        _close(amodel.user_factors, aref.user_factors, 1e-4, 1e-5,
               "ALS replicated users"),
        _close(amodel.item_factors, aref.item_factors, 1e-4, 1e-5,
               "ALS replicated items"))
    bcfg = als.ALSConfig(rank=8, iterations=2, seed=0,
                         factor_sharding="sharded")
    binputs = als.prepare_als_inputs(au, ai, ar, n_u, n_i, bcfg, mesh=amesh)
    assert binputs.uf0.spec[0] == AXIS_DATA, \
        "blocked ALS must keep its factors row-sharded"
    bmodel = als.train_als_prepared(binputs, bcfg)
    gaps["als_sharded"] = _close(bmodel.user_factors, aref.user_factors,
                                 1e-4, 1e-5, "ALS row-sharded users")

    # Windowed blocked ALS: the user side's chunks touch only the first
    # 8 of at least 192 items, so their gathers window.
    wn_i = max(192, 64 * n_devices)
    wi = rng.integers(0, 8, n_r)
    wcfg = als.ALSConfig(rank=8, iterations=2, seed=0, bucket_bounds=(16,),
                         factor_sharding="sharded", gather_window=True)
    winputs = als.prepare_als_inputs(au, wi, ar, n_u, wn_i, wcfg,
                                     mesh=amesh)
    assert any(c.win is not None for c in winputs.user_buckets), \
        "windowed mode must engage on the user side at this shape"
    wmodel = als.train_als_prepared(winputs, wcfg)
    wref_b = als.train_als(au, wi, ar, n_u, wn_i, als.ALSConfig(
        rank=8, iterations=2, seed=0, bucket_bounds=(16,),
        factor_sharding="sharded", gather_window=False), mesh=amesh)
    gaps["als_windowed"] = max(
        _close(wmodel.user_factors, wref_b.user_factors, 1e-6, 1e-6,
               "ALS windowed users"),
        _close(wmodel.item_factors, wref_b.item_factors, 1e-6, 1e-6,
               "ALS windowed items"))
    wref = als.train_als(au, wi, ar, n_u, wn_i, als.ALSConfig(
        rank=8, iterations=2, seed=0, bucket_bounds=(16,)), device=dev)
    gaps["als_windowed_vs_meshless"] = _close(
        wmodel.user_factors, wref.user_factors, 2e-2, 1e-3,
        "ALS windowed vs meshless users")
    return gaps
