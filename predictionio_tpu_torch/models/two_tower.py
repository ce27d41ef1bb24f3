"""Two-tower neural retrieval: learned user/item embeddings + MLP towers
trained with in-batch sampled-softmax negatives; retrieval is MIPS top-k
over the encoded items.

Port of ``predictionio_tpu/models/two_tower.py`` on one device (the card
unless ``device="cpu"`` is asked for); the mesh and ``param_shardings``
are not ported (``mesh`` must be None: ROADMAP Queue 1 item 10b).  The numerics are the
reference's:

- init: the reference's ``jax.random`` tree drawn by
  :mod:`~predictionio_tpu_torch.ops.threefry` (key of the seed, a 4-way
  split, one split per MLP layer, ``normal * scale`` tables and He-init
  weights), within 4 float32 ulps of JAX's (the erfinv of
  :mod:`~predictionio_tpu_torch.ops.threefry`; 3 measured);
- the towers (:func:`_mlp`): operands rounded to bfloat16, multiplied
  with float32 accumulation (``h.bf16.float() @ w.bf16.float()`` in full
  float32 — the products of bfloat16 values are exact in float32, so
  only the order of summation differs from XLA's), the bias added in
  float32, ReLU, the activation rounded back to bfloat16 between layers;
  the casts' backward rounds the cotangent to bfloat16 as JAX's does;
- the loss (:func:`_loss`): in-batch softmax with duplicate items and
  weight-0 pad columns masked to -1e9, each row keeping its diagonal,
  the weighted mean over ``max(Σw, 1)``; ``z / (‖z‖ + 1e-6)`` outputs;
- the optimizer: ``optax.adam(lr)`` written out (b1 0.9, b2 0.999, eps
  1e-8, eps_root 0, optax's bias correction, its order of operations),
  DENSE over every leaf as the reference's is, with ``torch._foreach_*``;
  the state mirrors optax's tree (``(AdamState(count, mu, nu),
  EmptyState())``), so :func:`state_to_host` / :func:`state_from_host`
  carry a generation across packages;
- the embedding gathers' backward (a scatter-add of the row gradients)
  is :class:`~predictionio_tpu_torch.ops.embedding.GatherRows`'s
  deterministic one, so a step gives the same bits every time on the
  card as on the CPU.

A step is functional: it returns a new state and leaves its input
untouched.  A fused window (:func:`train_steps_fused`) is K steps issued
back to back with no host sync inside, returning the ``[K]`` loss
vector — bitwise K calls of :func:`train_step`.  :func:`train` is the
reference's loop: the prefetcher, K-step fusion and its autotuner, the
divergence guard with checkpoint rollback, the step watchdog,
preemption, and warm continuation.  ``data_source="auto"`` trains on the
native feeder's permutation (the reference's CPU runs build it too); a
failed build raises with the compiler's message instead of falling
back to ``"numpy"``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.device import device as resolve_device
from predictionio_tpu_torch.ops import threefry
from predictionio_tpu_torch.ops.embedding import GatherRows

_NO_MESH = ("two-tower on a device mesh (param_shardings) is not ported "
            "yet (ROADMAP Queue 1 item 10b); pass mesh=None")

__all__ = ["TwoTowerConfig", "TwoTowerState", "AdamState", "EmptyState",
           "init_params", "init_state", "train_step", "train_steps_fused",
           "train", "grow_state", "state_to_host", "state_from_host",
           "eval_loss", "encode_users", "encode_items", "retrieve"]

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class TwoTowerConfig:
    n_users: int
    n_items: int
    embed_dim: int = 64
    hidden_dims: Tuple[int, ...] = (128,)
    out_dim: int = 64
    learning_rate: float = 1e-3
    temperature: float = 0.05
    batch_size: int = 1024
    epochs: int = 5
    seed: int = 0


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: the step count and both moments,
    each moment tree mirroring ``params``."""

    count: Any
    mu: Any
    nu: Any


class EmptyState(NamedTuple):
    """optax's ``EmptyState`` (the learning-rate scale keeps none)."""


@dataclasses.dataclass
class TwoTowerState:
    params: Dict
    opt_state: Any      # (AdamState(count: int, mu, nu), EmptyState())
    step: int


# -- parameter trees ---------------------------------------------------------

def _leaves(tree: Dict) -> List[Any]:
    """The leaves of a params-shaped tree in one fixed order."""
    out = [tree["user_embed"], tree["item_embed"]]
    for tower in ("user_mlp", "item_mlp"):
        for layer in tree[tower]["layers"]:
            out += [layer["w"], layer["b"]]
    return out


def _unflatten(like: Dict, leaves: List[Any]) -> Dict:
    """A tree shaped like ``like`` holding ``leaves`` (:func:`_leaves`
    order)."""
    it = iter(leaves)
    out = {"user_embed": next(it), "item_embed": next(it)}
    for tower in ("user_mlp", "item_mlp"):
        out[tower] = {"layers": [{"w": next(it), "b": next(it)}
                                 for _ in like[tower]["layers"]]}
    return out


def _map(fn, tree: Dict) -> Dict:
    return _unflatten(tree, [fn(x) for x in _leaves(tree)])


def _init_mlp(key: np.ndarray, in_dim: int, hidden: Tuple[int, ...],
              out_dim: int) -> Dict:
    layers = []
    dims = (in_dim, *hidden, out_dim)
    for a, b in zip(dims[:-1], dims[1:]):
        key, k = threefry.split(key)
        layers.append({
            "w": threefry.normal(k, (a, b)) * np.float32((2.0 / a) ** 0.5),
            "b": np.zeros((b,), np.float32),
        })
    return {"layers": layers}


def init_params_host(cfg: TwoTowerConfig) -> Dict:
    """The reference's initial parameters as float32 numpy."""
    ku, ki, ku2, ki2 = threefry.split(threefry.seed_key(cfg.seed), 4)
    scale = np.float32(cfg.embed_dim ** -0.5)
    return {
        "user_embed": threefry.normal(ku, (cfg.n_users, cfg.embed_dim))
        * scale,
        "item_embed": threefry.normal(ki, (cfg.n_items, cfg.embed_dim))
        * scale,
        "user_mlp": _init_mlp(ku2, cfg.embed_dim, cfg.hidden_dims,
                              cfg.out_dim),
        "item_mlp": _init_mlp(ki2, cfg.embed_dim, cfg.hidden_dims,
                              cfg.out_dim),
    }


def init_params(cfg: TwoTowerConfig, device=None) -> Dict:
    dev = resolve_device(device)
    return _map(lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev),
                init_params_host(cfg))


def _zero_opt_state(params: Dict) -> Tuple:
    zeros = lambda t: torch.zeros_like(t)  # noqa: E731
    return (AdamState(count=0, mu=_map(zeros, params),
                      nu=_map(zeros, params)), EmptyState())


def init_state(cfg: TwoTowerConfig, mesh=None, *,
               device=None) -> TwoTowerState:
    if mesh is not None:
        raise NotImplementedError(_NO_MESH)
    params = init_params(cfg, device)
    return TwoTowerState(params=params, opt_state=_zero_opt_state(params),
                         step=0)


def state_to_host(state: TwoTowerState) -> Dict:
    """Host-numpy snapshot of a train state, laid out as the reference's
    (``params``; ``opt_state`` = ``(AdamState(count, mu, nu),
    EmptyState())``; ``step``) — exact float32 values, so a warm-started
    continuation equals continuing in-process, and the reference's
    ``state_from_host`` takes it."""
    to_np = lambda t: t.detach().cpu().numpy()  # noqa: E731
    adam = state.opt_state[0]
    return {"params": _map(to_np, state.params),
            "opt_state": (AdamState(count=np.asarray(int(adam.count),
                                                     np.int32),
                                    mu=_map(to_np, adam.mu),
                                    nu=_map(to_np, adam.nu)),
                          EmptyState()),
            "step": np.asarray(int(state.step), np.int32)}


def state_from_host(snapshot: Dict, device=None) -> TwoTowerState:
    """Rebuild a live state from a :func:`state_to_host` snapshot — the
    port's or the reference's (its optax state is a ``(count, mu, nu)``
    named tuple too) — on ``device``."""
    dev = resolve_device(device)
    put = lambda a: torch.from_numpy(  # noqa: E731
        np.array(a, np.float32)).to(dev)
    count, mu, nu = snapshot["opt_state"][0]
    return TwoTowerState(
        params=_map(put, snapshot["params"]),
        opt_state=(AdamState(count=int(np.asarray(count)),
                             mu=_map(put, mu), nu=_map(put, nu)),
                   EmptyState()),
        step=int(np.asarray(snapshot["step"])))


def grow_state(state: TwoTowerState, cfg: TwoTowerConfig) -> TwoTowerState:
    """Grow the embedding tables for entities first seen in a delta
    window (the warm-start refresh).

    Existing rows keep their trained values AND their adam moments; new
    rows get the reference's deterministic init (keyed off ``cfg.seed``
    and the CURRENT table height through ``fold_in``) with zero moments.
    ``cfg`` carries the NEW ``n_users``/``n_items``."""
    params = dict(state.params)
    scale = np.float32(cfg.embed_dim ** -0.5)

    def grown(table: torch.Tensor, n_total: int, salt: int) -> torch.Tensor:
        n_old = table.shape[0]
        if n_total <= n_old:
            return table
        key = threefry.fold_in(threefry.seed_key(cfg.seed),
                               salt * 1_000_003 + n_old)
        fresh = threefry.normal(key, (n_total - n_old, cfg.embed_dim)) * scale
        return torch.cat([table, torch.from_numpy(fresh).to(table.device)])

    params["user_embed"] = grown(params["user_embed"], cfg.n_users, 1)
    params["item_embed"] = grown(params["item_embed"], cfg.n_items, 2)
    adam = state.opt_state[0]

    def merge(old: torch.Tensor, new_like: torch.Tensor) -> torch.Tensor:
        if old.shape == new_like.shape:
            return old
        out = torch.zeros_like(new_like)
        out[: old.shape[0]] = old
        return out

    mu = _unflatten(params, [merge(o, p) for o, p in
                             zip(_leaves(adam.mu), _leaves(params))])
    nu = _unflatten(params, [merge(o, p) for o, p in
                             zip(_leaves(adam.nu), _leaves(params))])
    return TwoTowerState(params=params,
                         opt_state=(AdamState(adam.count, mu, nu),
                                    EmptyState()),
                         step=state.step)


# -- the model ---------------------------------------------------------------

def _mlp(params: Dict, x: torch.Tensor) -> torch.Tensor:
    h = x.to(torch.bfloat16)
    n = len(params["layers"])
    for i, layer in enumerate(params["layers"]):
        h = h.float() @ layer["w"].to(torch.bfloat16).float()
        h = h + layer["b"]
        if i < n - 1:
            h = torch.relu(h)
        h = h.to(torch.bfloat16)
    return h.float()


def _normalized(z: torch.Tensor) -> torch.Tensor:
    return z / (torch.linalg.vector_norm(z, dim=-1, keepdim=True) + 1e-6)


def _forward_users(params: Dict, user_ids: torch.Tensor) -> torch.Tensor:
    e = GatherRows.apply(params["user_embed"], user_ids)
    return _normalized(_mlp(params["user_mlp"], e))


def _forward_items(params: Dict, item_ids: torch.Tensor) -> torch.Tensor:
    e = GatherRows.apply(params["item_embed"], item_ids)
    return _normalized(_mlp(params["item_mlp"], e))


def _loss(params: Dict, user_ids, item_ids, weights,
          temperature: float) -> torch.Tensor:
    """In-batch sampled softmax: positives on the diagonal.

    Duplicate items inside the batch are masked out of the negatives,
    and so are weight-0 padding columns; each row keeps its own
    diagonal, so no row is fully masked.  The cross entropy is optax's
    ``softmax_cross_entropy_with_integer_labels`` (logsumexp over the
    row, shifted by its stop-gradient max, minus the label logit)."""
    u = _forward_users(params, user_ids)       # [B, D]
    v = _forward_items(params, item_ids)       # [B, D]
    logits = (u @ v.T) / temperature
    b = item_ids.shape[0]
    same = item_ids[:, None] == item_ids[None, :]
    pad_col = (weights <= 0.0)[None, :]
    eye = torch.eye(b, dtype=torch.bool, device=logits.device)
    logits = logits.masked_fill((same | pad_col) & ~eye, -1e9)
    top = logits.max(dim=-1, keepdim=True).values.detach()
    log_norm = torch.log(torch.exp(logits - top).sum(dim=-1)) + top[:, 0]
    losses = log_norm - logits.diagonal()
    return (losses * weights).sum() / torch.clamp(weights.sum(), min=1.0)


def _adam(params: List[torch.Tensor], grads: List[torch.Tensor],
          adam: AdamState, lr: float) -> Tuple[List[torch.Tensor],
                                               AdamState]:
    """One ``optax.adam(lr)`` update, out of place, in optax's order:
    ``mu = (1-b1)·g + b1·mu``, ``nu = (1-b2)·g² + b2·nu``, both divided
    by ``1 - b**count`` (float32), ``u = m̂ / (√v̂ + eps) · -lr``,
    ``p + u``."""
    count = int(adam.count) + 1
    mu_l, nu_l = _leaves(adam.mu), _leaves(adam.nu)
    mu = torch._foreach_mul(grads, 1 - _B1)
    torch._foreach_add_(mu, torch._foreach_mul(mu_l, _B1))
    nu = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(nu, 1 - _B2)
    torch._foreach_add_(nu, torch._foreach_mul(nu_l, _B2))
    one = np.float32(1.0)
    bc1 = float(one - np.power(np.float32(_B1), np.float32(count)))
    bc2 = float(one - np.power(np.float32(_B2), np.float32(count)))
    den = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, _EPS)
    upd = torch._foreach_div(mu, bc1)
    torch._foreach_div_(upd, den)
    torch._foreach_mul_(upd, -lr)
    new = torch._foreach_add(params, upd)
    like = adam.mu
    return new, AdamState(count, _unflatten(like, mu), _unflatten(like, nu))


def _step_math(state: TwoTowerState, user_ids, item_ids, weights,
               cfg: TwoTowerConfig) -> Tuple[TwoTowerState, torch.Tensor]:
    """One optimizer step's math — shared verbatim by :func:`train_step`
    and the fused window, so fused training is the same computation."""
    leaves = [p.detach().requires_grad_(True)
              for p in _leaves(state.params)]
    params = _unflatten(state.params, leaves)
    loss = _loss(params, user_ids, item_ids, weights, cfg.temperature)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        new, adam = _adam([p.detach() for p in leaves], list(grads),
                          state.opt_state[0], float(cfg.learning_rate))
    return (TwoTowerState(params=_unflatten(state.params, new),
                          opt_state=(adam, state.opt_state[1]),
                          step=int(state.step) + 1),
            loss.detach())


def train_step(state: TwoTowerState, user_ids, item_ids, weights,
               cfg: TwoTowerConfig) -> Tuple[TwoTowerState, torch.Tensor]:
    """One optimizer step on one batch (tensors on the state's device);
    returns the new state and the loss (0-dim tensor)."""
    return _step_math(state, user_ids, item_ids, weights, cfg)


def train_steps_fused(state: TwoTowerState, user_ids, item_ids, weights,
                      cfg: TwoTowerConfig
                      ) -> Tuple[TwoTowerState, torch.Tensor]:
    """K optimizer steps issued back to back with no host sync: the batch
    tensors carry a leading slot axis ([K, B]); returns the state after
    the K-th step and the per-step loss vector [K].  Bitwise K
    sequential :func:`train_step` calls on the same batches."""
    losses = []
    for k in range(user_ids.shape[0]):
        state, loss = _step_math(state, user_ids[k], item_ids[k],
                                 weights[k], cfg)
        losses.append(loss)
    return state, torch.stack(losses)


def _ckpt_state(state: TwoTowerState) -> Tuple:
    return (state.params, state.opt_state, state.step)


def train(
    user_ids: np.ndarray,
    item_ids: np.ndarray,
    cfg: TwoTowerConfig,
    mesh=None,
    weights: Optional[np.ndarray] = None,
    *,
    checkpoint_dir=None,
    save_every: int = 0,
    data_source: str = "auto",
    fuse_steps=None,
    warm_state: Optional[TwoTowerState] = None,
    device=None,
) -> TwoTowerState:
    """Minibatch training loop over interaction pairs (the reference's).

    ``warm_state``: continue from an existing state (already grown to
    ``cfg``'s table heights by :func:`grow_state`) instead of a fresh
    init; ``user_ids``/``item_ids`` then carry only the delta window.
    The trailing ragged batch is padded with weight-0 rows.  With
    ``checkpoint_dir`` + ``save_every`` the loop checkpoints and resumes
    mid-epoch after a crash (the per-epoch shuffles are deterministic,
    so skipped batches are exact).

    ``data_source``: ``"feeder"`` pulls epochs from the native mmap event
    cache (batch assembly in C++); ``"numpy"`` keeps the host
    permutation; ``"auto"`` is the feeder.  Supervision: a non-finite
    loss rolls back to the last-good checkpoint (bounded retries, then
    ``TrainDiverged``); SIGTERM preemption checkpoints and raises
    ``TrainPreempted``; ``PIO_STEP_TIMEOUT_S`` arms the watchdog.
    ``fuse_steps`` (default: env ``PIO_FUSE_STEPS``, else 1) issues K
    steps per window (``"auto"``: the HBM-guided autotuner); supervision
    then sits at the window boundary.  ``device``: the card unless
    ``"cpu"`` is asked for.
    """
    from predictionio_tpu_torch.resilience.supervision import (
        DivergenceGuard,
        RollbackRequested,
    )

    if mesh is not None:
        raise NotImplementedError(_NO_MESH)
    if data_source not in ("auto", "feeder", "numpy"):
        raise ValueError(f"data_source {data_source!r}: use auto, feeder "
                         "or numpy")
    if device is None and warm_state is not None:
        device = warm_state.params["user_embed"].device
    dev = resolve_device(device)
    if dev.type == "cuda":
        from predictionio_tpu_torch.device import set_float32_precision

        set_float32_precision()
    # Without a checkpointer a "rollback" is a full deterministic retrain
    # that reproduces the same NaN — terminal immediately.
    can_rollback = bool(checkpoint_dir) and save_every > 0
    guard = DivergenceGuard("two_tower",
                            max_rollbacks=None if can_rollback else 0)
    while True:
        try:
            return _train_attempt(user_ids, item_ids, cfg, weights,
                                  checkpoint_dir=checkpoint_dir,
                                  save_every=save_every,
                                  data_source=data_source, guard=guard,
                                  fuse_steps=fuse_steps,
                                  warm_state=warm_state, dev=dev)
        except RollbackRequested:
            continue  # re-enter: restore_step fast-forwards to last-good


def _train_attempt(user_ids, item_ids, cfg: TwoTowerConfig, weights, *,
                   checkpoint_dir, save_every: int, data_source: str, guard,
                   fuse_steps, warm_state: Optional[TwoTowerState],
                   dev: torch.device) -> TwoTowerState:
    from predictionio_tpu_torch.data.fusion import (
        FusionAutotuner,
        FusionPlan,
        crossed_save_point,
        fuse_steps_config,
        slot_steps,
    )
    from predictionio_tpu_torch.data.prefetch import DevicePrefetcher
    from predictionio_tpu_torch.obs.pipeline import PipelineProbe
    from predictionio_tpu_torch.resilience.supervision import (
        StepWatchdog,
        TrainPreempted,
        preemption_requested,
    )
    from predictionio_tpu_torch.workflow.checkpoint import TrainCheckpointer

    n = len(user_ids)
    if weights is None:
        weights = np.ones(n, dtype=np.float32)
    state = warm_state if warm_state is not None \
        else init_state(cfg, device=dev)
    total_steps = cfg.epochs * ((n + cfg.batch_size - 1) // cfg.batch_size)
    # Warm continuations fingerprint on the carried step too: a crash-
    # resume checkpoint from a DIFFERENT base generation must not be
    # restored into this delta.
    fp_extra = f"|warm@{int(state.step)}" if warm_state is not None else ""
    ckpt = TrainCheckpointer(checkpoint_dir or ".", save_every=save_every
                             if checkpoint_dir else 0,
                             fingerprint=f"two_tower|{cfg}|n={n}{fp_extra}")
    watchdog = StepWatchdog("two_tower", checkpoint_fn=ckpt.flush)
    start_step = ckpt.restore_step(_ckpt_state(state),
                                   total_steps=total_steps)
    if ckpt.restored_state is not None:
        p, o, s = ckpt.restored_state
        state = TwoTowerState(params=p, opt_state=o, step=int(s))
    bs = cfg.batch_size

    def numpy_epochs():
        for epoch in range(cfg.epochs):
            order = np.random.default_rng(cfg.seed + epoch).permutation(n)
            for start in range(0, n, bs):
                sel = order[start:start + bs]
                yield user_ids[sel], item_ids[sel], weights[sel]

    def feeder_epochs():
        import tempfile

        from predictionio_tpu_torch.native.feeder import (
            EventFeeder,
            write_cache,
        )

        with tempfile.TemporaryDirectory(prefix="pio_tt_cache_") as d:
            cache = write_cache(f"{d}/train.piof",
                                np.asarray(user_ids, np.uint32),
                                np.asarray(item_ids, np.uint32),
                                np.asarray(weights, np.float32))
            with EventFeeder(cache, bs, seed=cfg.seed) as f:
                for _ in range(cfg.epochs):
                    yield from f.epoch()

    if data_source in ("auto", "feeder"):
        # Build (or find) the library here, on the calling thread: a
        # failed build raises with the compiler's message before any
        # thread starts.
        from predictionio_tpu_torch.native.build import load_library

        load_library("feeder")
        source = feeder_epochs()
    else:
        source = numpy_epochs()

    def prep(batch):
        # Prep-thread staging: int32 ids, float32 weights, weight-0 tail
        # padding — the reference's inline layout.
        u, i, w = batch
        pad = bs - len(u)
        return (
            np.concatenate([np.asarray(u, np.int64),
                            np.zeros(pad, np.int64)]).astype(np.int32),
            np.concatenate([np.asarray(i, np.int64),
                            np.zeros(pad, np.int64)]).astype(np.int32),
            np.concatenate([np.asarray(w, np.float32),
                            np.zeros(pad, np.float32)]),
        )

    k0, auto = fuse_steps_config(fuse_steps)
    plan = FusionPlan(k0)
    tuner = FusionAutotuner("two_tower", plan) if auto else None

    probe = PipelineProbe("two_tower")
    global_step = start_step
    pending = None  # (losses, slot steps) of the in-flight dispatch
    in_flight = 0  # raw steps covered by the in-flight dispatch
    try:
        with DevicePrefetcher(source, prep, device=dev,
                              skip_steps=start_step, fuse_plan=plan,
                              model="two_tower") as pf:
            for batch in probe.iter_prefetched(pf):
                global_step = batch.step
                # The deadline covers the LONGER of the in-flight
                # dispatch (the sync below waits on it) and this one.
                watchdog.arm(global_step,
                             scale=max(batch.steps, in_flight))
                probe.sync()  # wait on dispatch N-1: its state feeds N
                if pending is not None:
                    # Every slot of the finished window is checked at the
                    # fusion boundary for one host read of K floats.
                    guard.check_vector(*pending)
                if batch.k > 1:
                    state, losses = train_steps_fused(state, *batch.args,
                                                      cfg)
                else:
                    state, losses = train_step(state, *batch.args, cfg)
                pending = (losses, slot_steps(batch))
                in_flight = batch.steps
                probe.dispatched((state, losses), examples=batch.examples,
                                 steps=batch.steps)
                saved = False
                if ckpt.enabled and crossed_save_point(
                        global_step, batch.steps, ckpt.save_every):
                    # Never checkpoint unvalidated state: check this
                    # window's losses first, under a fresh deadline, so a
                    # rollback target is always finite AND a window
                    # boundary.
                    watchdog.arm(global_step, scale=batch.steps)
                    guard.check_vector(*pending)
                    if global_step % ckpt.save_every == 0:
                        saved = ckpt.maybe_save(global_step,
                                                _ckpt_state(state))
                    else:
                        ckpt.save(global_step, _ckpt_state(state))
                        saved = True
                watchdog.disarm()
                if tuner is not None:
                    tuner.on_window()
                if preemption_requested():
                    if ckpt.enabled and not saved:
                        ckpt.save(global_step, _ckpt_state(state))
                    ckpt.flush()
                    raise TrainPreempted("two_tower", global_step,
                                         ckpt.enabled)
        probe.finish()
        if pending is not None:
            guard.check_vector(*pending)
        guard.check_params(state.params, global_step)
        ckpt.complete()
    finally:
        # Close on EVERY path: a rollback re-entry reopens the directory.
        watchdog.stop()
        ckpt.close()
    return state


def _ids(ids, dev: torch.device) -> torch.Tensor:
    if isinstance(ids, torch.Tensor):
        return ids.to(dev)
    return torch.from_numpy(np.asarray(ids, np.int64)).to(dev)


def eval_loss(params: Dict, user_ids, item_ids, cfg: TwoTowerConfig
              ) -> float:
    """In-batch sampled-softmax loss of ``params`` on one interaction
    sample — the warm-start regression gate's comparable scalar."""
    dev = params["user_embed"].device
    u = _ids(np.asarray(user_ids, np.int32), dev)
    i = _ids(np.asarray(item_ids, np.int32), dev)
    w = torch.ones(u.shape[0], dtype=torch.float32, device=dev)
    with torch.no_grad():
        return float(_loss(params, u, i, w, cfg.temperature))


def encode_users(params: Dict, user_ids) -> torch.Tensor:
    with torch.no_grad():
        return _forward_users(params, _ids(user_ids,
                                           params["user_embed"].device))


def encode_items(params: Dict, item_ids) -> torch.Tensor:
    with torch.no_grad():
        return _forward_items(params, _ids(item_ids,
                                           params["item_embed"].device))


def retrieve(params: Dict, user_ids, n_items: int, k: int,
             *, chunk: Optional[int] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k MIPS over all item embeddings (train-side eval utility;
    serving goes through :mod:`predictionio_tpu_torch.retrieval`).

    With ``chunk`` the scan goes through :func:`~predictionio_tpu_torch.
    ops.fused_topk.fused_topk` — the fused top-k kernel (K3) on a CUDA
    tensor, which plans its own tiles (``chunk`` sizes only the
    reference's fallback scan), its plain version on the CPU; without it
    the exact ``matmul`` + ``topk``."""
    from predictionio_tpu_torch.ops.fused_topk import fused_topk
    from predictionio_tpu_torch.ops.topk import top_k_scores

    q = encode_users(params, user_ids).contiguous()
    all_items = encode_items(
        params, torch.arange(n_items, device=params["item_embed"].device)
    ).contiguous()
    if chunk:
        return fused_topk(q, all_items, k)
    return top_k_scores(q, all_items, k)
