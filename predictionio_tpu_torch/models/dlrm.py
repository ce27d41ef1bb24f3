"""DLRM-style CTR ranking: embedding tables + dense interaction.

Port of ``predictionio_tpu/models/dlrm.py`` on one device (the card
unless ``device="cpu"`` is asked for).  The expert-sharded lookup
(``param_shardings``, ``sharded_embedding_lookup``) needs the mesh and is
not ported: ``mesh`` must be None (ROADMAP Queue 1 item 10b).  The
numerics are the reference's:

- init: the reference's ``jax.random`` tree drawn by
  :mod:`~predictionio_tpu_torch.ops.threefry` (key of the seed, a 3-way
  split, one split per MLP layer; the concatenated ``[ΣV, E]`` table is
  ``normal · E^-0.5``, each weight He-init ``normal · √(2/max(a, 1))``, so
  ``n_dense == 0`` gives the bottom MLP a zero-width input);
- the MLPs (:func:`_mlp`): each layer rounds its input AND its weight to
  bfloat16, multiplies in float32 (the products of bfloat16 values are
  exact in float32, so only the order of summation differs from XLA's),
  adds the float32 bias and applies ReLU (the top MLP's last layer
  skips it).  Unlike the two-tower model, the activation stays float32
  between layers;
- the interaction (:func:`_interact`): the float32 ``bmm`` of the
  ``[B, F+1, E]`` stack of the field embeddings and the bottom MLP's
  output with itself, its strict upper triangle in ``triu_indices``
  order, then the bottom output;
- the loss: optax's ``sigmoid_binary_cross_entropy`` written out,
  ``-y·logσ(x) - (1-y)·logσ(-x)``, weighted, over ``max(Σw, 1)``;
- the optimizer: ``optax.adagrad(lr)`` (optax 0.2.6) written out, DENSE
  over every leaf as the reference's is: the accumulator starts at 0.1,
  ``s = g² + s``, ``u = where(s > 0, rsqrt(s + 1e-7), 0) · g · -lr``,
  ``p + u``; the state mirrors optax's tree (``(RssState(sum_of_squares),
  EmptyState())``), so :func:`state_to_host` / :func:`state_from_host`
  carry a generation across packages;
- the embedding lookup's backward is
  :class:`~predictionio_tpu_torch.ops.embedding.GatherRows`'s
  deterministic scatter, so a step gives the same bits every time on the
  card as on the CPU.

A step is functional: it returns a new state and leaves its input
untouched.  A fused window (:func:`train_steps_fused`) is K steps issued
back to back with no host sync inside, returning the ``[K]`` loss
vector — bitwise K calls of :func:`train_step`.  :func:`train` is the
reference's loop (the prefetcher, K-step fusion and its autotuner, the
divergence guard with checkpoint rollback, the step watchdog,
preemption, warm continuation); ``data_source="auto"`` trains on the
native feeder's permutation, and a failed build raises with the
compiler's message instead of falling back to ``"numpy"``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from predictionio_tpu_torch.device import device as resolve_device
from predictionio_tpu_torch.models.two_tower import EmptyState
from predictionio_tpu_torch.ops import threefry
from predictionio_tpu_torch.ops.embedding import GatherRows

__all__ = ["DLRMConfig", "DLRMState", "RssState", "EmptyState",
           "init_params_host", "init_params", "init_state", "train_step",
           "train_steps_fused", "train", "state_to", "state_to_host",
           "state_from_host", "predict_proba"]

_INITIAL_ACCUMULATOR, _EPS = 0.1, 1e-7
_NO_MESH = ("DLRM on a device mesh (the expert-sharded embedding lookup) "
            "is not ported yet (ROADMAP Queue 1 item 10b); pass mesh=None")


@dataclasses.dataclass
class DLRMConfig:
    vocab_sizes: Tuple[int, ...]        # per categorical feature field
    n_dense: int                        # dense feature count
    embed_dim: int = 16
    bottom_mlp: Tuple[int, ...] = (64, 32)
    top_mlp: Tuple[int, ...] = (64, 32)
    learning_rate: float = 0.05
    batch_size: int = 512
    epochs: int = 2
    seed: int = 0

    def __post_init__(self):
        if self.bottom_mlp[-1] != self.embed_dim:
            raise ValueError(
                f"bottom_mlp[-1] ({self.bottom_mlp[-1]}) must equal embed_dim "
                f"({self.embed_dim}) — the dot interaction mixes them.")

    @property
    def total_vocab(self) -> int:
        return int(sum(self.vocab_sizes))

    @property
    def offsets(self) -> np.ndarray:
        """Row offset of each field's table in the concatenated table."""
        return np.cumsum([0, *self.vocab_sizes[:-1]]).astype(np.int32)


class RssState(NamedTuple):
    """optax's ``ScaleByRssState``: the running sum of squared gradients,
    a tree mirroring ``params``."""

    sum_of_squares: Any


@dataclasses.dataclass
class DLRMState:
    params: Dict
    opt_state: Any      # (RssState(sum_of_squares), EmptyState())
    step: int


# -- parameter trees ---------------------------------------------------------

def _leaves(tree: Dict) -> List[Any]:
    """The leaves of a params-shaped tree in one fixed order."""
    out = [tree["embed"]]
    for mlp in ("bottom", "top"):
        for layer in tree[mlp]:
            out += [layer["w"], layer["b"]]
    return out


def _unflatten(like: Dict, leaves: List[Any]) -> Dict:
    """A tree shaped like ``like`` holding ``leaves`` (:func:`_leaves`
    order)."""
    it = iter(leaves)
    out = {"embed": next(it)}
    for mlp in ("bottom", "top"):
        out[mlp] = [{"w": next(it), "b": next(it)} for _ in like[mlp]]
    return out


def _map(fn, tree: Dict) -> Dict:
    return _unflatten(tree, [fn(x) for x in _leaves(tree)])


def _init_mlp(key: np.ndarray, in_dim: int, dims: Tuple[int, ...]
              ) -> List[Dict]:
    layers = []
    all_dims = (in_dim, *dims)
    for a, b in zip(all_dims[:-1], all_dims[1:]):
        key, k = threefry.split(key)
        layers.append({
            # max(a, 1): n_dense == 0 gives the bottom MLP a zero-width
            # input ([B,0]·[0,H] = 0 + bias).
            "w": threefry.normal(k, (a, b))
            * np.float32((2.0 / max(a, 1)) ** 0.5),
            "b": np.zeros((b,), np.float32),
        })
    return layers


def init_params_host(cfg: DLRMConfig) -> Dict:
    """The reference's initial parameters as float32 numpy."""
    ke, kb, kt = threefry.split(threefry.seed_key(cfg.seed), 3)
    # Interaction: pairwise dots among (n_fields + 1) vectors (emb + bottom).
    n_vec = len(cfg.vocab_sizes) + 1
    inter_dim = n_vec * (n_vec - 1) // 2 + cfg.bottom_mlp[-1]
    return {
        "embed": threefry.normal(ke, (cfg.total_vocab, cfg.embed_dim))
        * np.float32(cfg.embed_dim ** -0.5),
        "bottom": _init_mlp(kb, cfg.n_dense, tuple(cfg.bottom_mlp)),
        "top": _init_mlp(kt, inter_dim, (*cfg.top_mlp, 1)),
    }


def init_params(cfg: DLRMConfig, device=None) -> Dict:
    dev = resolve_device(device)
    return _map(lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev),
                init_params_host(cfg))


def init_state(cfg: DLRMConfig, mesh=None, *, device=None) -> DLRMState:
    if mesh is not None:
        raise NotImplementedError(_NO_MESH)
    params = init_params(cfg, device)
    acc = _map(lambda t: torch.full_like(t, _INITIAL_ACCUMULATOR), params)
    return DLRMState(params=params,
                     opt_state=(RssState(acc), EmptyState()), step=0)


def state_to_host(state: DLRMState) -> Dict:
    """Host-numpy snapshot of a train state, laid out as the reference's
    (``params``; ``opt_state`` = ``(RssState(sum_of_squares),
    EmptyState())``; ``step``) — exact float32 values, so a warm-started
    continuation equals continuing in-process."""
    to_np = lambda t: t.detach().cpu().numpy()  # noqa: E731
    return {"params": _map(to_np, state.params),
            "opt_state": (RssState(_map(to_np,
                                        state.opt_state[0].sum_of_squares)),
                          EmptyState()),
            "step": np.asarray(int(state.step), np.int32)}


def state_from_host(snapshot, device=None) -> DLRMState:
    """Rebuild a live state on ``device`` from a :func:`state_to_host`
    snapshot, or from the reference's ``jax.tree.map(np.asarray,
    (params, opt_state, step))`` (its optax state is a
    ``(ScaleByRssState(sum_of_squares), EmptyState())`` tuple too)."""
    if isinstance(snapshot, Mapping):
        params, opt_state, step = (snapshot["params"],
                                   snapshot["opt_state"], snapshot["step"])
    else:
        params, opt_state, step = snapshot
    dev = resolve_device(device)
    put = lambda a: torch.from_numpy(  # noqa: E731
        np.array(a, np.float32)).to(dev)
    return DLRMState(params=_map(put, params),
                     opt_state=(RssState(_map(put, opt_state[0][0])),
                                EmptyState()),
                     step=int(np.asarray(step)))


def state_to(state: DLRMState, device, *, copy: bool = False
             ) -> DLRMState:
    """``state`` with every tensor on ``device`` (copied when ``copy``,
    else moved only where it lies elsewhere)."""
    move = lambda t: t.to(device, copy=copy)  # noqa: E731
    return DLRMState(
        params=_map(move, state.params),
        opt_state=(RssState(_map(move, state.opt_state[0].sum_of_squares)),
                   EmptyState()),
        step=int(state.step))


# -- the model ---------------------------------------------------------------

def _mlp(layers: List[Dict], x: torch.Tensor,
         final_relu: bool = True) -> torch.Tensor:
    h = x
    for i, layer in enumerate(layers):
        h = (h.to(torch.bfloat16).float()
             @ layer["w"].to(torch.bfloat16).float()) + layer["b"]
        if final_relu or i < len(layers) - 1:
            h = torch.relu(h)
    return h


def _interact(emb: torch.Tensor, bottom_out: torch.Tensor) -> torch.Tensor:
    """DLRM pairwise-dot interaction: [B,F,E] x [B,E] → [B, F+1 choose 2
    + E].  Full float32 products: the card's ``allow_tf32`` stays False
    (PyTorch's default, and ``set_float32_precision``'s), as XLA's
    float32 einsum is exact float32."""
    vecs = torch.cat([emb, bottom_out[:, None, :]], dim=1)    # [B,F+1,E]
    prods = torch.bmm(vecs, vecs.transpose(1, 2))
    n = vecs.shape[1]
    iu, ju = torch.triu_indices(n, n, offset=1, device=vecs.device)
    return torch.cat([prods[:, iu, ju], bottom_out], dim=1)


def _forward(params: Dict, dense: torch.Tensor,
             cat: torch.Tensor) -> torch.Tensor:
    b, f = cat.shape
    emb = GatherRows.apply(params["embed"], cat.reshape(-1)).reshape(
        b, f, -1)                                             # [B, F, E]
    bottom_out = _mlp(params["bottom"], dense)                # [B, E]
    z = _interact(emb, bottom_out)
    return _mlp(params["top"], z, final_relu=False)[:, 0]


def _loss(params: Dict, dense, cat, labels, weights) -> torch.Tensor:
    logits = _forward(params, dense, cat)
    losses = (-labels * F.logsigmoid(logits)
              - (1.0 - labels) * F.logsigmoid(-logits))
    return (losses * weights).sum() / torch.clamp(weights.sum(), min=1.0)


def _adagrad_update(grads: List[torch.Tensor], rss: RssState, lr: float
                    ) -> Tuple[List[torch.Tensor], RssState]:
    """``optax.adagrad(lr).update`` out of place, in optax's order:
    ``s = g² + s``, ``u = where(s > 0, rsqrt(s + eps), 0) · g · -lr``;
    returns the updates and the new state."""
    sos = torch._foreach_mul(grads, grads)
    torch._foreach_add_(sos, _leaves(rss.sum_of_squares))
    inv = torch._foreach_add(sos, _EPS)
    torch._foreach_rsqrt_(inv)
    inv = [torch.where(s > 0, r, 0.0) for s, r in zip(sos, inv)]
    upd = torch._foreach_mul(inv, grads)
    torch._foreach_mul_(upd, -lr)
    return upd, RssState(_unflatten(rss.sum_of_squares, sos))


def _step_math(state: DLRMState, dense, cat, labels, weights,
               cfg: DLRMConfig) -> Tuple[DLRMState, torch.Tensor]:
    """One optimizer step's math — shared verbatim by :func:`train_step`
    and the fused window, so fused training is the same computation."""
    leaves = [p.detach().requires_grad_(True)
              for p in _leaves(state.params)]
    params = _unflatten(state.params, leaves)
    loss = _loss(params, dense, cat, labels, weights)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        upd, rss = _adagrad_update(list(grads), state.opt_state[0],
                                   float(cfg.learning_rate))
        new = torch._foreach_add([p.detach() for p in leaves], upd)
    return (DLRMState(params=_unflatten(state.params, new),
                      opt_state=(rss, state.opt_state[1]),
                      step=int(state.step) + 1),
            loss.detach())


def train_step(state: DLRMState, dense, cat, labels, weights,
               cfg: DLRMConfig, mesh=None) -> Tuple[DLRMState, torch.Tensor]:
    """One optimizer step on one batch (tensors on the state's device;
    ``cat`` holds global rows, offsets applied); returns the new state
    and the loss (0-dim tensor)."""
    if mesh is not None:
        raise NotImplementedError(_NO_MESH)
    return _step_math(state, dense, cat, labels, weights, cfg)


def train_steps_fused(state: DLRMState, dense, cat, labels, weights,
                      cfg: DLRMConfig, mesh=None
                      ) -> Tuple[DLRMState, torch.Tensor]:
    """K optimizer steps issued back to back with no host sync: the batch
    tensors carry a leading slot axis ([K, B, ...]); returns the state
    after the K-th step and the per-step loss vector [K].  Bitwise K
    sequential :func:`train_step` calls on the same batches."""
    if mesh is not None:
        raise NotImplementedError(_NO_MESH)
    losses = []
    for k in range(labels.shape[0]):
        state, loss = _step_math(state, dense[k], cat[k], labels[k],
                                 weights[k], cfg)
        losses.append(loss)
    return state, torch.stack(losses)


def _ckpt_state(state: DLRMState) -> Tuple:
    return (state.params, state.opt_state, state.step)


def train(
    dense: np.ndarray,      # [N, n_dense] float
    cat: np.ndarray,        # [N, F] int — per-field indices
    labels: np.ndarray,     # [N] {0,1}
    cfg: DLRMConfig,
    mesh=None,
    *,
    checkpoint_dir=None,
    save_every: int = 0,
    data_source: str = "auto",
    fuse_steps=None,
    warm_state: Optional[DLRMState] = None,
    device=None,
) -> DLRMState:
    """Minibatch CTR training (the reference's loop); ``cat`` holds
    per-field indices, the offsets are applied here.

    ``warm_state``: continue from an existing state (the previous
    generation's) on a delta window instead of a fresh init — the hashed
    vocabularies are fixed-size, so no table grows.  It is copied onto
    the train's device and never changed.  The trailing ragged batch is
    padded with weight-0 rows.  ``data_source``: ``"feeder"`` streams
    epochs from the native mmap cache (v3: the F categorical columns, the
    label on the value column, the dense features on the extras
    columns); ``"numpy"`` is the host permutation; ``"auto"`` is the
    feeder.  ``checkpoint_dir`` + ``save_every`` give mid-training resume
    (deterministic per-(seed, epoch) batch order in both sources).
    Supervision: a non-finite loss rolls back to the last-good
    checkpoint (bounded, then ``TrainDiverged``); SIGTERM preemption
    checkpoints and raises ``TrainPreempted``; ``PIO_STEP_TIMEOUT_S``
    arms the watchdog.  ``fuse_steps`` (default: env ``PIO_FUSE_STEPS``,
    else 1) issues K steps per window (``"auto"``: the HBM-guided
    autotuner); supervision then sits at the window boundary.
    ``device``: the card unless ``"cpu"`` is asked for (default: the
    warm state's device).
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
        device = warm_state.params["embed"].device
    dev = resolve_device(device)
    if dev.type == "cuda":
        from predictionio_tpu_torch.device import set_float32_precision

        set_float32_precision()
    if warm_state is not None:
        warm_state = state_to(warm_state, dev, copy=True)
    # Without a checkpointer a "rollback" is a full deterministic retrain
    # that reproduces the same NaN — terminal immediately.
    can_rollback = bool(checkpoint_dir) and save_every > 0
    guard = DivergenceGuard("dlrm",
                            max_rollbacks=None if can_rollback else 0)
    while True:
        try:
            return _train_attempt(dense, cat, labels, cfg,
                                  checkpoint_dir=checkpoint_dir,
                                  save_every=save_every,
                                  data_source=data_source, guard=guard,
                                  fuse_steps=fuse_steps,
                                  warm_state=warm_state, dev=dev)
        except RollbackRequested:
            continue  # re-enter: restore_step fast-forwards to last-good


def _train_attempt(dense, cat, labels, cfg: DLRMConfig, *, checkpoint_dir,
                   save_every: int, data_source: str, guard, fuse_steps,
                   warm_state: Optional[DLRMState],
                   dev: torch.device) -> DLRMState:
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

    n = len(labels)
    cat = np.asarray(cat)
    n_fields = cat.shape[1]
    cat_global = (np.asarray(cat, np.int64)
                  + cfg.offsets[None, :]).astype(np.int32)
    state = warm_state if warm_state is not None \
        else init_state(cfg, device=dev)
    total_steps = cfg.epochs * ((n + cfg.batch_size - 1) // cfg.batch_size)
    # Warm continuations fingerprint on the carried step: a crash-resume
    # checkpoint from a different base generation must not restore here.
    fp_extra = f"|warm@{int(state.step)}" if warm_state is not None else ""
    ckpt = TrainCheckpointer(checkpoint_dir or ".", save_every=save_every
                             if checkpoint_dir else 0,
                             fingerprint=f"dlrm|{cfg}|n={n}{fp_extra}")
    watchdog = StepWatchdog("dlrm", checkpoint_fn=ckpt.flush)
    start_step = ckpt.restore_step(_ckpt_state(state),
                                   total_steps=total_steps)
    if ckpt.restored_state is not None:
        p, o, s = ckpt.restored_state
        state = DLRMState(params=p, opt_state=o, step=int(s))
    bs = cfg.batch_size

    def numpy_epochs():
        for epoch in range(cfg.epochs):
            order = np.random.default_rng(cfg.seed + epoch).permutation(n)
            for start in range(0, n, bs):
                sel = order[start:start + bs]
                yield (dense[sel], cat_global[sel],
                       labels[sel].astype(np.float32))

    def feeder_epochs():
        import tempfile

        from predictionio_tpu_torch.native.feeder import (
            EventFeeder,
            write_cache,
        )

        with tempfile.TemporaryDirectory(prefix="pio_dlrm_cache_") as d:
            # v3 cache: F categorical columns, the label on the value
            # column, the dense features on the extras columns.
            cache = write_cache(
                f"{d}/train.piof",
                cats=cat_global.astype(np.uint32),
                values=np.asarray(labels, np.float32),
                extras=(np.asarray(dense, np.float32)
                        if cfg.n_dense else None))
            with EventFeeder(cache, bs, seed=cfg.seed) as f:
                for _ in range(cfg.epochs):
                    for batch in f.epoch_cats():
                        c, y = batch[0], batch[1]
                        extras = (batch[2] if len(batch) > 2 else
                                  np.zeros((len(y), 0), np.float32))
                        yield extras, c.astype(np.int32), y

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
        # Prep-thread staging: float32 dense and labels, int32 global
        # rows, weight-0 tail padding — the reference's layout.
        d, c, y = batch
        pad = bs - len(y)
        return (
            np.asarray(np.concatenate(
                [d, np.zeros((pad, cfg.n_dense), np.float32)]), np.float32),
            np.concatenate([c, np.zeros((pad, n_fields), np.int32)]),
            np.asarray(np.concatenate(
                [y, np.zeros(pad, np.float32)]), np.float32),
            np.concatenate([np.ones(len(y), np.float32),
                            np.zeros(pad, np.float32)]),
        )

    k0, auto = fuse_steps_config(fuse_steps)
    plan = FusionPlan(k0)
    tuner = FusionAutotuner("dlrm", plan) if auto else None

    probe = PipelineProbe("dlrm")
    global_step = start_step
    pending = None  # (losses, slot steps) of the in-flight dispatch
    in_flight = 0  # raw steps covered by the in-flight dispatch
    try:
        with DevicePrefetcher(source, prep, device=dev,
                              skip_steps=start_step, fuse_plan=plan,
                              model="dlrm") as pf:
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
                    raise TrainPreempted("dlrm", global_step, ckpt.enabled)
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


def predict_proba(state: DLRMState, dense: np.ndarray, cat: np.ndarray,
                  cfg: DLRMConfig, mesh=None) -> torch.Tensor:
    """Click probabilities ``[N]`` on the state's device (``cat`` holds
    per-field indices; the offsets are applied here)."""
    if mesh is not None:
        raise NotImplementedError(_NO_MESH)
    dev = state.params["embed"].device
    cat_global = (np.asarray(cat, np.int64)
                  + cfg.offsets[None, :]).astype(np.int32)
    with torch.no_grad():
        logits = _forward(
            state.params,
            torch.from_numpy(np.ascontiguousarray(dense, np.float32)).to(dev),
            torch.from_numpy(cat_global).to(dev))
        return torch.sigmoid(logits)
