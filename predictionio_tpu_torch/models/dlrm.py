"""DLRM-style CTR ranking: embedding tables + dense interaction.

Port of ``predictionio_tpu/models/dlrm.py``, on one device (the card
unless ``device="cpu"`` is asked for) or on an ``expert`` mesh of one
process (:func:`param_shardings`, :func:`sharded_embedding_lookup`;
below).  The numerics are the reference's:

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

On a mesh (``init_state(cfg, mesh)``, ``train(..., mesh=mesh)``) the
concatenated table is row-sharded over ``expert`` and the MLPs are
replicated; batches are sharded over ``expert`` too.  The reference's
lookup runs three collectives inside one ``shard_map`` body; the port's
``shard_map`` runs a function a position with no collective inside, so
:func:`sharded_embedding_lookup` is three stages: the index blocks
all-gathered, a masked local gather on each position (rows it does not
own are exact zeros), and ``psum_scatter`` in shard order — each looked
up row is one shard's row plus zeros, the plain gather's bits.  Each
shard then runs the MLPs (their weights rounded to bfloat16 once for
every shard) and the interaction on its rows and sums its weighted
losses; the sums add in shard order.  ``torch.autograd``
differentiates through the stages, a block's gradient is the sum of its
positions' in position order (:mod:`~predictionio_tpu_torch.parallel.
blocks`), and Adagrad updates each block where it lives.  On a mesh that
spans processes (``expert`` split over the gang) each process runs the
stages of its own shards and the collectives carry the index batch, the
looked-up rows, the replicated weights' cotangents and the loss sums
between processes in the same order, so a gang's step has one
process's bits.
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
from predictionio_tpu_torch.parallel.blocks import (
    distinct_blocks,
    flat_blocks,
    grads_by_block,
    leading_slot,
    map_blocks,
    position_leaves,
    rebuild_all,
)
from predictionio_tpu_torch.parallel.compat import (
    all_gather,
    axis_lane,
    check_gang,
    psum,
    psum_scatter,
    replicate,
    shard_map,
)
from predictionio_tpu_torch.parallel.mesh import (
    AXIS_EXPERT,
    NamedSharding,
    PartitionSpec as P,
    ShardedTensor,
    put_sharded,
)

__all__ = ["DLRMConfig", "DLRMState", "RssState", "EmptyState",
           "init_params_host", "init_params", "init_state",
           "param_shardings", "sharded_embedding_lookup", "train_step",
           "train_steps_fused", "train", "state_to", "state_to_host",
           "state_from_host", "predict_proba"]

_INITIAL_ACCUMULATOR, _EPS = 0.1, 1e-7


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


def param_shardings(cfg: DLRMConfig, mesh) -> Dict:
    """The table row-sharded over ``expert``; the MLPs replicated."""
    return _shardings_like(init_params_host(cfg), mesh)


def _shardings_like(tree: Dict, mesh) -> Dict:
    rep = NamedSharding(mesh, P())
    return _unflatten(tree, [NamedSharding(mesh, P(AXIS_EXPERT, None))]
                      + [rep] * (len(_leaves(tree)) - 1))


def _on_mesh(tree: Dict) -> bool:
    return isinstance(tree["embed"], ShardedTensor)


def _place(host_tree: Dict, mesh) -> Dict:
    """A params-shaped tree of host arrays laid out on ``mesh``."""
    return _unflatten(host_tree, [
        put_sharded(np.array(a, np.float32), mesh, sh)
        for a, sh in zip(_leaves(host_tree),
                         _leaves(_shardings_like(host_tree, mesh)))])


def _full_like(x, value: float):
    if isinstance(x, ShardedTensor):
        return map_blocks(lambda t: torch.full_like(t, value), x)
    return torch.full_like(x, value)


def init_state(cfg: DLRMConfig, mesh=None, *, device=None) -> DLRMState:
    """The reference's initial state, on ``device`` or laid out on
    ``mesh`` by :func:`param_shardings`."""
    if mesh is not None:
        params = _place(init_params_host(cfg), mesh)
    else:
        params = init_params(cfg, device)
    acc = _map(lambda t: _full_like(t, _INITIAL_ACCUMULATOR), params)
    return DLRMState(params=params,
                     opt_state=(RssState(acc), EmptyState()), step=0)


def _host_array(x) -> np.ndarray:
    if isinstance(x, ShardedTensor):
        return x.to_host()
    return x.detach().cpu().numpy()


def state_to_host(state: DLRMState) -> Dict:
    """Host-numpy snapshot of a train state, laid out as the reference's
    (``params``; ``opt_state`` = ``(RssState(sum_of_squares),
    EmptyState())``; ``step``) — exact float32 values, so a warm-started
    continuation equals continuing in-process.  A mesh state's sharded
    leaves are gathered."""
    to_np = _host_array
    return {"params": _map(to_np, state.params),
            "opt_state": (RssState(_map(to_np,
                                        state.opt_state[0].sum_of_squares)),
                          EmptyState()),
            "step": np.asarray(int(state.step), np.int32)}


def state_from_host(snapshot, device=None, *, mesh=None) -> DLRMState:
    """Rebuild a live state on ``device`` (or laid out on ``mesh`` by
    :func:`param_shardings`) from a :func:`state_to_host` snapshot, or
    from the reference's ``jax.tree.map(np.asarray, (params, opt_state,
    step))`` (its optax state is a ``(ScaleByRssState(sum_of_squares),
    EmptyState())`` tuple too)."""
    if isinstance(snapshot, Mapping):
        params, opt_state, step = (snapshot["params"],
                                   snapshot["opt_state"], snapshot["step"])
    else:
        params, opt_state, step = snapshot
    if mesh is not None:
        return DLRMState(params=_place(params, mesh),
                         opt_state=(RssState(_place(opt_state[0][0], mesh)),
                                    EmptyState()),
                         step=int(np.asarray(step)))
    dev = resolve_device(device)
    put = lambda a: torch.from_numpy(  # noqa: E731
        np.array(a, np.float32)).to(dev)
    return DLRMState(params=_map(put, params),
                     opt_state=(RssState(_map(put, opt_state[0][0])),
                                EmptyState()),
                     step=int(np.asarray(step)))


def _to_mesh(state: DLRMState, mesh) -> DLRMState:
    """A meshless state's copy laid out on ``mesh``."""
    return state_from_host(state_to_host(state), mesh=mesh)


def state_to(state: DLRMState, device, *, copy: bool = False
             ) -> DLRMState:
    """``state`` with every tensor on ``device`` (copied when ``copy``,
    else moved only where it lies elsewhere); a mesh state gathered
    whole there."""
    if _on_mesh(state.params):
        return state_from_host(state_to_host(state), device)
    move = lambda t: t.to(device, copy=copy)  # noqa: E731
    return DLRMState(
        params=_map(move, state.params),
        opt_state=(RssState(_map(move, state.opt_state[0].sum_of_squares)),
                   EmptyState()),
        step=int(state.step))


# -- the model ---------------------------------------------------------------

def _bf16_weights(layers: List[Dict]) -> List[Dict]:
    """The layers with each weight rounded to bfloat16 (kept as float32),
    the operand :func:`_mlp_rounded` multiplies by."""
    return [{"w": layer["w"].to(torch.bfloat16).float(), "b": layer["b"]}
            for layer in layers]


def _mlp(layers: List[Dict], x: torch.Tensor,
         final_relu: bool = True) -> torch.Tensor:
    return _mlp_rounded(_bf16_weights(layers), x, final_relu)


def _mlp_rounded(layers: List[Dict], x: torch.Tensor,
                 final_relu: bool = True) -> torch.Tensor:
    """:func:`_mlp` on weights already rounded by :func:`_bf16_weights`
    (the rounding's backward rounds a weight's gradient once, after
    every use of it has added its part in float32)."""
    h = x
    for i, layer in enumerate(layers):
        h = (h.to(torch.bfloat16).float() @ layer["w"]) + layer["b"]
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
    """``optax.adagrad(lr).update`` of a params tree's leaves; returns the
    updates and the new state."""
    upd, sos = _adagrad_flat(grads, _leaves(rss.sum_of_squares), lr)
    return upd, RssState(_unflatten(rss.sum_of_squares, sos))


def _adagrad_flat(grads: List[torch.Tensor], sos_l: List[torch.Tensor],
                  lr: float) -> Tuple[List[torch.Tensor],
                                      List[torch.Tensor]]:
    """``optax.adagrad(lr).update`` out of place, in optax's order:
    ``s = g² + s``, ``u = where(s > 0, rsqrt(s + eps), 0) · g · -lr``.
    Elementwise, so any list of matching tensors (a tree's leaves, a
    mesh's blocks) takes it.  Returns the updates and the new sums."""
    sos = torch._foreach_mul(grads, grads)
    torch._foreach_add_(sos, sos_l)
    inv = torch._foreach_add(sos, _EPS)
    torch._foreach_rsqrt_(inv)
    inv = [torch.where(s > 0, r, 0.0) for s, r in zip(sos, inv)]
    upd = torch._foreach_mul(inv, grads)
    torch._foreach_mul_(upd, -lr)
    return upd, sos


def _step_math(state: DLRMState, dense, cat, labels, weights,
               cfg: DLRMConfig) -> Tuple[DLRMState, torch.Tensor]:
    """One optimizer step's math — shared verbatim by :func:`train_step`
    and the fused window, so fused training is the same computation."""
    if _on_mesh(state.params):
        return _mesh_step_math(state, dense, cat, labels, weights, cfg)
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


# -- the expert-sharded lookup and the mesh step -------------------------------

def _lane(mesh) -> List[int]:
    """The ``expert`` lane's positions this process drives, in order."""
    mine = set(mesh.local_positions())
    return [p for p in axis_lane(mesh, AXIS_EXPERT) if p in mine]


def _lane_of(x: ShardedTensor) -> List[torch.Tensor]:
    """``x``'s block on each shard of ``expert`` this process drives, in
    shard order."""
    return [x.block(p) for p in _lane(x.mesh)]


def _expert_lookup(table: ShardedTensor, indices: ShardedTensor
                   ) -> List[torch.Tensor]:
    """:func:`sharded_embedding_lookup`'s three stages; returns each of
    this process's ``expert`` shards' rows ``[B/S, F, E]`` in shard
    order."""
    mesh = table.mesh
    check_gang(mesh, AXIS_EXPERT)
    n_shards = mesh.shape[AXIS_EXPERT]
    v = table.shape[0]
    assert v % n_shards == 0, f"pad vocab ({v}) to a multiple of {n_shards}"
    rows_per = v // n_shards
    # Stage 1: every shard gets the whole (tiny, int32) index batch.
    idx_lane = _lane_of(indices)
    whole = all_gather(idx_lane, mesh)
    idx_all = {str(b.device): whole.to(b.device) for b in idx_lane}

    # Stage 2: each position's masked partial embeddings of the indices
    # its table block owns (rows it does not own are exact zeros).
    def local(axis_index, tab):
        idx = idx_all[str(tab.device)]                         # [B, F]
        rel = idx.long() - axis_index(AXIS_EXPERT) * rows_per
        mine = (rel >= 0) & (rel < rows_per)
        got = GatherRows.apply(tab, rel.clamp(0, rows_per - 1).reshape(-1)
                               ).reshape(*idx.shape, -1)      # [B, F, E]
        return torch.where(mine[..., None], got, torch.zeros_like(got))

    parts = shard_map(local, mesh=mesh, in_specs=P(AXIS_EXPERT, None),
                      out_specs=None)(table)
    part_of = dict(zip(mesh.local_positions(), parts))
    # Stage 3: each batch shard gets its rows, summed in shard order.
    return psum_scatter([part_of[p] for p in _lane(mesh)], mesh, dim=0)


def _expert_layout(blocks: List[torch.Tensor], mesh, shape) -> ShardedTensor:
    """This process's per-``expert``-shard outputs as a ``P(expert)``
    array (the other axes' positions share their lane's block)."""
    spec = P(AXIS_EXPERT, *([None] * (len(shape) - 1)))
    shards = [None] * mesh.size
    at = {mesh.position(p)[AXIS_EXPERT]: b
          for p, b in zip(_lane(mesh), blocks)}
    for p in mesh.local_positions():
        shards[p] = at[mesh.position(p)[AXIS_EXPERT]]
    return ShardedTensor(NamedSharding(mesh, spec), shape, shards)


def sharded_embedding_lookup(mesh, table, indices) -> ShardedTensor:
    """Row-sharded table lookup: ``table`` ``[V, E]`` row-sharded over
    ``expert`` (a tensor or array is laid out so), ``indices`` ``[B, F]``
    global rows batch-sharded over ``expert``; returns the ``[B, F, E]``
    rows batch-sharded over ``expert``.  ``V`` must be a multiple of the
    shard count."""
    if not isinstance(table, ShardedTensor):
        n_shards = mesh.shape[AXIS_EXPERT]
        assert table.shape[0] % n_shards == 0, \
            f"pad vocab ({table.shape[0]}) to a multiple of {n_shards}"
        table = put_sharded(table, mesh, P(AXIS_EXPERT, None))
    if not isinstance(indices, ShardedTensor):
        indices = put_sharded(indices, mesh, P(AXIS_EXPERT, None))
    rows = _expert_lookup(table, indices)
    return _expert_layout(rows, mesh,
                          (*indices.shape, table.shape[1]))


def _mesh_logits(params: Dict, dense: ShardedTensor,
                 cat: ShardedTensor) -> List[torch.Tensor]:
    """Each ``expert`` shard's logits for its batch rows, in shard order:
    the sharded lookup, then the shard's MLPs and interaction."""
    mesh = cat.mesh
    emb = _expert_lookup(params["embed"], cat)
    lane = _lane(mesh)
    # The replicated MLPs' weights rounded to bfloat16 once, on this
    # process's first shard, and handed to every shard by ``replicate``:
    # their gradients then add in float32, in shard order across the
    # gang, before the rounding's backward rounds them, as the meshless
    # step's one product over the whole batch does.
    names = ("bottom", "top")
    mlps = {name: _bf16_weights([{k: v.block(lane[0])
                                  for k, v in layer.items()}
                                 for layer in params[name]])
            for name in names}
    flat = [layer[k] for name in names for layer in mlps[name]
            for k in ("w", "b")]
    copies = replicate(flat, [e.device for e in emb], mesh)
    out = []
    for e, d, mine in zip(emb, _lane_of(dense), copies):
        it = iter(mine)
        here = {name: [{"w": next(it), "b": next(it)} for _ in mlps[name]]
                for name in names}
        z = _interact(e, _mlp_rounded(here["bottom"], d))
        out.append(_mlp_rounded(here["top"], z, final_relu=False)[:, 0])
    return out


def _mesh_step_math(state: DLRMState, dense: ShardedTensor,
                    cat: ShardedTensor, labels: ShardedTensor,
                    weights: ShardedTensor, cfg: DLRMConfig
                    ) -> Tuple[DLRMState, torch.Tensor]:
    """:func:`_step_math` on a mesh state: each shard's weighted loss sum
    over the stages, added in shard order; the positions' gradients
    summed a block; Adagrad on each block where it lives."""
    sharded = _leaves(state.params)
    mesh = sharded[0].mesh
    leaves = [position_leaves(x) for x in sharded]
    logits = _mesh_logits(_unflatten(state.params, leaves), dense, cat)
    nums, dens = [], []
    for x, y, w in zip(logits, _lane_of(labels), _lane_of(weights)):
        losses = -y * F.logsigmoid(x) - (1.0 - y) * F.logsigmoid(-x)
        nums.append((losses * w).sum())
        dens.append(w.sum())
    num = psum(nums, mesh, each=True)[0]
    loss = num / torch.clamp(psum(dens, mesh, device=num.device), min=1.0)
    grads = grads_by_block(loss, sharded, leaves)
    with torch.no_grad():
        upd, sos = _adagrad_flat(
            flat_blocks(grads),
            flat_blocks(_leaves(state.opt_state[0].sum_of_squares)),
            float(cfg.learning_rate))
        new = torch._foreach_add(flat_blocks(sharded), upd)

    def laid_out(blocks: List[torch.Tensor]) -> Dict:
        return _unflatten(state.params, rebuild_all(sharded, blocks))

    return (DLRMState(params=laid_out(new),
                      opt_state=(RssState(laid_out(sos)),
                                 state.opt_state[1]),
                      step=int(state.step) + 1),
            loss.detach())


def _slot(x, k: int):
    return leading_slot(x, k) if isinstance(x, ShardedTensor) else x[k]


def train_step(state: DLRMState, dense, cat, labels, weights,
               cfg: DLRMConfig, mesh=None) -> Tuple[DLRMState, torch.Tensor]:
    """One optimizer step on one batch (tensors on the state's device;
    ``cat`` holds global rows, offsets applied; on a mesh state,
    :class:`ShardedTensor` s laid out ``P("expert")``); returns the new
    state and the loss (0-dim tensor).  ``mesh`` is the reference's
    argument: the state's own layout decides."""
    return _step_math(state, dense, cat, labels, weights, cfg)


def train_steps_fused(state: DLRMState, dense, cat, labels, weights,
                      cfg: DLRMConfig, mesh=None
                      ) -> Tuple[DLRMState, torch.Tensor]:
    """K optimizer steps issued back to back with no host sync: the batch
    tensors carry a leading slot axis ([K, B, ...]; on a mesh, laid out
    ``P(None, "expert")``); returns the state after the K-th step and the
    per-step loss vector [K].  Bitwise K sequential :func:`train_step`
    calls on the same batches."""
    losses = []
    for k in range(labels.shape[0]):
        state, loss = _step_math(state, _slot(dense, k), _slot(cat, k),
                                 _slot(labels, k), _slot(weights, k), cfg)
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

    ``mesh``: train on it (the module docstring's layout; batches over
    ``expert``, which must divide ``batch_size`` and the total vocab),
    its positions' devices in place of ``device``.  A meshless
    ``warm_state`` is laid out on the mesh first.
    """
    from predictionio_tpu_torch.resilience.supervision import (
        DivergenceGuard,
        RollbackRequested,
    )

    if data_source not in ("auto", "feeder", "numpy"):
        raise ValueError(f"data_source {data_source!r}: use auto, feeder "
                         "or numpy")
    if mesh is not None:
        check_gang(mesh, AXIS_EXPERT)
        device = mesh.devices.flat[mesh.local_positions()[0]]
    elif device is None and warm_state is not None:
        device = warm_state.params["embed"].device
    dev = resolve_device(device)
    if dev.type == "cuda":
        from predictionio_tpu_torch.device import set_float32_precision

        set_float32_precision()
    if warm_state is not None:
        # Steps are functional: a mesh state is never changed in place.
        if mesh is not None and not _on_mesh(warm_state.params):
            warm_state = _to_mesh(warm_state, mesh)
        elif mesh is None:
            warm_state = state_to(warm_state, dev, copy=True)
    # Without a checkpointer a "rollback" is a full deterministic retrain
    # that reproduces the same NaN — terminal immediately.
    can_rollback = bool(checkpoint_dir) and save_every > 0
    guard = DivergenceGuard("dlrm",
                            max_rollbacks=None if can_rollback else 0)
    while True:
        try:
            return _train_attempt(dense, cat, labels, cfg, mesh=mesh,
                                  checkpoint_dir=checkpoint_dir,
                                  save_every=save_every,
                                  data_source=data_source, guard=guard,
                                  fuse_steps=fuse_steps,
                                  warm_state=warm_state, dev=dev)
        except RollbackRequested:
            continue  # re-enter: restore_step fast-forwards to last-good


def _train_attempt(dense, cat, labels, cfg: DLRMConfig, *, mesh=None,
                   checkpoint_dir,
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
        else init_state(cfg, mesh, device=dev)
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

    staging = {"device": dev}
    if mesh is not None:
        # A batch shards over ``expert``; a fused superbatch's batch axis
        # is dim 1, so its staging shards dim 1 and replicates the slots.
        batch_sh = NamedSharding(mesh, P(AXIS_EXPERT))
        fused_sh = NamedSharding(mesh, P(None, AXIS_EXPERT))
        staging = {
            "put_fn": lambda arrays: tuple(
                put_sharded(a, mesh, batch_sh) for a in arrays),
            "fused_put_fn": lambda arrays: tuple(
                put_sharded(a, mesh, fused_sh) for a in arrays)}

    probe = PipelineProbe("dlrm")
    global_step = start_step
    pending = None  # (losses, slot steps) of the in-flight dispatch
    in_flight = 0  # raw steps covered by the in-flight dispatch
    try:
        with DevicePrefetcher(source, prep, **staging,
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
    per-field indices; the offsets are applied here).  With ``mesh`` the
    rows are sharded over ``expert`` (which must divide ``N``) and the
    lookup is :func:`sharded_embedding_lookup` (a meshless state is laid
    out on the mesh first), the result assembled on the first shard's
    device; a mesh state without ``mesh`` is gathered whole."""
    cat_global = (np.asarray(cat, np.int64)
                  + cfg.offsets[None, :]).astype(np.int32)
    if mesh is not None:
        if not _on_mesh(state.params):
            state = _to_mesh(state, mesh)
        bsh = NamedSharding(mesh, P(AXIS_EXPERT))
        with torch.no_grad():
            logits = _mesh_logits(
                state.params,
                put_sharded(np.ascontiguousarray(dense, np.float32), mesh,
                            bsh),
                put_sharded(cat_global, mesh, bsh))
            return torch.sigmoid(all_gather(logits, mesh))
    if _on_mesh(state.params):
        state = state_to(state, distinct_blocks(state.params["embed"])[0]
                         .device)
    dev = state.params["embed"].device
    with torch.no_grad():
        logits = _forward(
            state.params,
            torch.from_numpy(np.ascontiguousarray(dense, np.float32)).to(dev),
            torch.from_numpy(cat_global).to(dev))
        return torch.sigmoid(logits)
