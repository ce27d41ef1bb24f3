"""Two-tower neural retrieval: learned user/item embeddings + MLP towers
trained with in-batch sampled-softmax negatives; retrieval is MIPS top-k
over the encoded items.

Port of ``predictionio_tpu/models/two_tower.py``, on one device (the card
unless ``device="cpu"`` is asked for) or on a ``data × model`` mesh of
one process (:func:`param_shardings`; below).  The numerics are the
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

On a mesh (``init_state(cfg, mesh)``, ``train(..., mesh=mesh)``) the
state's leaves are :class:`~predictionio_tpu_torch.parallel.mesh.
ShardedTensor` s: the embedding tables row-sharded over ``model``, the
MLPs replicated, as the reference's :func:`param_shardings` lays them
out; batches are sharded over ``data`` (a fused window's staging over
dim 1).  A step (:func:`_mesh_step_math`) is the reference's GSPMD
program written out in stages: each position gathers its ids' rows of
its table block (:class:`~predictionio_tpu_torch.ops.embedding.
GatherRows`, rows it does not own masked to zero) and the blocks of a
``data`` shard add in ``model`` order, so each looked-up row is one
block's row plus exact zeros; each ``data`` shard runs the towers on its
rows (the replicated weights rounded to bfloat16 once for every shard,
so their gradients add in float32 before the rounding's backward, as one
product over the whole batch does), scores them against the
all-gathered item vectors of the whole batch (the in-batch negatives)
and sums its weighted losses; the shards' sums add in shard order.  ``torch.autograd`` differentiates through the
stages, each block's gradient is the sum of its positions' in position
order (:mod:`~predictionio_tpu_torch.parallel.blocks`), and Adam updates
each block where it lives.  The only float differences from the meshless
step are the orders of those sums.  On a mesh that spans processes (its
``data`` axis split over the gang) each process runs the stages of its
own positions; the collectives carry the item vectors, the replicated
weights' cotangents and the loss sums between processes in the same
order, so a gang's step has one process's bits.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.device import device as resolve_device
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
    replicate,
    shard_map,
)
from predictionio_tpu_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_MODEL,
    NamedSharding,
    PartitionSpec as P,
    ShardedTensor,
    put_sharded,
)

__all__ = ["TwoTowerConfig", "TwoTowerState", "AdamState", "EmptyState",
           "init_params", "init_state", "param_shardings", "train_step",
           "train_steps_fused", "train", "grow_state", "state_to_host",
           "state_from_host", "eval_loss", "encode_users", "encode_items",
           "retrieve"]

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
    return (AdamState(count=0, mu=_map(_zeros_like, params),
                      nu=_map(_zeros_like, params)), EmptyState())


def param_shardings(cfg: TwoTowerConfig, mesh) -> Dict:
    """Embedding tables row-sharded over ``model``; MLPs replicated."""
    return _shardings_like(init_params_host(cfg), mesh)


def _shardings_like(tree: Dict, mesh) -> Dict:
    table = NamedSharding(mesh, P(AXIS_MODEL, None))
    rep = NamedSharding(mesh, P())
    return _unflatten(tree, [table, table]
                      + [rep] * (len(_leaves(tree)) - 2))


def _on_mesh(tree: Dict) -> bool:
    return isinstance(tree["user_embed"], ShardedTensor)


def _place(host_tree: Dict, mesh) -> Dict:
    """A params-shaped tree of host arrays laid out on ``mesh``."""
    return _unflatten(host_tree, [
        put_sharded(np.array(a, np.float32), mesh, sh)
        for a, sh in zip(_leaves(host_tree),
                         _leaves(_shardings_like(host_tree, mesh)))])


def _zeros_like(x):
    if isinstance(x, ShardedTensor):
        return map_blocks(torch.zeros_like, x)
    return torch.zeros_like(x)


def init_state(cfg: TwoTowerConfig, mesh=None, *,
               device=None) -> TwoTowerState:
    """The reference's initial state, on ``device`` or laid out on
    ``mesh`` by :func:`param_shardings` (each position's device)."""
    if mesh is not None:
        params = _place(init_params_host(cfg), mesh)
    else:
        params = init_params(cfg, device)
    return TwoTowerState(params=params, opt_state=_zero_opt_state(params),
                         step=0)


def _to_mesh(state: TwoTowerState, mesh) -> TwoTowerState:
    """A meshless state's copy laid out on ``mesh``."""
    snap = state_to_host(state)
    return state_from_host(snap, mesh=mesh)


def state_to_host(state: TwoTowerState) -> Dict:
    """Host-numpy snapshot of a train state, laid out as the reference's
    (``params``; ``opt_state`` = ``(AdamState(count, mu, nu),
    EmptyState())``; ``step``) — exact float32 values, so a warm-started
    continuation equals continuing in-process, and the reference's
    ``state_from_host`` takes it.  A mesh state's sharded leaves are
    gathered."""
    to_np = _host_array
    adam = state.opt_state[0]
    return {"params": _map(to_np, state.params),
            "opt_state": (AdamState(count=np.asarray(int(adam.count),
                                                     np.int32),
                                    mu=_map(to_np, adam.mu),
                                    nu=_map(to_np, adam.nu)),
                          EmptyState()),
            "step": np.asarray(int(state.step), np.int32)}


def _host_array(x) -> np.ndarray:
    if isinstance(x, ShardedTensor):
        return x.to_host()
    return x.detach().cpu().numpy()


def state_from_host(snapshot: Dict, device=None, *,
                    mesh=None) -> TwoTowerState:
    """Rebuild a live state from a :func:`state_to_host` snapshot — the
    port's or the reference's (its optax state is a ``(count, mu, nu)``
    named tuple too) — on ``device``, or laid out on ``mesh`` by
    :func:`param_shardings` (the moments as their parameters)."""
    count, mu, nu = snapshot["opt_state"][0]
    if mesh is not None:
        return TwoTowerState(
            params=_place(snapshot["params"], mesh),
            opt_state=(AdamState(count=int(np.asarray(count)),
                                 mu=_place(mu, mesh), nu=_place(nu, mesh)),
                       EmptyState()),
            step=int(np.asarray(snapshot["step"])))
    dev = resolve_device(device)
    put = lambda a: torch.from_numpy(  # noqa: E731
        np.array(a, np.float32)).to(dev)
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
    ``cfg`` carries the NEW ``n_users``/``n_items``.  A mesh state grows
    on its first block's device and is laid out on its mesh again."""
    if _on_mesh(state.params):
        mesh = state.params["user_embed"].mesh
        home = distinct_blocks(state.params["user_embed"])[0].device
        grown_state = grow_state(
            state_from_host(state_to_host(state), home), cfg)
        return _to_mesh(grown_state, mesh)
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

def _bf16_weights(params: Dict) -> Dict:
    """A tower's layers with each weight rounded to bfloat16 (kept as
    float32), the operand :func:`_mlp_rounded` multiplies by."""
    return {"layers": [{"w": layer["w"].to(torch.bfloat16).float(),
                        "b": layer["b"]} for layer in params["layers"]]}


def _mlp(params: Dict, x: torch.Tensor) -> torch.Tensor:
    return _mlp_rounded(_bf16_weights(params), x)


def _mlp_rounded(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """:func:`_mlp` on weights already rounded by :func:`_bf16_weights`.
    The rounding's backward rounds the weight's gradient to bfloat16
    once, after every use of the rounded weight has added its part in
    float32 (on a mesh: every ``data`` shard's rows)."""
    h = x.to(torch.bfloat16)
    n = len(params["layers"])
    for i, layer in enumerate(params["layers"]):
        h = h.float() @ layer["w"]
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
    """One ``optax.adam(lr)`` update of a params tree's leaves."""
    new, mu, nu = _adam_flat(params, grads, _leaves(adam.mu),
                             _leaves(adam.nu), int(adam.count) + 1, lr)
    like = adam.mu
    return new, AdamState(int(adam.count) + 1, _unflatten(like, mu),
                          _unflatten(like, nu))


def _adam_flat(params: List[torch.Tensor], grads: List[torch.Tensor],
               mu_l: List[torch.Tensor], nu_l: List[torch.Tensor],
               count: int, lr: float):
    """``optax.adam(lr)``'s update at step ``count``, out of place, in
    optax's order: ``mu = (1-b1)·g + b1·mu``, ``nu = (1-b2)·g² + b2·nu``,
    both divided by ``1 - b**count`` (float32), ``u = m̂ / (√v̂ + eps) ·
    -lr``, ``p + u``.  Elementwise, so any list of matching tensors (a
    tree's leaves, a mesh's blocks) takes it.  Returns the new params and
    both moments."""
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
    return torch._foreach_add(params, upd), mu, nu


def _step_math(state: TwoTowerState, user_ids, item_ids, weights,
               cfg: TwoTowerConfig) -> Tuple[TwoTowerState, torch.Tensor]:
    """One optimizer step's math — shared verbatim by :func:`train_step`
    and the fused window, so fused training is the same computation."""
    if _on_mesh(state.params):
        return _mesh_step_math(state, user_ids, item_ids, weights, cfg)
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


# -- the mesh step ------------------------------------------------------------

def _at(tree, p: int):
    """A tree of :class:`ShardedTensor` s as position ``p``'s blocks."""
    if isinstance(tree, dict):
        return {k: _at(v, p) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_at(v, p) for v in tree]
    return tree.block(p)


def _owned_rows(axis_index, block: torch.Tensor,
                ids: torch.Tensor) -> torch.Tensor:
    """The rows of ``ids`` this position's row block owns, gathered
    through :class:`GatherRows`, and exact zeros for the others."""
    rows = block.shape[0]
    rel = ids.long() - axis_index(AXIS_MODEL) * rows
    mine = (rel >= 0) & (rel < rows)
    got = GatherRows.apply(block, rel.clamp(0, rows - 1))
    return torch.where(mine[:, None], got, torch.zeros_like(got))


def _local_lane(mesh) -> List[int]:
    """The ``data`` lane's positions this process drives, in order."""
    mine = set(mesh.local_positions())
    return [p for p in axis_lane(mesh, AXIS_DATA) if p in mine]


def _mesh_towers(params: Dict, ids: ShardedTensor, table: str,
                 tower: str) -> List[torch.Tensor]:
    """Each of this process's ``data`` shards' tower outputs, on its lane
    position's device: the masked gathers of every position, their
    ``model`` blocks added in order, then the MLP on the shard's rows.
    The replicated MLP's weights are rounded to bfloat16 once and handed
    to every shard by :func:`~predictionio_tpu_torch.parallel.compat.
    replicate`: the weight gradients of the shards then add in float32,
    in shard order (across processes too), before the rounding's
    backward rounds them, as the meshless step's one product over the
    whole batch does (a rounding a shard would give partial sums of
    bfloat16 gradients)."""
    mesh = ids.mesh
    parts = shard_map(_owned_rows, mesh=mesh,
                      in_specs=(P(AXIS_MODEL, None), P(AXIS_DATA)),
                      out_specs=None)(params[table], ids)
    part_of = dict(zip(mesh.local_positions(), parts))
    lane = _local_lane(mesh)
    mlp = _bf16_weights(_at(params[tower], lane[0]))
    flat = [t for layer in mlp["layers"] for t in (layer["w"], layer["b"])]
    devs = [params[table].block(lead).device for lead in lane]
    copies = replicate(flat, devs, mesh)
    out = []
    for lead, dev, mine in zip(lane, devs, copies):
        d = mesh.position(lead)[AXIS_DATA]
        row = axis_lane(mesh, AXIS_MODEL, at={AXIS_DATA: d})
        e = psum([part_of[p] for p in row], device=dev)
        here = {"layers": [{"w": mine[2 * i], "b": mine[2 * i + 1]}
                           for i in range(len(mlp["layers"]))]}
        out.append(_normalized(_mlp_rounded(here, e)))
    return out


def _mesh_loss(params: Dict, user_ids: ShardedTensor,
               item_ids: ShardedTensor, weights: ShardedTensor,
               temperature: float) -> torch.Tensor:
    """:func:`_loss` over a ``data``-sharded batch: each shard's rows
    against the all-gathered item vectors, the shards' weighted sums
    added in shard order (this process's replica of the loss)."""
    mesh = user_ids.mesh
    lane = _local_lane(mesh)
    u = _mesh_towers(params, user_ids, "user_embed", "user_mlp")
    v = _mesh_towers(params, item_ids, "item_embed", "item_mlp")
    items = [item_ids.block(p) for p in lane]
    wts = [weights.block(p) for p in lane]
    v_alls = all_gather(v, mesh, each=True)                   # [B, D] each
    i_all0 = all_gather(items, mesh)
    w_all0 = all_gather(wts, mesh)
    nums, dens = [], []
    for j, (lead, ud, v_all) in enumerate(zip(lane, u, v_alls)):
        dev, rows = ud.device, ud.shape[0]
        d = mesh.position(lead)[AXIS_DATA]
        i_all, w_all = i_all0.to(dev), w_all0.to(dev)
        logits = (ud @ v_all.T) / temperature                 # [B/n, B]
        diag = d * rows + torch.arange(rows, device=dev)
        same = items[j][:, None] == i_all[None, :]
        pad_col = (w_all <= 0.0)[None, :]
        eye = torch.arange(v_all.shape[0], device=dev)[None, :] \
            == diag[:, None]
        logits = logits.masked_fill((same | pad_col) & ~eye, -1e9)
        top = logits.max(dim=-1, keepdim=True).values.detach()
        log_norm = torch.log(torch.exp(logits - top).sum(dim=-1)) \
            + top[:, 0]
        losses = log_norm - logits.gather(1, diag[:, None])[:, 0]
        nums.append((losses * wts[j]).sum())
        dens.append(wts[j].sum())
    num = psum(nums, mesh, each=True)[0]
    return num / torch.clamp(psum(dens, mesh, device=num.device), min=1.0)


def _mesh_step_math(state: TwoTowerState, user_ids: ShardedTensor,
                    item_ids: ShardedTensor, weights: ShardedTensor,
                    cfg: TwoTowerConfig
                    ) -> Tuple[TwoTowerState, torch.Tensor]:
    """:func:`_step_math` on a mesh state: the loss over the stages, the
    positions' gradients summed a block, Adam on each block where it
    lives."""
    sharded = _leaves(state.params)
    mesh = sharded[0].mesh
    check_gang(mesh, AXIS_DATA)
    leaves = [position_leaves(x) for x in sharded]
    loss = _mesh_loss(_unflatten(state.params, leaves), user_ids, item_ids,
                      weights, cfg.temperature)
    grads = grads_by_block(loss, sharded, leaves)
    adam = state.opt_state[0]
    with torch.no_grad():
        new, mu, nu = _adam_flat(
            *(flat_blocks(xs) for xs in (sharded, grads, _leaves(adam.mu),
                                         _leaves(adam.nu))),
            int(adam.count) + 1, float(cfg.learning_rate))

    def laid_out(blocks: List[torch.Tensor]) -> Dict:
        return _unflatten(state.params, rebuild_all(sharded, blocks))

    return (TwoTowerState(
        params=laid_out(new),
        opt_state=(AdamState(int(adam.count) + 1, laid_out(mu),
                             laid_out(nu)), state.opt_state[1]),
        step=int(state.step) + 1), loss.detach())


def train_step(state: TwoTowerState, user_ids, item_ids, weights,
               cfg: TwoTowerConfig) -> Tuple[TwoTowerState, torch.Tensor]:
    """One optimizer step on one batch (tensors on the state's device;
    on a mesh state, :class:`ShardedTensor` s laid out ``P("data")``);
    returns the new state and the loss (0-dim tensor)."""
    return _step_math(state, user_ids, item_ids, weights, cfg)


def _slot(x, k: int):
    return leading_slot(x, k) if isinstance(x, ShardedTensor) else x[k]


def train_steps_fused(state: TwoTowerState, user_ids, item_ids, weights,
                      cfg: TwoTowerConfig
                      ) -> Tuple[TwoTowerState, torch.Tensor]:
    """K optimizer steps issued back to back with no host sync: the batch
    tensors carry a leading slot axis ([K, B]; on a mesh, laid out
    ``P(None, "data")``); returns the state after the K-th step and the
    per-step loss vector [K].  Bitwise K sequential :func:`train_step`
    calls on the same batches."""
    losses = []
    for k in range(user_ids.shape[0]):
        state, loss = _step_math(state, _slot(user_ids, k),
                                 _slot(item_ids, k), _slot(weights, k), cfg)
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

    ``mesh``: train on it (the module docstring's layout; batches over
    ``data``, which must divide ``batch_size``; tables over ``model``,
    which must divide their heights), its positions' devices in place of
    ``device``.  A meshless ``warm_state`` is laid out on the mesh first.
    """
    from predictionio_tpu_torch.resilience.supervision import (
        DivergenceGuard,
        RollbackRequested,
    )

    if data_source not in ("auto", "feeder", "numpy"):
        raise ValueError(f"data_source {data_source!r}: use auto, feeder "
                         "or numpy")
    if mesh is not None:
        check_gang(mesh, AXIS_DATA)
        device = mesh.devices.flat[mesh.local_positions()[0]]
        if warm_state is not None and not _on_mesh(warm_state.params):
            warm_state = _to_mesh(warm_state, mesh)
    elif device is None and warm_state is not None:
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
                                  warm_state=warm_state, dev=dev,
                                  mesh=mesh)
        except RollbackRequested:
            continue  # re-enter: restore_step fast-forwards to last-good


def _train_attempt(user_ids, item_ids, cfg: TwoTowerConfig, weights, *,
                   checkpoint_dir, save_every: int, data_source: str, guard,
                   fuse_steps, warm_state: Optional[TwoTowerState],
                   dev: torch.device, mesh=None) -> TwoTowerState:
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
        else init_state(cfg, mesh, device=dev)
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

    staging = {"device": dev}
    if mesh is not None:
        # A batch shards over ``data``; a fused superbatch's batch axis is
        # dim 1, so its staging shards dim 1 and replicates the slots.
        batch_sh = NamedSharding(mesh, P(AXIS_DATA))
        fused_sh = NamedSharding(mesh, P(None, AXIS_DATA))
        staging = {
            "put_fn": lambda arrays: tuple(
                put_sharded(a, mesh, batch_sh) for a in arrays),
            "fused_put_fn": lambda arrays: tuple(
                put_sharded(a, mesh, fused_sh) for a in arrays)}

    probe = PipelineProbe("two_tower")
    global_step = start_step
    pending = None  # (losses, slot steps) of the in-flight dispatch
    in_flight = 0  # raw steps covered by the in-flight dispatch
    try:
        with DevicePrefetcher(source, prep, **staging,
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


def _whole(params: Dict) -> Dict:
    """``params`` with a mesh state's leaves assembled whole on their
    first block's device (the meshless tree as is)."""
    if not _on_mesh(params):
        return params
    with torch.no_grad():
        return _map(lambda x: x.full(), params)


def eval_loss(params: Dict, user_ids, item_ids, cfg: TwoTowerConfig
              ) -> float:
    """In-batch sampled-softmax loss of ``params`` on one interaction
    sample — the warm-start regression gate's comparable scalar."""
    params = _whole(params)
    dev = params["user_embed"].device
    u = _ids(np.asarray(user_ids, np.int32), dev)
    i = _ids(np.asarray(item_ids, np.int32), dev)
    w = torch.ones(u.shape[0], dtype=torch.float32, device=dev)
    with torch.no_grad():
        return float(_loss(params, u, i, w, cfg.temperature))


def encode_users(params: Dict, user_ids) -> torch.Tensor:
    params = _whole(params)
    with torch.no_grad():
        return _forward_users(params, _ids(user_ids,
                                           params["user_embed"].device))


def encode_items(params: Dict, item_ids) -> torch.Tensor:
    params = _whole(params)
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

    params = _whole(params)
    q = encode_users(params, user_ids).contiguous()
    all_items = encode_items(
        params, torch.arange(n_items, device=params["item_embed"].device)
    ).contiguous()
    if chunk:
        return fused_topk(q, all_items, k)
    return top_k_scores(q, all_items, k)
