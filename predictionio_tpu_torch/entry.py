"""Entry point: one forward step on the flagship model.

Port of ``entry()`` in the repository's ``__graft_entry__.py``: the
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

The reference's ``dryrun_multichip`` (an n-device mesh) waits for the
port's ``parallel/``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple, Union

import torch

from predictionio_tpu_torch.device import device as resolve_device
from predictionio_tpu_torch.models.two_tower import (
    TwoTowerConfig,
    encode_items,
    encode_users,
    init_state,
)
from predictionio_tpu_torch.ops.topk import top_k_scores

__all__ = ["entry", "ENTRY_CONFIG"]

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
