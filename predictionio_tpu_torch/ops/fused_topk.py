"""Fused corpus score + top-k (kernel K3) — the chunked exact rung's kernel.

Port of ``fused_topk_pallas`` / ``fused_topk`` in
``predictionio_tpu/ops/pallas_kernels.py``.  Three functions:

- :func:`fused_topk_reference` — the plain PyTorch version (``matmul`` +
  mask + ``torch.topk``); it materializes the [B, N] score block.
- :func:`fused_topk_cuda` — launches the hand-written CUDA kernel
  (``predictionio_tpu_torch/csrc/fused_topk.cu``), which never writes the
  score block: one read of the corpus plus O(B·chunks·k) scratch.  Its
  score pass has two routes, picked by :func:`plan`: register-tiled
  blocks of up to 64 queries over a ``cp.async`` corpus ring, and one
  thread a row for what the tiled blocks do not take (small B on rows
  that are not whole float4s, k or D too large for their shared memory).
- :func:`fused_topk` — the dispatcher: CPU tensors take the reference,
  CUDA tensors take the kernel or raise.  There is no fallback.

``LAUNCHES`` counts kernel launches (one per :func:`fused_topk_cuda`
call), so a run can show that its serving path went through the kernel.

Ties: the kernel ranks the lower item id first among exactly equal
scores; the Pallas kernel keeps the lowest running slot and
``torch.topk`` promises no order, so callers compare id sets where
scores tie.  Slots the corpus cannot fill (fewer than k rows below
``n_valid``) hold score ``NEG_INF``: the kernel gives them id -1, the
reference the id of a masked row.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Optional, Tuple

import torch

from predictionio_tpu_torch.ops import _build
from predictionio_tpu_torch.ops.topk import NEG_INF

__all__ = ["fused_topk", "fused_topk_cuda", "fused_topk_reference",
           "bind", "launch", "plan", "small_plan", "tiled_plan", "Plan",
           "tiled_smem_bytes", "LAUNCHES"]

LAUNCHES = 0
_LAUNCHES_LOCK = threading.Lock()

# Launch geometry; csrc/fused_topk.cu holds the same thread and query
# counts as kThreads / kMaxQ, and the tiled route's as kTileRows /
# kStages / TileShape.
THREADS = 256                 # threads per block = corpus rows per tile
MAX_QUERIES_PER_BLOCK = 8
SMEM_BUDGET = 200 * 1024      # dynamic shared memory a block may take
TARGET_BLOCKS = 264           # two blocks an SM over the H100's 132 SMs
MAX_CANDIDATES = 1 << 17      # per query, handed to the merge pass
MIN_ROWS_PER_CHUNK = 2 * THREADS
# The tiled route takes rows of whole float4s (D % 4 == 0, 16-byte
# copies) at every B, and other rows (4-byte copies) from B =
# TILED_MIN_BATCH: the crossover timed by tools/exp_topk.py routes.
TILED_MIN_BATCH = 8
TILED_QUERIES = (8, 16, 32, 64)   # queries a block, one kernel each
TILE_ROWS = 128
TILED_STAGES = 2
TILED_MIN_ROWS_PER_CHUNK = 2 * TILE_ROWS
BOUND_SLOTS = 9               # topk_select.cuh kBoundSlots

_CAND_BYTES = 8               # (float score, int id)


@dataclasses.dataclass(frozen=True)
class Plan:
    """Launch plan of one call: the score pass's route (``tiled``), with
    ``queries_per_block`` queries a block, each keeping a
    ``buffer``-slot shared-memory candidate buffer; the corpus splits
    into ``n_chunks`` ranges of ``rows_per_chunk`` rows, and the merge
    pass folds each query's ``n_chunks·k`` candidates through a
    ``merge_buffer``-slot buffer."""

    queries_per_block: int
    buffer: int
    n_chunks: int
    rows_per_chunk: int
    tiled: bool
    merge_buffer: int


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


def tiled_smem_bytes(qb: int, d: int, buffer: int) -> int:
    """Dynamic shared memory of a tiled-route block (``tiled_smem`` in
    csrc/fused_topk.cu): the copy ring's rows (D padded to whole float4s,
    then to an odd number of them), the queries, the candidate buffers,
    offer_block's bound slots and three counters a query."""
    d4 = -(-d // 4) * 4
    pitch = d4 + 4 if (d4 // 4) % 2 == 0 else d4
    return (4 * TILED_STAGES * TILE_ROWS * pitch
            + qb * (4 * d4 + _CAND_BYTES * (buffer + BOUND_SLOTS) + 12))


def _chunks(groups: int, n_real: int, k: int, target: int, min_rows: int,
            align: int) -> Tuple[int, int]:
    n_chunks = min(-(-target // groups), max(1, MAX_CANDIDATES // k),
                   max(1, -(-n_real // min_rows)))
    rows = -(-max(n_real, 1) // n_chunks)
    rows = -(-rows // align) * align
    return max(1, -(-n_real // rows)), rows


def tiled_plan(b: int, n_real: int, d: int, k: int) -> Optional[Plan]:
    """The tiled route's plan, or None when not even a block of 8 queries
    fits the shared-memory budget (k above 1,024 at D 64, or D above
    about 180): the fewest of ``TILED_QUERIES`` that hold all ``b``
    queries, or the most that fit, each with a buffer of the next power
    of two >= 2k slots (at least 32)."""
    buffer = max(32, _pow2_at_least(2 * k))
    fits = [q for q in TILED_QUERIES
            if tiled_smem_bytes(q, d, buffer) <= SMEM_BUDGET]
    if not fits:
        return None
    qb = min([q for q in fits if q >= b] or [max(fits)])
    n_chunks, rows = _chunks(-(-b // qb), n_real, k, TARGET_BLOCKS,
                             TILED_MIN_ROWS_PER_CHUNK, TILE_ROWS)
    return Plan(queries_per_block=qb, buffer=buffer, n_chunks=n_chunks,
                rows_per_chunk=rows, tiled=True,
                merge_buffer=_pow2_at_least(k + THREADS))


def small_plan(b: int, n_real: int, d: int, k: int) -> Plan:
    """The small-B route's plan: up to 8 queries a block, a buffer of
    the next power of two >= k + 256 slots.  Raises ``ValueError`` when
    one query's buffer cannot fit the budget (k near 25,000)."""
    buffer = _pow2_at_least(k + THREADS)
    per_query = buffer * _CAND_BYTES + d * 4
    qb = min(MAX_QUERIES_PER_BLOCK, b, SMEM_BUDGET // per_query)
    if qb < 1:
        raise ValueError(f"fused_topk: k={k} at d={d} needs {per_query} "
                         f"bytes of shared memory per query, over the "
                         f"{SMEM_BUDGET}-byte budget")
    n_chunks, rows = _chunks(-(-b // qb), n_real, k, TARGET_BLOCKS,
                             MIN_ROWS_PER_CHUNK, THREADS)
    return Plan(queries_per_block=qb, buffer=buffer, n_chunks=n_chunks,
                rows_per_chunk=rows, tiled=False, merge_buffer=buffer)


def plan(b: int, n_real: int, d: int, k: int) -> Plan:
    """Route, grid and buffer sizes for ``b`` queries of width ``d``
    against ``n_real`` scored corpus rows: the tiled route for rows of
    whole float4s, or for ``b >= TILED_MIN_BATCH``, where its block fits
    (:func:`tiled_plan`); else the small-B route (:func:`small_plan`)."""
    if b < 1 or d < 1 or k < 1:
        raise ValueError(f"fused_topk plan needs b, d, k >= 1 "
                         f"(got b={b}, d={d}, k={k})")
    tiled = (tiled_plan(b, n_real, d, k)
             if d % 4 == 0 or b >= TILED_MIN_BATCH else None)
    return tiled or small_plan(b, n_real, d, k)


def fused_topk_reference(queries: torch.Tensor, items: torch.Tensor, k: int,
                         *, n_valid: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: float32 scores, rows at or past ``n_valid``
    set to ``NEG_INF``, ``torch.topk``.  ``1 <= k <= N``."""
    scores = queries.float() @ items.float().T
    n = items.shape[0]
    if n_valid is not None and n_valid < n:
        scores[:, max(n_valid, 0):] = NEG_INF
    s, i = torch.topk(scores, k, dim=1)
    return s, i.to(torch.int32)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures on a library built from csrc/fused_topk.cu
    (the package's, or a tool's edited copy)."""
    fn = lib.pio_fused_topk
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, i, i, i, i, i, i, i, i, i, i, p, p, p, p, p]
        fn.restype = ctypes.c_int
        lib.pio_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pio_cuda_error_string.restype = ctypes.c_char_p
    return lib


def launch(lib: ctypes.CDLL, queries: torch.Tensor, items: torch.Tensor,
           k: int, n_real: int, p: Plan
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Queue both passes of ``lib`` (bound by :func:`bind`) on PyTorch's
    current stream under plan ``p``, on tensors :func:`fused_topk_cuda`
    has checked; counts nothing."""
    b, d = queries.shape
    dev = queries.device
    part_s = torch.empty((b, p.n_chunks, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((b, p.n_chunks, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    vec4 = int(d % 4 == 0 and items.data_ptr() % 16 == 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pio_fused_topk(
            queries.data_ptr(), items.data_ptr(), b, d, n_real, k, p.buffer,
            p.queries_per_block, p.rows_per_chunk, p.n_chunks, vec4,
            int(p.tiled), p.merge_buffer, part_s.data_ptr(),
            part_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"fused_topk kernel launch failed: "
                           f"{lib.pio_cuda_error_string(rc).decode()} "
                           f"(code {rc}, B={b}, N={items.shape[0]}, D={d}, "
                           f"k={k})")
    return out_s, out_i


def fused_topk_cuda(queries: torch.Tensor, items: torch.Tensor, k: int, *,
                    n_valid: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel: ``queries`` [B, D] and ``items`` [N, D],
    both contiguous float32 on one CUDA device, ``1 <= k <= N``.
    Returns ([B, k] float32 descending, [B, k] int32) on that device,
    queued on PyTorch's current stream."""
    global LAUNCHES
    if queries.device.type != "cuda" or items.device != queries.device:
        raise ValueError(f"fused_topk_cuda needs both tensors on one CUDA "
                         f"device (got {queries.device} and {items.device})")
    if queries.dtype != torch.float32 or items.dtype != torch.float32:
        raise TypeError(f"fused_topk_cuda takes float32 (got "
                        f"{queries.dtype} and {items.dtype})")
    if queries.dim() != 2 or items.dim() != 2 \
            or queries.shape[1] != items.shape[1]:
        raise ValueError(f"fused_topk_cuda needs [B, D] and [N, D] (got "
                         f"{tuple(queries.shape)} and {tuple(items.shape)})")
    if not (queries.is_contiguous() and items.is_contiguous()):
        raise ValueError("fused_topk_cuda needs contiguous tensors")
    b, d = queries.shape
    n = items.shape[0]
    if not 1 <= k <= n:
        raise ValueError(f"fused_topk_cuda: k={k} outside [1, {n}]")
    n_real = n if n_valid is None else max(0, min(n_valid, n))
    p = plan(b, n_real, d, k)
    if p.n_chunks * p.rows_per_chunk + THREADS >= 2 ** 31:
        # the kernel walks corpus rows with int32 indices
        raise ValueError(f"fused_topk_cuda: N={n} is too large")
    out = launch(bind(_build.load("fused_topk")), queries, items, k, n_real,
                 p)
    with _LAUNCHES_LOCK:
        LAUNCHES += 1
    return out


def fused_topk(queries: torch.Tensor, items: torch.Tensor, k: int, *,
               n_valid: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch by device, mirroring the reference dispatcher's contract:
    ``k <= 0`` gives empty [B, 0] outputs and ``k`` is clamped to N.
    CPU tensors take :func:`fused_topk_reference`; anything else goes to
    :func:`fused_topk_cuda`, which launches the kernel or raises."""
    b = queries.shape[0]
    if k <= 0:
        return (torch.zeros((b, 0), dtype=torch.float32,
                            device=queries.device),
                torch.zeros((b, 0), dtype=torch.int32,
                            device=queries.device))
    k = min(k, items.shape[0])
    if queries.device.type == "cpu" and items.device.type == "cpu":
        return fused_topk_reference(queries, items, k, n_valid=n_valid)
    return fused_topk_cuda(queries, items, k, n_valid=n_valid)
