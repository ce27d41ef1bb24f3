"""Asymmetric PQ LUT scan + top-k (kernel K5) — the ``pq_flat`` rung's kernel.

Port of ``pq_scan_pallas`` / ``pq_scan`` in
``predictionio_tpu/ops/pallas_kernels.py``: the top-k over items ``n`` of
``Σ_t luts[b, t, codes[t, n]]`` for per-query lookup tables ``luts``
[B, S, 256] float32 and a packed code matrix ``codes`` [S, N] uint8
(S = 1 + M: the coarse table, then one per subspace).  Three functions:

- :func:`pq_scan_reference` — the plain PyTorch version (per table an
  ``index_select`` of the LUT row at the codes, summed into [B, N]
  float32, columns at or past ``n_valid`` set to ``NEG_INF``,
  ``torch.topk``); what the reference's ``pq_scan_xla`` computes.
- :func:`pq_scan_cuda` — launches the hand-written CUDA kernel
  (``predictionio_tpu_torch/csrc/pq_scan.cu``): tables in shared memory,
  one read of the codes (16 or 4 codes a thread a table, one load each),
  the [B, N] block never written, the chunks' candidates merged 16 a
  thread a round.
- :func:`pq_scan` — the dispatcher: CPU tensors take the reference, CUDA
  tensors take the kernel or raise.  There is no fallback.

``LAUNCHES`` counts kernel launches (one per :func:`pq_scan_cuda` call),
so a run can show that its serving path went through the kernel.

Ties: the kernel ranks the lower item id first among exactly equal scores
(its sums are bit-identical to the plain version's: the same float32 adds
in the same order); ``torch.topk`` promises no order, so callers compare
id sets where scores tie.  Slots that no item fills (fewer than k items
below ``n_valid``) hold score ``NEG_INF``: the kernel gives them id -1,
the reference the id of a masked column.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Optional, Tuple

import torch

from predictionio_tpu_torch.ops import _build
from predictionio_tpu_torch.ops.topk import NEG_INF

__all__ = ["pq_scan", "pq_scan_cuda", "pq_scan_reference", "plan", "Plan",
           "LAUNCHES", "LUT_WIDTH"]

LAUNCHES = 0
_LAUNCHES_LOCK = threading.Lock()

LUT_WIDTH = 256               # entries per table: one code byte
# Launch geometry; csrc/pq_scan.cu holds the same thread and query counts
# as kThreads / kMaxQ, and the items a thread scores a round as
# items_per_thread().
THREADS = 256                 # threads per block
MAX_QUERIES_PER_BLOCK = 8
ITEMS_PER_THREAD_ONE_QUERY = 16   # one 16-byte code load a table
ITEMS_PER_THREAD_SHARED = 4       # blocks of 2..8 queries: a 4-byte load
SMEM_BUDGET = 200 * 1024      # dynamic shared memory a block may take
TARGET_BLOCKS = 264           # two waves over the H100's 132 SMs
MAX_CANDIDATES = 1 << 17      # per query, handed to the merge pass

_CAND_BYTES = 8               # (float score, int id)


@dataclasses.dataclass(frozen=True)
class Plan:
    """Launch plan of one call: ``queries_per_block`` queries share a
    score-pass block and its staged tables; each query keeps a
    ``buffer``-slot candidate buffer; the items split into ``n_chunks``
    ranges of ``rows_per_chunk``, a multiple of the ``THREADS ·
    items_per_thread`` items a block scores a round, and the merge pass
    reads ``n_chunks·k`` candidates per query."""

    queries_per_block: int
    buffer: int
    n_chunks: int
    rows_per_chunk: int
    items_per_thread: int


def plan(b: int, n_real: int, s: int, k: int) -> Plan:
    """Grid and buffer sizes for ``b`` queries of ``s`` tables against
    ``n_real`` scanned items.  Raises ``ValueError`` when one query's
    tables and buffer cannot fit the shared-memory budget (at s = 65, the
    rank-256 M = 64 codebook, k up to 16,128 fits)."""
    if b < 1 or s < 1 or k < 1:
        raise ValueError(f"pq_scan plan needs b, s, k >= 1 "
                         f"(got b={b}, s={s}, k={k})")
    buffer = 1 << (k + THREADS - 1).bit_length()
    per_query = s * LUT_WIDTH * 4 + buffer * _CAND_BYTES
    qb = min(MAX_QUERIES_PER_BLOCK, b, SMEM_BUDGET // per_query)
    if qb < 1:
        raise ValueError(f"pq_scan: k={k} at {s} tables needs {per_query} "
                         f"bytes of shared memory per query, over the "
                         f"{SMEM_BUDGET}-byte budget")
    ipt = ITEMS_PER_THREAD_ONE_QUERY if qb == 1 else ITEMS_PER_THREAD_SHARED
    step = THREADS * ipt
    groups = -(-b // qb)
    n_chunks = min(-(-TARGET_BLOCKS // groups),
                   max(1, MAX_CANDIDATES // k),
                   max(1, -(-n_real // step)))
    rows = -(-max(n_real, 1) // n_chunks)
    rows = -(-rows // step) * step
    return Plan(queries_per_block=qb, buffer=buffer,
                n_chunks=max(1, -(-n_real // rows)), rows_per_chunk=rows,
                items_per_thread=ipt)


def pq_scan_reference(luts: torch.Tensor, codes: torch.Tensor, k: int, *,
                      n_valid: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: for each table ``t`` the LUT row gathered at
    ``codes[t]``, summed in table order into [B, N] float32; columns at
    or past ``n_valid`` set to ``NEG_INF``; ``torch.topk``.
    ``1 <= k <= N``."""
    lf = luts.float()
    acc = lf[:, 0].index_select(1, codes[0].long())
    for t in range(1, codes.shape[0]):
        acc = acc + lf[:, t].index_select(1, codes[t].long())
    n = codes.shape[1]
    if n_valid is not None and n_valid < n:
        acc[:, max(n_valid, 0):] = NEG_INF
    s, i = torch.topk(acc, k, dim=1)
    return s, i.to(torch.int32)


def _lib() -> ctypes.CDLL:
    lib = _build.load("pq_scan")
    fn = lib.pio_pq_scan
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, i, i, i, i, i, i, i, i, p, p, p, p, p]
        fn.restype = ctypes.c_int
        lib.pio_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pio_cuda_error_string.restype = ctypes.c_char_p
    return lib


def pq_scan_cuda(luts: torch.Tensor, codes: torch.Tensor, k: int, *,
                 n_valid: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel: ``luts`` [B, S, 256] float32 and ``codes``
    [S, N] uint8, both contiguous on one CUDA device, ``1 <= k <= N``.
    Returns ([B, k] float32 descending, [B, k] int32) on that device,
    queued on PyTorch's current stream."""
    global LAUNCHES
    if luts.device.type != "cuda" or codes.device != luts.device:
        raise ValueError(f"pq_scan_cuda needs both tensors on one CUDA "
                         f"device (got {luts.device} and {codes.device})")
    if luts.dtype != torch.float32 or codes.dtype != torch.uint8:
        raise TypeError(f"pq_scan_cuda takes float32 tables and uint8 codes "
                        f"(got {luts.dtype} and {codes.dtype})")
    if luts.dim() != 3 or codes.dim() != 2 or luts.shape[2] != LUT_WIDTH \
            or luts.shape[1] != codes.shape[0]:
        raise ValueError(f"pq_scan_cuda needs [B, S, {LUT_WIDTH}] tables and "
                         f"[S, N] codes (got {tuple(luts.shape)} and "
                         f"{tuple(codes.shape)})")
    if not (luts.is_contiguous() and codes.is_contiguous()):
        raise ValueError("pq_scan_cuda needs contiguous tensors")
    if luts.data_ptr() % 16:
        raise ValueError("pq_scan_cuda needs 16-byte aligned tables")
    b, s, _ = luts.shape
    n = codes.shape[1]
    if not 1 <= k <= n:
        raise ValueError(f"pq_scan_cuda: k={k} outside [1, {n}]")
    if b < 1:
        raise ValueError("pq_scan_cuda needs at least one query")
    n_real = n if n_valid is None else max(0, min(n_valid, n))
    p = plan(b, n_real, s, k)
    if p.n_chunks * p.rows_per_chunk + THREADS * p.items_per_thread \
            >= 2 ** 31:
        # the kernel walks item columns with int32 indices
        raise ValueError(f"pq_scan_cuda: N={n} is too large")
    dev = luts.device
    part_s = torch.empty((b, p.n_chunks, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((b, p.n_chunks, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pio_pq_scan(
            luts.data_ptr(), codes.data_ptr(), b, s, n, n_real, k, p.buffer,
            p.queries_per_block, p.rows_per_chunk, p.n_chunks,
            part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(),
            out_i.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"pq_scan kernel launch failed: "
                           f"{lib.pio_cuda_error_string(rc).decode()} "
                           f"(code {rc}, B={b}, S={s}, N={n}, k={k})")
    with _LAUNCHES_LOCK:
        LAUNCHES += 1
    return out_s, out_i


def pq_scan(luts: torch.Tensor, codes: torch.Tensor, k: int, *,
            n_valid: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch by device, mirroring the reference dispatcher's contract:
    ``k <= 0`` gives empty [B, 0] outputs and ``k`` is clamped to N.  CPU
    tensors take :func:`pq_scan_reference`; anything else goes to
    :func:`pq_scan_cuda`, which launches the kernel or raises."""
    b = luts.shape[0]
    if k <= 0:
        return (torch.zeros((b, 0), dtype=torch.float32, device=luts.device),
                torch.zeros((b, 0), dtype=torch.int32, device=luts.device))
    k = min(k, codes.shape[1])
    if luts.device.type == "cpu" and codes.device.type == "cpu":
        return pq_scan_reference(luts, codes, k, n_valid=n_valid)
    return pq_scan_cuda(luts, codes, k, n_valid=n_valid)
