"""Device selection and float32 numerics for the port.

``device()`` is the one place the port decides where it runs: the CUDA
card by default, the CPU only when the caller asks for it by name.  There
is no quiet fallback — a machine without CUDA raises unless ``"cpu"`` was
requested, so a serving process can never drift onto the CPU unnoticed.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["device", "set_float32_precision"]


def device(requested: Optional[Union[str, torch.device]] = None
           ) -> torch.device:
    """Resolve where the port runs.

    ``None`` means the CUDA card (``cuda``); ``"cpu"`` (or a CPU
    ``torch.device``) means the CPU; any other value names a CUDA device
    (``"cuda:1"``).  Raises ``RuntimeError`` when a CUDA device is asked
    for — explicitly or by default — and CUDA is not available.
    """
    dev = torch.device("cuda" if requested is None else requested)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev!s}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev!s} requested but CUDA is not available; pass "
            "device='cpu' to run the port's plain PyTorch paths on the CPU")
    return dev


def set_float32_precision() -> None:
    """Keep float32 matrix products in full float32 on the card.

    The fused top-k kernel scores in float32 and its plain version is a
    float32 ``matmul``; TF32 would keep about three decimal digits and
    change which items make the top-k.  Both switches are set explicitly
    rather than trusted to PyTorch's defaults.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
