"""Device policy: the port runs on the GPU unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``"cuda"``. Raises when a CUDA device is asked for (or
    implied) and none is present: the port never drops to the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def tf32(enabled: bool) -> None:
    """Allow or forbid TF32 in cuDNN convolutions and cuBLAS fp32 matmuls.
    Every fp32 comparison on the card runs with ``tf32(False)``."""
    torch.backends.cudnn.allow_tf32 = enabled
    torch.backends.cuda.matmul.allow_tf32 = enabled
