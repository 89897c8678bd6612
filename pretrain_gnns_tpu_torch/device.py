"""Device resolution for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU: there is
no silent CPU fallback. Float32 matrix products and convolutions are
pinned to full float32 (no TF32), the numerics the JAX reference is
compared in.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``"cuda"``. Raises ``RuntimeError`` when CUDA is
    asked for and absent."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
