"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. A request
for CUDA on a machine without a usable CUDA device raises: the port never
carries on silently on the CPU, where every kernel would quietly take its
plain PyTorch version.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`device` (default "cuda") → torch.device; raises RuntimeError when a
    CUDA device is asked for and none is available.

    On CUDA this also pins fp32 matmuls and convolutions to full fp32
    (no TF32): the fp32 conv stem, the log-mel DFT and the fp32 logits
    product are specified in fp32, and cuDNN defaults to TF32."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass --device cpu (or "
                "device='cpu') to run the port's plain PyTorch path on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use cuda or cpu")
    return dev
