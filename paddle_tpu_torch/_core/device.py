"""Device resolution: the counterpart of ``paddle_tpu/_core/device.py``.

The port's entry points run on the card. A caller that wants the CPU says
so (``device="cpu"``); nothing falls back to the CPU quietly.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the first CUDA device. Raises ``RuntimeError`` when
    CUDA is asked for (explicitly or by default) and there is no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on CUDA by default and no CUDA device "
                "is available; pass device='cpu' to run the plain path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: 'cuda' or 'cpu'")
    return dev
