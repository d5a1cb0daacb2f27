"""Device resolution and places: the counterpart of
``paddle_tpu/_core/device.py``.

The port's entry points run on the card. A caller that wants the CPU says
so (``device="cpu"``, or ``set_device("cpu")`` for the eager API); nothing
falls back to the CPU quietly.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the first CUDA device. Raises ``RuntimeError`` when
    CUDA is asked for (explicitly or by default) and there is no card."""
    if isinstance(device, str) and device.split(":")[0] == "gpu":
        device = "cuda" + device[3:]
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on CUDA by default and no CUDA device "
                "is available; pass device='cpu' (or call "
                "paddle.set_device('cpu')) to run the plain path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: 'gpu', 'cuda' or 'cpu'")
    return dev


class Place:
    device_type = "unknown"

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def __repr__(self):
        return f"Place({self.device_type}:{self.device_id})"

    def __eq__(self, other):
        return (isinstance(other, Place)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def get_device_id(self) -> int:
        return self.device_id


class CUDAPlace(Place):
    device_type = "gpu"


class CPUPlace(Place):
    device_type = "cpu"

    def __init__(self):
        super().__init__(0)


_current: Optional[str] = None  # set_device's choice; None: the card
_local = threading.local()      # ``on_host``'s override, per thread


@contextlib.contextmanager
def on_host():
    """The eager API creates tensors on the CPU in this thread while the
    block runs (the data loader's prefetch thread and its worker processes
    build samples and batches under it), whatever ``set_device`` chose."""
    before = getattr(_local, "cpu", False)
    _local.cpu = True
    try:
        yield
    finally:
        _local.cpu = before


def set_device(device: str) -> Place:
    """``paddle.set_device``: ``"gpu"``, ``"gpu:N"`` or ``"cpu"``. Where
    the eager API creates tensors from then on."""
    global _current
    dev = resolve_device(device)
    _current = "cpu" if dev.type == "cpu" else f"gpu:{dev.index}"
    return place_of(dev)


def get_device() -> str:
    """The device tensors are created on, as ``set_device`` names it; with
    no ``set_device`` the card (raises without one)."""
    if getattr(_local, "cpu", False):
        return "cpu"
    if _current is not None:
        return _current
    return f"gpu:{resolve_device(None).index}"


def default_device() -> torch.device:
    """The torch device the eager API creates tensors on."""
    if getattr(_local, "cpu", False):
        return torch.device("cpu")
    return resolve_device(_current)


def place_of(dev: torch.device) -> Place:
    return CPUPlace() if dev.type == "cpu" else CUDAPlace(dev.index or 0)


def to_device(place) -> torch.device:
    """A ``Place``, device string or ``torch.device`` (None: the default)."""
    if place is None:
        return default_device()
    if isinstance(place, Place):
        return resolve_device("cpu" if isinstance(place, CPUPlace)
                              else f"cuda:{place.device_id}")
    return resolve_device(place)


def device_count() -> int:
    """The number of CUDA cards (0 without one)."""
    return torch.cuda.device_count()


def is_compiled_with_cuda() -> bool:
    return True  # the port's kernels are CUDA


def is_compiled_with_tpu() -> bool:
    return False


def is_compiled_with_xpu() -> bool:
    return False


def in_dynamic_mode() -> bool:
    return True  # the port has no static mode
