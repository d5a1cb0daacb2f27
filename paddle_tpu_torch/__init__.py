"""paddle_tpu_torch: the PyTorch and CUDA port of ``paddle_tpu``.

A second package beside ``paddle_tpu`` (the JAX reference). Plain tensor
code is PyTorch; every Pallas kernel of the reference becomes a kernel
written by hand for Hopper (``sm_90a``), built from ``csrc/`` at first use.
This package never imports JAX or ``paddle_tpu``.

Entry points run on CUDA unless the caller passes ``device="cpu"``; with no
device and no card they raise (see :func:`resolve_device`).
"""
from ._core.device import resolve_device

__all__ = ["resolve_device"]
