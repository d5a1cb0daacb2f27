"""The kernels' entries as ``torch.library`` ops, so that a tracer sees them.

Each kernel wrapper takes raw data pointers through ``ctypes``, which no
tracer can follow: ``make_fx``, ``torch.export`` and ``torch.compile`` stop
at a fake tensor's ``data_ptr``. :func:`define` registers an entry as the op
``paddle_tpu_torch::<name>``: its CUDA and CPU implementations are the
entry's wrapper, which on a CUDA tensor launches the hand-written kernel
(or raises) and on a CPU tensor runs the plain PyTorch version, its fake
implementation gives the output shapes and types, and a forward entry has
its autograd formula. A traced program then holds each kernel as one
node, and the compiled program launches the same kernel the eager call
launches. No other device has an implementation: a call there raises.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

NAMESPACE = "paddle_tpu_torch"


def define(name: str, schema: str, impl: Callable, fake: Callable,
           backward: Optional[Callable] = None,
           setup_context: Optional[Callable] = None):
    """Registers op ``paddle_tpu_torch::<name>`` with ``schema`` (its
    arguments and results in the ``torch.library`` schema language);
    returns it. The kernels read their inputs with the strides the eager
    call gives them (``needs_exact_strides``), so a compiler keeps those."""
    def contiguous_impl(*args):
        # the plain versions may return strided results; the kernels and
        # the fake implementations give contiguous ones
        out = impl(*args)
        if isinstance(out, tuple):
            return tuple(t.contiguous() for t in out)
        return out.contiguous()

    op = torch.library.custom_op(
        f"{NAMESPACE}::{name}", contiguous_impl, mutates_args=(),
        device_types=("cuda", "cpu"), schema=schema,
        tags=(torch.Tag.needs_exact_strides,))
    op.register_fake(fake)
    if backward is not None:
        op.register_autograd(backward, setup_context=setup_context)
    return op


def ops():
    """Every op this package registers, by name (after the kernel modules
    are imported)."""
    from . import flash_attention, flash_varlen, fused  # noqa: F401
    return {name: getattr(getattr(torch.ops, NAMESPACE), name)
            for name in OP_NAMES}


OP_NAMES = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq",
            "varlen_fwd", "varlen_bwd_dkv", "varlen_bwd_dq",
            "flashmask_fwd", "flashmask_bwd_dkv", "flashmask_bwd_dq",
            "rms_norm", "swiglu")
