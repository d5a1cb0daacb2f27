"""The port's binary elementwise ops (the ``_helper`` binary family:
arithmetic, comparison, logical and bitwise ops with the reference's
promotion) and the composites of ``math.py`` and ``math_ext.py`` (scale,
clip, lerp, the cumulative ops, addmm, the gamma and Bessel functions,
slicing and diagonal tools, norms) against the JAX package's on the CPU,
forward and gradient, in fp32 and bf16 (limits:
``tests/torch_ops_harness.py``); and their output types under AMP O1 and
O2."""
import pytest

from paddle_tpu_torch._core import device as pt_device

import torch_ops_harness as h

GROUPS = ('binary',)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(pt_device, "_current", "cpu")


@pytest.mark.parametrize("c,dtype", h.cases(*GROUPS, low=True))
def test_binary_ops_match_reference(c, dtype):
    h.check_case(c, dtype)


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("c", [p.values[0] for p in h.cases(*GROUPS)],
                         ids=lambda c: c.name)
def test_binary_ops_amp_types_match_reference(c, level):
    h.check_amp_types(c, level)
