"""The port's linear algebra (``ops/linalg.py`` and ``paddle.linalg``:
products, norms, decompositions and solves) against the JAX package's on
the CPU, forward and gradient, in fp32 and bf16. Eigen- and singular
vectors and QR factors are compared through their reconstructions and
sign-normalised columns, not raw (limits: ``tests/torch_ops_harness.py``);
and their output types under AMP O1 and O2."""
import pytest

from paddle_tpu_torch._core import device as pt_device

import torch_ops_harness as h

GROUPS = ('linalg',)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(pt_device, "_current", "cpu")


@pytest.mark.parametrize("c,dtype", h.cases(*GROUPS, low=True))
def test_linalg_ops_match_reference(c, dtype):
    h.check_case(c, dtype)


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("c", [p.values[0] for p in h.cases(*GROUPS)],
                         ids=lambda c: c.name)
def test_linalg_ops_amp_types_match_reference(c, level):
    h.check_amp_types(c, level)
