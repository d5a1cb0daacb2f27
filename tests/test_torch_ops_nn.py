"""The port's ``nn.functional`` ops (activations, dense attention,
convolutions, pools, norms, losses, interpolation, sampling and the other
``extended`` functionals, each registered under the reference's op name)
against the JAX package's on the CPU, forward and gradient, in fp32 and,
for the activations, bf16 (limits: ``tests/torch_ops_harness.py``;
``exact`` cases 1e-6); and their output types under AMP O1 and O2."""
import pytest

from paddle_tpu_torch._core import device as pt_device

import torch_ops_harness as h

GROUPS = ('nn',)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(pt_device, "_current", "cpu")


@pytest.mark.parametrize("c,dtype", h.cases(*GROUPS, low=True))
def test_nn_ops_match_reference(c, dtype):
    h.check_case(c, dtype)


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("c", [p.values[0] for p in h.cases(*GROUPS)],
                         ids=lambda c: c.name)
def test_nn_ops_amp_types_match_reference(c, level):
    h.check_amp_types(c, level)
