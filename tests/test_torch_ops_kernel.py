"""The kernel, MoE and attention ops and the segment reductions, called by
their registered names (``flash_attention``, ``flash_attn_varlen``,
``flashmask_attention``, ``fused_rms_norm``, ``fused_swiglu``,
``fused_rope``, ``moe_gate_top1``, ``moe_gate_top2``, ``moe_dispatch``,
``moe_combine``, ``fused_moe``, ``segment_*``), against the JAX
package's on the CPU, forward and gradient, in fp32 and, for the kernel
ops, bf16 (limits: ``tests/torch_ops_harness.py``). The reference's
Pallas bodies run in interpret mode, as its own tests run them off the
TPU; it registers several of these ops on its entries' first call, so
each entry is called once first."""
import numpy as np
import pytest

import paddle_tpu as ref
from paddle_tpu.ops import pallas as ref_pallas
from paddle_tpu.ops.pallas import flash_varlen as ref_varlen
from paddle_tpu_torch._core import device as pt_device

import torch_ops_harness as h

GROUPS = ('kernel',)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(pt_device, "_current", "cpu")


@pytest.fixture(scope="module", autouse=True)
def _reference_registers_its_lazy_ops():
    """One call of each reference entry that registers an op of this
    group on first use (at the smallest shape it takes)."""
    t = ref.to_tensor
    z = np.zeros((1, 128, 1, 8), np.float32)
    ref_pallas.flash_attention(t(z), t(z), t(z))
    cu = t(np.array([0, 128], np.int32))
    ref_varlen.flash_attn_varlen(t(z[0]), t(z[0]), t(z[0]), cu, cu)
    ref_varlen.flashmask_attention_pallas(
        t(z), t(z), t(z), t(np.full((1, 1, 128, 1), 128, np.int32)))
    x = t(np.ones((2, 4), np.float32))
    ref_pallas.rms_norm(x, t(np.ones(4, np.float32)))
    ref_pallas.swiglu(x, x)
    q = t(np.ones((1, 2, 1, 4), np.float32))
    ref_pallas.fused_rotary_position_embedding(q, q)
    ref.incubate.segment_mean(x, t(np.array([0, 1])))


@pytest.mark.parametrize("c,dtype", h.cases(*GROUPS, low=True))
def test_kernel_ops_match_reference(c, dtype):
    h.check_case(c, dtype)


def test_every_op_of_the_group_is_driven():
    names = {o for c in h.oc.CASES if c.group == "kernel" for o in c.ops}
    assert names == set(
        "flash_attention flash_attn_varlen flashmask_attention "
        "fused_rms_norm fused_swiglu fused_rope moe_gate_top1 "
        "moe_gate_top2 moe_dispatch moe_combine fused_moe segment_sum "
        "segment_mean segment_max segment_min".split())
