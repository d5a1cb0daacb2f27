"""The kernels' entries as ``torch.library`` ops
(``paddle_tpu_torch::*``, ``ops/cuda/library.py``), on the CPU.

``torch.library.opcheck`` of every op at a small shape: its schema (no
input mutated or aliased), its autograd registration, its fake
implementation against the CPU implementation (shapes, types, strides)
and AOTAutograd with dynamic shapes. The CPU implementation is the
entry's plain version; the CUDA one is held on the card (``chip_smoke.py``
phase 19 (e)). And each op's result on the CPU equals the plain version's
(bit for bit: the same function).
"""
import pytest
import torch

from paddle_tpu_torch.ops.cuda import flash_attention as fa
from paddle_tpu_torch.ops.cuda import flash_varlen as fv
from paddle_tpu_torch.ops.cuda import fused as fu
from paddle_tpu_torch.ops.cuda import library


def _r(*shape, seed=0, grad=False):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g).requires_grad_(grad)


def _qkv(grad, shape=(2, 64, 32)):
    return tuple(_r(*shape, seed=i, grad=grad) for i in range(3))


def _attention_bwd(fwd_args, delta_of):
    q, k, v = (t.detach() for t in fwd_args[:3])
    out, lse = library.ops()[FWD_OF[id(delta_of)]](q, k, v, *fwd_args[3:])
    do = _r(*out.shape, seed=7)
    return (q, k, v, do, lse, delta_of(do, out)) + tuple(fwd_args[3:])


FWD_OF = {id(fa.attention_delta): "flash_fwd",
          id(fv.varlen_delta): "varlen_fwd"}


def _flash(grad=True):
    return _qkv(grad) + (True, 0.2, 64, 0)


def _varlen(grad=True):
    cu = torch.tensor([0, 20, 50, 70], dtype=torch.int32)
    plan = fv.varlen_plan(cu, cu, 70, 70, True)
    return _qkv(grad, (70, 2, 32)) + fv._plan_args(plan) + (0.2,)


def _flashmask(grad=True):
    g = torch.Generator().manual_seed(3)
    st = torch.randint(0, 64, (1, 1, 64, 1), generator=g)
    plan = fv.flashmask_plan(st, 2, True)
    return _qkv(grad) + (plan.st, plan.en, plan.st_max, plan.en_min,
                         plan.heads, plan.col_heads, plan.causal, 0.2)


def _flashmask_bwd():
    args = _flashmask(False)
    q, k, v = args[:3]
    out, lse = library.ops()["flashmask_fwd"](*args)
    do = _r(*out.shape, seed=7)
    return (q, k, v, do, lse, fa.attention_delta(do, out)) + args[3:]


CASES = {
    "flash_fwd": _flash,
    "flash_bwd_dkv": lambda: _attention_bwd(_flash(False),
                                            fa.attention_delta),
    "flash_bwd_dq": lambda: _attention_bwd(_flash(False),
                                           fa.attention_delta),
    "varlen_fwd": _varlen,
    "varlen_bwd_dkv": lambda: _attention_bwd(_varlen(False),
                                             fv.varlen_delta),
    "varlen_bwd_dq": lambda: _attention_bwd(_varlen(False),
                                            fv.varlen_delta),
    "flashmask_fwd": _flashmask,
    "flashmask_bwd_dkv": _flashmask_bwd,
    "flashmask_bwd_dq": _flashmask_bwd,
    "rms_norm": lambda: (_r(8, 32, grad=True), _r(32, seed=1, grad=True),
                         1e-6),
    "swiglu": lambda: (_r(8, 64, grad=True), None),
}


def test_every_op_has_a_case():
    assert sorted(CASES) == sorted(library.OP_NAMES)


@pytest.mark.parametrize("name", library.OP_NAMES)
def test_opcheck(name):
    torch.library.opcheck(library.ops()[name], CASES[name]())


def test_swiglu_two_operand_form_and_its_gradient():
    x, g = _r(8, 32, grad=True), _r(8, 32, seed=1, grad=True)
    torch.library.opcheck(library.ops()["swiglu"], (x, g))
    y = fu.swiglu(x, g)
    assert torch.equal(y, fu.swiglu_fwd_plain(x.detach(), g.detach()))
    y.sum().backward()
    dx, dg = fu.swiglu_bwd(x.detach(), g.detach(), torch.ones_like(y))
    assert torch.equal(x.grad, dx) and torch.equal(g.grad, dg)


def test_cpu_results_are_the_plain_versions():
    q, k, v, causal, scale, kv_len, q_offset = _flash(False)
    out, lse = library.ops()["flash_fwd"](q, k, v, causal, scale, kv_len,
                                          q_offset)
    want = fa.flash_fwd_plain(q, k, v, causal, scale, kv_len, q_offset)
    assert torch.equal(out, want[0]) and torch.equal(lse, want[1])
    x, w = _r(8, 32), _r(32, seed=1)
    assert torch.equal(library.ops()["rms_norm"](x, w, 1e-6),
                       fu.rms_norm_fwd_plain(x, w, 1e-6))
