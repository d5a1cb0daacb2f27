"""Mixture-of-Experts functional core in plain PyTorch.

Counterpart of ``paddle_tpu/ops/moe.py`` (jnp in the reference, no Pallas
kernel): the GShard/Switch dense-dispatch form, with a fixed expert
capacity C, one-hot dispatch and combine tensors and einsum dispatch.

Shapes: tokens x ``[S, M]``, logits ``[S, E]``, dispatch and combine
``[S, E, C]``, expert weights stacked ``[E, ...]``.

Where the reference reads ``FLAGS_moe_capacity_factor`` (default 1.25) for
top-2 gating, the port, which has no flags, takes 1.25. Argmax ties go to
the first index, as ``jnp.argmax`` gives them. ``jax.nn.gelu`` is the tanh
approximation by default, and so is ``moe_ffn``'s "gelu" here.

Registered at import under the schema's names, as the reference registers
them: ``moe_gate_top1``, ``moe_gate_top2``, ``moe_dispatch``,
``moe_combine`` and ``fused_moe`` (``moe_ffn``: ``(out, aux)``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

DEFAULT_CAPACITY_FACTOR = 1.25   # the reference's FLAGS_moe_capacity_factor

_ACTIVATIONS = {
    "gelu": lambda h: F.gelu(h, approximate="tanh"),  # jax.nn.gelu's default
    "relu": F.relu,
    "silu": F.silu,
}


def _capacity(s: int, e: int, k: int, capacity_factor: float,
              capacity: Optional[int]) -> int:
    if capacity is not None:
        return max(int(capacity), 1)
    return max(int(s * k * capacity_factor / e + 0.999999), 1)


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside ``[0, n)`` gives a zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def top2_gating(logits: torch.Tensor, capacity_factor: float = None,
                capacity: Optional[int] = None):
    """GShard top-2 gating. logits ``[S, E]`` -> (combine ``[S, E, C]``,
    dispatch bool ``[S, E, C]``, aux_loss); aux_loss is the load-balance
    loss ``E * sum(me * ce)``."""
    if capacity_factor is None:
        capacity_factor = DEFAULT_CAPACITY_FACTOR
    s, e = logits.shape
    c = _capacity(s, e, 2, capacity_factor, capacity)
    probs = torch.softmax(logits.float(), dim=-1)

    g1_idx = torch.argmax(probs, dim=-1)
    mask1 = _one_hot(g1_idx, e, probs.dtype)
    probs2 = probs * (1.0 - mask1)
    g2_idx = torch.argmax(probs2, dim=-1)
    mask2 = _one_hot(g2_idx, e, probs.dtype)

    # load-balance aux loss over the top-1 assignment
    me = probs.mean(0)
    ce = mask1.mean(0)
    aux_loss = (me * ce).sum() * e

    # positions within each expert's buffer (top-1 tokens first)
    pos1 = torch.cumsum(mask1, 0) * mask1 - mask1
    mask1 = mask1 * (pos1 < c)
    pos2 = torch.cumsum(mask2, 0) - mask2 + mask1.sum(0, keepdim=True)
    mask2 = mask2 * (pos2 < c)
    pos2 = pos2 * mask2

    g1 = (probs * mask1).sum(-1)
    g2 = (probs * mask2).sum(-1)
    denom = torch.clamp(g1 + g2, min=1e-9)
    g1, g2 = g1 / denom, g2 / denom

    loc1 = (pos1 * mask1).sum(-1).to(torch.int32)
    loc2 = pos2.sum(-1).to(torch.int32)
    oh_c1 = _one_hot(loc1, c, probs.dtype)
    oh_c2 = _one_hot(loc2, c, probs.dtype)
    combine = (g1[:, None, None] * mask1[:, :, None] * oh_c1[:, None, :]
               + g2[:, None, None] * mask2[:, :, None] * oh_c2[:, None, :])
    dispatch = combine > 0.0
    return combine, dispatch, aux_loss


def top1_gating(logits: torch.Tensor, capacity_factor: float = 1.25,
                capacity: Optional[int] = None, jitter_eps: float = 0.0,
                generator: Optional[torch.Generator] = None):
    """Switch-Transformer top-1 gating. With ``jitter_eps > 0`` and a
    ``generator``, the logits are first scaled by noise drawn uniformly
    from ``[1 - jitter_eps, 1 + jitter_eps)`` (the reference draws it from
    a ``jax.random`` key: the same distribution, not the same numbers)."""
    s, e = logits.shape
    c = _capacity(s, e, 1, capacity_factor, capacity)
    if jitter_eps > 0.0 and generator is not None:
        noise = torch.rand(logits.shape, generator=generator,
                           device=logits.device, dtype=torch.float32)
        logits = logits * (1.0 - jitter_eps + 2.0 * jitter_eps * noise)
    probs = torch.softmax(logits.float(), dim=-1)
    idx = torch.argmax(probs, dim=-1)
    mask = _one_hot(idx, e, probs.dtype)
    me = probs.mean(0)
    ce = mask.mean(0)
    aux_loss = (me * ce).sum() * e
    pos = torch.cumsum(mask, 0) * mask - mask
    mask = mask * (pos < c)
    gate = (probs * mask).sum(-1)
    loc = (pos * mask).sum(-1).to(torch.int32)
    oh_c = _one_hot(loc, c, probs.dtype)
    combine = gate[:, None, None] * mask[:, :, None] * oh_c[:, None, :]
    dispatch = combine > 0.0
    return combine, dispatch, aux_loss


def moe_dispatch(x: torch.Tensor, dispatch: torch.Tensor) -> torch.Tensor:
    """x ``[S, M]``, dispatch ``[S, E, C]`` -> expert inputs ``[E, C, M]``."""
    return torch.einsum("sec,sm->ecm", dispatch.to(x.dtype), x)


def moe_combine(expert_out: torch.Tensor,
                combine: torch.Tensor) -> torch.Tensor:
    """expert_out ``[E, C, M]``, combine ``[S, E, C]`` -> ``[S, M]``."""
    return torch.einsum("sec,ecm->sm", combine.to(expert_out.dtype),
                        expert_out)


def moe_ffn(x, gate_w, w0, b0, w1, b1, *, k: int = 2,
            capacity_factor: float = 1.25, capacity: Optional[int] = None,
            activation: str = "gelu"):
    """Gating, dispatch, grouped expert MLP and combine. x ``[S, M]``;
    gate_w ``[M, E]``; w0 ``[E, M, H]``, b0 ``[E, H]``, w1 ``[E, H, M]``,
    b1 ``[E, M]``. Returns (out ``[S, M]``, fp32 aux_loss)."""
    if activation not in _ACTIVATIONS:
        raise NotImplementedError(f"moe_ffn: activation {activation!r} is "
                                  f"not ported ({sorted(_ACTIVATIONS)})")
    logits = x @ gate_w.to(x.dtype)
    if k == 1:
        combine, dispatch, aux = top1_gating(logits, capacity_factor,
                                             capacity)
    else:
        combine, dispatch, aux = top2_gating(logits, capacity_factor,
                                             capacity)
    xe = moe_dispatch(x, dispatch)
    h = torch.einsum("ecm,emh->ech", xe, w0.to(x.dtype)) \
        + b0[:, None, :].to(x.dtype)
    h = _ACTIVATIONS[activation](h)
    ye = torch.einsum("ech,ehm->ecm", h, w1.to(x.dtype)) \
        + b1[:, None, :].to(x.dtype)
    out = moe_combine(ye, combine.to(x.dtype))
    return out, aux.float()


# -------------------------------------------------- eager op registration
# the reference registers the same five at import (``ops/moe.py``
# ``_register``), with these bodies and the schema's attrs

def _register():
    from .._core.op_registry import register_op

    register_op("moe_gate_top2", top2_gating, multi_output=True)
    register_op("moe_gate_top1",
                lambda logits, capacity_factor=1.25, capacity=None:
                top1_gating(logits, capacity_factor, capacity),
                multi_output=True)
    register_op("moe_dispatch", moe_dispatch)
    register_op("moe_combine", moe_combine)
    register_op("fused_moe", moe_ffn, multi_output=True)


_register()
