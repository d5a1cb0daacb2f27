"""Single-device AdamW trainer: forward, backward and the fused update.

Counterpart of ``build_adamw_train_step`` in ``paddle_tpu/models/trainer.py``
without its mesh, sharding and ZeRO-1 machinery. The state is the
reference's ``{"params", "master", "m", "v", "step"}``: params in their own
type (bf16 on the training path), an fp32 master copy, fp32 moments and an
int32 step count. The update is the reference's, written out in plain
torch rather than ``torch.optim.AdamW`` (whose decay sits outside the
learning-rate product and would round differently):

    m    = b1 m + (1 - b1) g
    v    = b2 v + (1 - b2) g²
    t    = step + 1
    W    = W - lr (m / (1 - b1ᵗ) / (sqrt(v / (1 - b2ᵗ)) + eps) + wd W)
    p    = W cast to p's type

Where the reference donates the state to the compiled step, this trainer
updates the state's tensors in place.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch
from torch.profiler import record_function

from .._core.device import DeviceLike, resolve_device


def tree_leaves(tree) -> List[Any]:
    """Leaves of a nested dict in sorted-key order (``jax.tree_util``'s
    order for dicts)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def build_adamw_train_step(
        loss_fn: Callable,         # (params, *batch) -> scalar loss
        init_params_fn: Callable,  # (seed) -> params tree
        wd_mask,                   # bool tree matching params
        lr: float = 3e-4, wd: float = 0.1, b1: float = 0.9,
        b2: float = 0.95, eps: float = 1e-8, device: DeviceLike = None):
    """Returns ``(init_fn, step_fn)``; ``step_fn(state, *batch)`` returns
    ``(state, loss)``, with ``state`` updated in place."""
    dev = resolve_device(device)

    def init_fn(seed: int = 0) -> Dict[str, Any]:
        params = init_params_fn(seed)
        master = tree_map(lambda p: p.detach().float().clone(), params)
        return {"params": params, "master": master,
                "m": tree_map(torch.zeros_like, master),
                "v": tree_map(torch.zeros_like, master),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def step_fn(state, *batch):
        params = tree_map(lambda p: p.detach().requires_grad_(),
                          state["params"])
        leaves = tree_leaves(params)
        # profiler ranges: a traced step splits its device time by phase
        # (the backward needs none: autograd launches its kernels from its
        # own thread, outside any range of this one)
        with record_function("forward"):
            loss = loss_fn(params, *batch)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad(), record_function("optimizer"):
            state["step"] += 1
            t = state["step"].float()
            bc1 = 1 - b1 ** t
            bc2 = 1 - b2 ** t
            for p, w, g, m, v, use_wd in zip(
                    tree_leaves(state["params"]),
                    tree_leaves(state["master"]), grads,
                    tree_leaves(state["m"]), tree_leaves(state["v"]),
                    tree_leaves(wd_mask)):
                g = g.float()
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * g * g)
                upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
                if use_wd:
                    upd.add_(wd * w)
                w.sub_(lr * upd)
                p.copy_(w)
        return state, loss.detach()

    return init_fn, step_fn
