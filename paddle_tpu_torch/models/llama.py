"""LLaMA compiled-trainer path in PyTorch.

Counterpart of the single-device half of ``paddle_tpu/models/llama.py``:
RMSNorm pre-norm, rotary position embeddings, a SwiGLU MLP and
grouped-query attention, with the reference's parameter tree (per-block
arrays stacked ``[L, ...]``, so a tree moves between the two packages leaf
for leaf through ``models/convert.py``) and the trainer of
``models/trainer.py``.

Like the reference, this model runs no kernel of its own: attention is the
dense masked softmax (logits scaled and masked in the working type, softmax
in fp32, cast back before ``probs @ v``), the MLP is ``silu(gate) * up`` in
the working type and the norm is ``_rms``, which rounds the normalised
value to the working type before the gain. The fused RMSNorm and SwiGLU
kernels round elsewhere (once, after the weight) and are not used here.

Differences in form, not in function: a Python loop over layers instead of
the reference's ``lax.scan``, each block wrapped in
``torch.utils.checkpoint`` when ``remat`` is set. On a mesh, where the
reference lets GSPMD place its collectives, each rank runs shard-local
code with explicit ones (``distributed/fleet/mp_ops.py``): the Megatron
layout over mp, the vocab-parallel embedding and head (where the
reference's GSPMD runs the dense head on the split weight), and the
pipeline over pp (``distributed/pipeline_compiled.py``).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .._core.device import DeviceLike, resolve_device
from ..distributed.fleet.mp_ops import (
    embed_tokens, head_logits, mp_group, tp_enter, tp_leave,
    vocab_parallel_softmax_cross_entropy)
from ..distributed.mesh import PartitionSpec as P
from ..distributed.pipeline_compiled import pipelined_trunk
from .trainer import axis_size, check_mp, share_of_mean


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5504
    num_layers: int = 24
    num_heads: int = 16
    num_kv_heads: Optional[int] = None        # None = MHA; < heads = GQA
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    initializer_range: float = 0.02
    dtype: str = "bfloat16"
    tie_embeddings: bool = False

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    @property
    def kv_heads(self):
        return self.num_kv_heads or self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


# the reference's model table
LLAMA_CONFIGS = {
    "llama-tiny": LlamaConfig(vocab_size=1024, hidden_size=128,
                              intermediate_size=352, num_layers=2,
                              num_heads=4, num_kv_heads=2,
                              max_position_embeddings=256),
    "llama-7b": LlamaConfig(),
    "llama2-7b": LlamaConfig(hidden_size=4096, intermediate_size=11008,
                             num_layers=32, num_heads=32),
}

BLOCK_KEYS = ("ln1_g", "q_w", "k_w", "v_w", "o_w", "ln2_g", "gate_w",
              "up_w", "down_w")


def init_llama_params(config: LlamaConfig, seed: int = 0,
                      device: DeviceLike = None) -> Dict[str, Any]:
    """Random parameters in the reference's layout and types, drawn from a
    ``torch.Generator`` seeded with ``seed``: the same distributions as the
    reference's ``jax.random`` draw, not the same numbers."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = config
    h, f, L = c.hidden_size, c.intermediate_size, c.num_layers
    kvh = c.kv_heads * c.head_dim
    dt = c.torch_dtype
    std = c.initializer_range

    def norm(shape, scale=std):
        return (torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32) * scale).to(dt)

    def ones(*shape):
        return torch.ones(shape, device=dev, dtype=dt)

    params = {
        "wte": norm((c.vocab_size, h)),
        "blocks": {
            "ln1_g": ones(L, h),
            "q_w": norm((L, h, h)),
            "k_w": norm((L, h, kvh)),
            "v_w": norm((L, h, kvh)),
            "o_w": norm((L, h, h), scale=std / math.sqrt(2 * L)),
            "ln2_g": ones(L, h),
            "gate_w": norm((L, h, f)),
            "up_w": norm((L, h, f)),
            "down_w": norm((L, f, h), scale=std / math.sqrt(2 * L)),
        },
        "lnf_g": ones(h),
    }
    if not c.tie_embeddings:
        params["lm_head"] = norm((c.vocab_size, h))
    return params


def wd_mask(config: LlamaConfig) -> Dict[str, Any]:
    """Decay every matrix and embedding, no norm gain."""
    mask = {
        "wte": True,
        "blocks": {k: not k.startswith("ln") for k in BLOCK_KEYS},
        "lnf_g": False,
    }
    if not config.tie_embeddings:
        mask["lm_head"] = True
    return mask


def num_params(config: LlamaConfig) -> int:
    """Parameter count of the tree ``init_llama_params`` builds."""
    c = config
    h, f, L = c.hidden_size, c.intermediate_size, c.num_layers
    kvh = c.kv_heads * c.head_dim
    per_block = 2 * h + 2 * h * h + 2 * h * kvh + 3 * h * f
    heads = 1 if c.tie_embeddings else 2
    return L * per_block + heads * c.vocab_size * h + h


# ------------------------------------------------------------------ rope

def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x ``[B, S, H, D]`` -> rotated, half-split convention, fp32 trig."""
    s, d = x.shape[1], x.shape[3]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs[None, :]
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]
    xf1 = x[..., :half].float()
    xf2 = x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def _rms(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 statistics; the normalised value is rounded to x's type before
    ``* g``, as in the reference's ``_rms``."""
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype) * g


def param_specs(config: LlamaConfig, pp: Optional[str] = None) -> Dict:
    """The reference's Megatron TP layout: q/k/v/gate/up column-split,
    o/down row-split, the embeddings vocab-split; ``pp`` splits the stacked
    layer dim of the blocks."""
    blocks = {
        "ln1_g": P(pp, None),
        "q_w": P(pp, None, "mp"), "k_w": P(pp, None, "mp"),
        "v_w": P(pp, None, "mp"), "o_w": P(pp, "mp", None),
        "ln2_g": P(pp, None),
        "gate_w": P(pp, None, "mp"), "up_w": P(pp, None, "mp"),
        "down_w": P(pp, "mp", None),
    }
    specs = {"wte": P("mp", None), "blocks": blocks, "lnf_g": P(None)}
    if not config.tie_embeddings:
        specs["lm_head"] = P("mp", None)
    return specs


def _mp_dims(config: LlamaConfig):
    """The dims the Megatron layout splits over mp (GQA: the kv heads as
    the query heads)."""
    return (("num_heads", config.num_heads), ("kv heads", config.kv_heads),
            ("the MLP width", config.intermediate_size))


def _block(x: torch.Tensor, blk: Dict[str, torch.Tensor],
           config: LlamaConfig, mesh=None) -> torch.Tensor:
    """One decoder block. x: ``[B, S, H]``; blk: one layer's slice of
    ``params["blocks"]`` (with a mesh, this rank's shards: its query and
    kv heads' columns of q/k/v, its columns of gate/up, the matching rows
    of o and down)."""
    c = config
    group = mp_group(mesh)
    b, s, _ = x.shape
    d = c.head_dim
    nh, nkv = blk["q_w"].shape[-1] // d, blk["k_w"].shape[-1] // d

    y = tp_enter(_rms(x, blk["ln1_g"], c.rms_norm_eps), group, False)
    q = (y @ blk["q_w"]).reshape(b, s, nh, d)
    k = (y @ blk["k_w"]).reshape(b, s, nkv, d)
    v = (y @ blk["v_w"]).reshape(b, s, nkv, d)
    q = _rope(q, c.rope_theta)
    k = _rope(k, c.rope_theta)
    if nkv != nh:  # GQA: each kv head serves rep consecutive query heads
        rep = nh // nkv
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    logits = (qt @ kt.transpose(-1, -2)) / math.sqrt(d)
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=x.device))
    logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits.float(), -1).to(x.dtype)
    attn = (probs @ vt).transpose(1, 2).reshape(b, s, nh * d)
    x = x + tp_leave(attn @ blk["o_w"], group, False)

    y = tp_enter(_rms(x, blk["ln2_g"], c.rms_norm_eps), group, False)
    gate = y @ blk["gate_w"]
    up = y @ blk["up_w"]
    act = torch.nn.functional.silu(gate) * up          # SwiGLU
    return x + tp_leave(act @ blk["down_w"], group, False)


def llama_forward(params, tokens, config: LlamaConfig, remat: bool = True,
                  *, mesh=None, pp_trunk=None,
                  return_hidden: bool = False) -> torch.Tensor:
    """tokens ``[B, S]`` int -> logits ``[B, S, V]`` in the param type (the
    final hidden states with ``return_hidden``). With a ``mesh``, params
    are this rank's shards and tokens its rows; ``pp_trunk`` runs the
    blocks as the pipeline over pp."""
    x = embed_tokens(params["wte"], tokens, config.vocab_size, mesh)
    x = x.to(config.torch_dtype)
    if pp_trunk is not None:
        x = pp_trunk(params["blocks"], x)
    else:
        blocks = params["blocks"]
        # one unbind per stacked leaf: its backward stacks the layers'
        # gradients once, where indexing would add a full-size zero-padded
        # gradient per layer
        layers = zip(*(blocks[k].unbind(0) for k in BLOCK_KEYS))
        for leaves in layers:
            blk = dict(zip(BLOCK_KEYS, leaves))
            if remat:
                x = checkpoint(_block, x, blk, config, mesh,
                               use_reentrant=False)
            else:
                x = _block(x, blk, config, mesh)
    x = _rms(x, params["lnf_g"], config.rms_norm_eps)
    if return_hidden:
        return x
    head = params["wte"] if config.tie_embeddings else params["lm_head"]
    return head_logits(x, head, config.vocab_size, mesh)


def llama_loss(params, tokens, labels, config: LlamaConfig,
               remat: bool = True, *, mesh=None,
               pp_trunk=None) -> torch.Tensor:
    """Mean LM loss: logits cast to fp32, log-softmax, mean negative
    log-likelihood of ``labels``; on a mesh with mp > 1 (and a vocabulary
    it divides), the vocab-parallel head."""
    kw = dict(mesh=mesh, pp_trunk=pp_trunk)
    mp = axis_size(mesh, "mp")
    if mp > 1 and config.vocab_size % mp == 0:
        hidden = llama_forward(params, tokens, config, remat,
                               return_hidden=True, **kw)
        head = params["wte"] if config.tie_embeddings \
            else params["lm_head"]
        return vocab_parallel_softmax_cross_entropy(
            hidden, head, labels, mesh, axis="mp").mean()
    logits = llama_forward(params, tokens, config, remat, **kw).float()
    logp = torch.log_softmax(logits, -1)
    picked = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return -picked.mean()


def build_train_step(config: LlamaConfig, mesh=None, lr: float = 3e-4,
                     remat: bool = True,
                     pp_microbatches: Optional[int] = None,
                     device: DeviceLike = None, **adamw):
    """``(init_fn, step_fn)`` for LLaMA training: forward, backward (remat
    per block) and the AdamW update of ``models/trainer.py`` (``adamw``:
    wd, b1, b2, eps, zero1). ``step_fn(state, tokens, labels)`` returns
    ``(state, loss)`` and updates ``state`` in place. With a ``mesh``, as
    GPT's: each rank holds its shards, mp runs the Megatron layout (the
    kv heads must divide by mp, as the query heads), and pp above 1 runs
    the blocks as the pipeline over ``pp_microbatches`` micro-batches
    (default 2 pp)."""
    from .trainer import build_adamw_train_step

    pp = axis_size(mesh, "pp")
    if pp > 1 and config.num_layers % pp:
        raise ValueError("num_layers not divisible by pp degree")
    check_mp(mesh, _mp_dims(config))
    dev = resolve_device(device)
    init = functools.partial(init_llama_params, config, device=dev)
    pp_trunk = None
    if pp > 1:
        pp_trunk = pipelined_trunk(
            functools.partial(_block, config=config, mesh=mesh), mesh,
            pp_microbatches or 2 * pp, axis_name="pp", remat=remat)

    def loss_fn(params, tokens, labels):
        return share_of_mean(llama_loss(
            params, tokens, labels, config, remat=remat, mesh=mesh,
            pp_trunk=pp_trunk), mesh)

    return build_adamw_train_step(
        loss_fn, init, wd_mask(config), lr=lr, device=dev,
        specs=param_specs(config, pp="pp" if pp > 1 else None), mesh=mesh,
        **adamw)
