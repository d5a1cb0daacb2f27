"""BERT / ERNIE encoder trainer path in PyTorch.

Counterpart of the single-device half of ``paddle_tpu/models/bert.py``: a
post-norm encoder (BERT's convention) with word, position and token-type
embeddings, tanh GELU and a masked-LM head tied to the word embedding,
with the reference's parameter tree (per-block arrays stacked
``[L, ...]``, so a tree moves between the two packages leaf for leaf
through ``models/convert.py``) and the trainer of ``models/trainer.py``.
ERNIE-3.0-base is this encoder at a vocabulary of 40000.

Like the reference, this model runs no kernel of its own. Attention is
dense: logits in the working type divided by ``sqrt(head_dim)``, softmax
in fp32, probabilities cast back before ``probs @ v``. A padding
``attention_mask`` becomes an fp32 additive mask (``(1 - m) * -1e30``),
and adding it promotes the logits to fp32 before the softmax; without a
mask they stay in the working type. The embeddings are summed in the
param type, ``(wte[t] + wpe[:s]) + wtype[ids]`` (``wtype[0]`` when no
token types are given). ``_ln`` rounds the normalised value to the
working type before ``* g + b``, as the reference's does.

Differences in form, not in function: a Python loop over layers (the
stacked leaves unbound once) instead of the reference's ``lax.scan``, each
block wrapped in ``torch.utils.checkpoint`` when ``remat`` is set. On a
mesh, where the reference lets GSPMD place its collectives, each rank
runs shard-local code with explicit ones (``distributed/fleet/mp_ops.py``):
the Megatron layout over mp, the vocab-parallel embedding and head (where
the reference's GSPMD runs the dense head on the split weight).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .._core.device import DeviceLike, resolve_device
from ..distributed import _collectives as C
from ..distributed.fleet.mp_ops import (
    embed_tokens, head_logits, mp_group, tp_enter, tp_leave,
    vocab_parallel_softmax_cross_entropy)
from ..distributed.mesh import PartitionSpec as P
from .trainer import axis_size, build_adamw_train_step, check_mp


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    dtype: str = "bfloat16"

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


# the reference's model table
BERT_CONFIGS = {
    "bert-tiny": BertConfig(vocab_size=1024, hidden_size=128,
                            num_layers=2, num_heads=2,
                            intermediate_size=512,
                            max_position_embeddings=128),
    "bert-base": BertConfig(),
    "ernie-3.0-base": BertConfig(vocab_size=40000),
    "bert-large": BertConfig(hidden_size=1024, num_layers=24,
                             num_heads=16, intermediate_size=4096),
}

BLOCK_KEYS = ("qkv_w", "qkv_b", "proj_w", "proj_b", "ln1_g", "ln1_b",
              "fc_w", "fc_b", "fo_w", "fo_b", "ln2_g", "ln2_b")


def init_bert_params(config: BertConfig, seed: int = 0,
                     device: DeviceLike = None) -> Dict[str, Any]:
    """Random parameters in the reference's layout and types, drawn from a
    ``torch.Generator`` seeded with ``seed``: the same distributions as the
    reference's ``jax.random`` draw, not the same numbers."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = config
    h, f, L = c.hidden_size, c.intermediate_size, c.num_layers
    dt = c.torch_dtype
    std = c.initializer_range

    def norm(shape, scale=std):
        return (torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32) * scale).to(dt)

    def ones(*shape):
        return torch.ones(shape, device=dev, dtype=dt)

    def zeros(*shape):
        return torch.zeros(shape, device=dev, dtype=dt)

    return {
        "wte": norm((c.vocab_size, h)),
        "wpe": norm((c.max_position_embeddings, h)),
        "wtype": norm((c.type_vocab_size, h)),
        "emb_ln_g": ones(h), "emb_ln_b": zeros(h),
        "blocks": {
            "qkv_w": norm((L, h, 3 * h)),
            "qkv_b": zeros(L, 3 * h),
            "proj_w": norm((L, h, h), scale=std / math.sqrt(2 * L)),
            "proj_b": zeros(L, h),
            "ln1_g": ones(L, h), "ln1_b": zeros(L, h),
            "fc_w": norm((L, h, f)), "fc_b": zeros(L, f),
            "fo_w": norm((L, f, h), scale=std / math.sqrt(2 * L)),
            "fo_b": zeros(L, h),
            "ln2_g": ones(L, h), "ln2_b": zeros(L, h),
        },
        "mlm_w": norm((h, h)), "mlm_b": zeros(h),
        "mlm_ln_g": ones(h), "mlm_ln_b": zeros(h),
    }


def wd_mask(config: BertConfig) -> Dict[str, Any]:
    """Decay the embeddings, the block matrices and the MLM transform; no
    bias or norm parameter."""
    dec = {"qkv_w", "proj_w", "fc_w", "fo_w"}
    return {
        "wte": True, "wpe": True, "wtype": True,
        "emb_ln_g": False, "emb_ln_b": False,
        "blocks": {k: (k in dec) for k in BLOCK_KEYS},
        "mlm_w": True, "mlm_b": False,
        "mlm_ln_g": False, "mlm_ln_b": False,
    }


def _ln(x, g, b, eps):
    """LayerNorm with fp32 statistics; the normalised value is cast back to
    x's type before ``* g + b``, as in the reference."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * g + b


def param_specs(config: BertConfig) -> Dict[str, Any]:
    """The reference's Megatron TP layout: qkv and fc column-split over mp,
    proj and fo row-split, the word embedding vocab-split."""
    blocks = {
        "qkv_w": P(None, None, "mp"), "qkv_b": P(None, "mp"),
        "proj_w": P(None, "mp", None), "proj_b": P(None, None),
        "ln1_g": P(None, None), "ln1_b": P(None, None),
        "fc_w": P(None, None, "mp"), "fc_b": P(None, "mp"),
        "fo_w": P(None, "mp", None), "fo_b": P(None, None),
        "ln2_g": P(None, None), "ln2_b": P(None, None),
    }
    return {
        "wte": P("mp", None), "wpe": P(None, None), "wtype": P(None, None),
        "emb_ln_g": P(None), "emb_ln_b": P(None),
        "blocks": blocks,
        "mlm_w": P(None, None), "mlm_b": P(None),
        "mlm_ln_g": P(None), "mlm_ln_b": P(None),
    }


# the fused qkv weight's last dim is [q | k | v]: an mp shard takes its
# heads' columns of each of the three (convert.shard_index)
SPLIT_GROUPS = {"blocks": {"qkv_w": 3, "qkv_b": 3}}


def _block(x, blk: Dict[str, torch.Tensor], config: BertConfig,
           attn_mask=None, mesh=None):
    """One post-norm encoder block. x ``[B, S, H]``; blk: one layer's
    slice of ``params["blocks"]`` (with a mesh, this rank's shards: its
    heads' columns of qkv and fc, their rows of proj and fo); attn_mask
    ``[B, 1, 1, S]`` fp32 additive, or None."""
    c = config
    group = mp_group(mesh)
    b, s, _ = x.shape
    nh = blk["qkv_w"].shape[-1] // (3 * c.head_dim)  # this rank's heads
    qkv = tp_enter(x, group, False) @ blk["qkv_w"] + blk["qkv_b"]
    qkv = qkv.reshape(b, s, 3, nh, c.head_dim)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # B,H,S,D
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(c.head_dim)
    if attn_mask is not None:
        logits = logits + attn_mask          # promotes to fp32
    probs = torch.softmax(logits.float(), -1).to(x.dtype)
    attn = torch.einsum("bhqk,bhkd->bhqd", probs, v)
    attn = attn.transpose(1, 2).reshape(b, s, nh * c.head_dim)
    attn = tp_leave(attn @ blk["proj_w"], group, False) + blk["proj_b"]
    x = _ln(x + attn, blk["ln1_g"], blk["ln1_b"], c.layer_norm_eps)
    y = tp_enter(x, group, False) @ blk["fc_w"] + blk["fc_b"]
    y = F.gelu(y, approximate="tanh")
    y = tp_leave(y @ blk["fo_w"], group, False) + blk["fo_b"]
    return _ln(x + y, blk["ln2_g"], blk["ln2_b"], c.layer_norm_eps)


def bert_encode(params, tokens, token_type_ids=None, attention_mask=None,
                config: BertConfig = None, remat: bool = True, *,
                mesh=None):
    """tokens ``[B, S]`` int -> hidden states ``[B, S, H]``;
    ``attention_mask`` ``[B, S]`` (1 keep, 0 pad) or None. With a
    ``mesh``, params are this rank's shards and tokens its rows."""
    s = tokens.shape[1]
    c = config
    x = embed_tokens(params["wte"], tokens, c.vocab_size, mesh) \
        + params["wpe"][:s]
    if token_type_ids is not None:
        x = x + params["wtype"][token_type_ids]
    else:
        x = x + params["wtype"][0]
    x = _ln(x.to(c.torch_dtype), params["emb_ln_g"], params["emb_ln_b"],
            c.layer_norm_eps)
    add_mask = None
    if attention_mask is not None:
        add_mask = (1.0 - attention_mask[:, None, None, :].float()) * -1e30
    blocks = params["blocks"]
    # one unbind per stacked leaf: its backward stacks the layers'
    # gradients once, where indexing would add a full-size zero-padded
    # gradient per layer
    for leaves in zip(*(blocks[k].unbind(0) for k in BLOCK_KEYS)):
        blk = dict(zip(BLOCK_KEYS, leaves))
        if remat:
            x = checkpoint(_block, x, blk, c, add_mask, mesh,
                           use_reentrant=False)
        else:
            x = _block(x, blk, c, add_mask, mesh)
    return x


def _mlm_hidden(params, tokens, config, remat, attention_mask, mesh):
    x = bert_encode(params, tokens, None, attention_mask, config, remat,
                    mesh=mesh)
    x = x @ params["mlm_w"] + params["mlm_b"]
    x = F.gelu(x, approximate="tanh")
    return _ln(x, params["mlm_ln_g"], params["mlm_ln_b"],
               config.layer_norm_eps)


def bert_mlm_logits(params, tokens, config: BertConfig, remat: bool = True,
                    attention_mask=None, *, mesh=None):
    """MLM logits ``[B, S, V]`` in the working type: the transform (dense,
    tanh GELU, LayerNorm) and the head tied to ``wte``."""
    x = _mlm_hidden(params, tokens, config, remat, attention_mask, mesh)
    return head_logits(x, params["wte"], config.vocab_size, mesh)


def bert_mlm_loss(params, tokens, labels, config: BertConfig,
                  remat: bool = True, *, mesh=None):
    """Mean masked-LM loss over the positions whose label is >= 0 (the
    others, -100 by convention, are ignored), divided by ``max(count, 1)``:
    logits cast to fp32, log-softmax, negative log-likelihood. On a mesh:
    this rank's share, its rows' sum over the count of all dp ranks' rows,
    and the vocab-parallel head at mp > 1 (a vocabulary it divides)."""
    safe = torch.clamp(labels.long(), min=0)
    mask = (labels >= 0).float()
    mp = axis_size(mesh, "mp")
    if mp > 1 and config.vocab_size % mp == 0:
        x = _mlm_hidden(params, tokens, config, remat, None, mesh)
        picked = -vocab_parallel_softmax_cross_entropy(
            x, params["wte"], safe, mesh, axis="mp")
    else:
        logits = bert_mlm_logits(params, tokens, config, remat, mesh=mesh)
        logp = torch.log_softmax(logits.float(), -1)
        picked = torch.gather(logp, -1, safe[..., None])[..., 0]
    count = mask.sum()
    if mesh is not None and "dp" in mesh.dim_names:
        count = C.all_reduce(count, mesh.get_group("dp"))
    return -(picked * mask).sum() / torch.clamp(count, min=1.0)


def build_train_step(config: BertConfig, mesh=None, lr: float = 1e-4,
                     remat: bool = True, device: DeviceLike = None,
                     **adamw):
    """``(init_fn, step_fn)`` for masked-LM training: forward, backward
    (remat per block) and the AdamW update of ``models/trainer.py``
    (``adamw``: wd, b1, b2, eps, zero1; the trainer's defaults are the
    reference's). ``step_fn(state, tokens, labels)`` returns ``(state,
    loss)`` and updates ``state`` in place. With a ``mesh`` (axes ``dp``
    and ``mp``), as GPT's: each rank holds its shards and mp runs the
    Megatron layout."""
    check_mp(mesh, (("num_heads", config.num_heads),
                    ("the MLP width", config.intermediate_size)))
    dev = resolve_device(device)

    def loss_fn(params, tokens, labels):
        return bert_mlm_loss(params, tokens, labels, config, remat=remat,
                             mesh=mesh)

    return build_adamw_train_step(
        loss_fn, functools.partial(init_bert_params, config, device=dev),
        wd_mask(config), lr=lr, device=dev, mesh=mesh,
        specs=param_specs(config),
        split_groups=SPLIT_GROUPS, **adamw)
