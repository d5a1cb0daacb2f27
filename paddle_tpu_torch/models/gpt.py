"""GPT in PyTorch: the eager Layer path and the compiled-trainer path.

Counterpart of ``paddle_tpu/models/gpt.py``, both halves:

1. the eager Layer path (``GPTEmbeddings``, ``GPTDecoderLayer``,
   ``GPTModel``, ``GPTForPretraining``, ``GPTPretrainingCriterion``), built
   from the port's ``nn`` layers and its degree-1 tensor-parallel layers,
   with the reference's parameter names: the reference's ``state_dict``, as
   numpy arrays, loads into it with ``set_state_dict``. As in the
   reference, attention always calls ``F.flash_attention`` (the config's
   ``use_flash_attention`` is not read on this path), which reaches the
   port's kernels through ``ops/cuda/flash_attention.py`` ``mha_forward``;
2. the functional trainer (``init_gpt_params`` → ``_block`` →
   ``gpt_forward`` → ``gpt_loss`` → ``build_train_step``). Parameters are a nested dict with the reference's
key names and its stacked ``[L, ...]`` per-block layout, so a parameter
tree moves between the two packages leaf for leaf (``models/convert.py``).

Differences in form, not in function:

- the reference scans over the stacked layer axis inside one XLA program;
  here ``gpt_forward`` is a Python loop over layers, each block wrapped in
  ``torch.utils.checkpoint`` when ``remat`` is set (the reference's
  ``jax.checkpoint`` per block);
- attention goes through the port's flash-attention kernels
  (``ops/cuda/flash_attention.py``) when the config asks for it and the
  sequence tiles by 128, else through the dense masked softmax;
- on a mesh, where the reference lets GSPMD place its collectives, each
  rank runs shard-local code with explicit ones over
  ``torch.distributed`` (``distributed/fleet/mp_ops.py``): the Megatron
  layout over mp (qkv and fc split by heads, proj and fo by rows, their
  partial sums completed), Megatron-SP's sequence split of the residual
  stream, the vocab-parallel embedding and head, the flash kernels on each
  rank's heads (``mha_spmd``), and the pipeline over pp
  (``distributed/pipeline_compiled.py``).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import nn
from .._core.device import DeviceLike, resolve_device
from ..distributed.fleet.mp_layers import (ColumnParallelLinear,
                                           RowParallelLinear,
                                           VocabParallelEmbedding)
from ..distributed import _collectives as C
from ..distributed.fleet.mp_ops import (
    embed_tokens, head_logits, mp_group, tp_enter, tp_leave,
    vocab_parallel_softmax_cross_entropy)
from ..distributed.mesh import PartitionSpec as P
from ..distributed.pipeline_compiled import pipelined_trunk
from ..nn import functional as PF
from ..ops.creation import arange
from ..ops.cuda.flash_attention import mha_forward
from ..ops.linalg import matmul
from ..ops.reduction import mean as pmean, sum as psum
from .trainer import axis_size, check_mp, share_of_mean, tree_map


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: Optional[int] = None
    max_position_embeddings: int = 1024
    hidden_dropout_prob: float = 0.0
    attention_dropout_prob: float = 0.0
    layer_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    use_flash_attention: bool = True
    use_recompute: bool = False
    dtype: str = "bfloat16"

    @property
    def ffn(self):
        return self.intermediate_size or 4 * self.hidden_size

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


# the reference's model table
GPT_CONFIGS = {
    "gpt2-small": GPTConfig(hidden_size=768, num_layers=12, num_heads=12),
    "gpt2-medium": GPTConfig(hidden_size=1024, num_layers=24, num_heads=16),
    "gpt3-1.3b": GPTConfig(hidden_size=2048, num_layers=24, num_heads=32,
                           max_position_embeddings=2048),
    "gpt3-6.7b": GPTConfig(hidden_size=4096, num_layers=32, num_heads=32,
                           max_position_embeddings=2048),
}

BLOCK_KEYS = ("ln1_g", "ln1_b", "qkv_w", "qkv_b", "proj_w", "proj_b",
              "ln2_g", "ln2_b", "fc_w", "fc_b", "fo_w", "fo_b")


# =====================================================================
# Eager Layer path
# =====================================================================

class GPTEmbeddings(nn.Layer):
    def __init__(self, config: GPTConfig):
        super().__init__()
        self.word_embeddings = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size)
        self.position_embeddings = nn.Embedding(
            config.max_position_embeddings, config.hidden_size)
        self.dropout = nn.Dropout(config.hidden_dropout_prob)

    def forward(self, input_ids, position_ids=None):
        if position_ids is None:
            position_ids = arange(input_ids.shape[1], dtype="int64")
        h = self.word_embeddings(input_ids) \
            + self.position_embeddings(position_ids)
        return self.dropout(h)


class GPTDecoderLayer(nn.Layer):
    def __init__(self, config: GPTConfig):
        super().__init__()
        h = config.hidden_size
        self.ln_1 = nn.LayerNorm(h, config.layer_norm_eps)
        self.qkv_proj = ColumnParallelLinear(h, 3 * h, gather_output=False)
        self.out_proj = RowParallelLinear(h, h)
        self.ln_2 = nn.LayerNorm(h, config.layer_norm_eps)
        self.mlp_in = ColumnParallelLinear(h, config.ffn,
                                           gather_output=False)
        self.mlp_out = RowParallelLinear(config.ffn, h)
        self.config = config
        self.attn_dropout = nn.Dropout(config.attention_dropout_prob)
        self.dropout = nn.Dropout(config.hidden_dropout_prob)

    def forward(self, x, attn_mask=None):
        c = self.config
        residual = x
        y = self.ln_1(x)
        qkv = self.qkv_proj(y)
        b, s = qkv.shape[0], qkv.shape[1]
        qkv = qkv.reshape([b, s, 3, c.num_heads, c.head_dim])
        q, k, v = qkv.unbind(axis=2)
        attn, _ = PF.flash_attention(q, k, v,
                                     dropout=c.attention_dropout_prob,
                                     causal=True, training=self.training)
        attn = attn.reshape([b, s, c.hidden_size])
        x = residual + self.dropout(self.out_proj(attn))
        residual = x
        y = self.ln_2(x)
        y = self.mlp_out(PF.gelu(self.mlp_in(y), approximate=True))
        return residual + self.dropout(y)


class GPTModel(nn.Layer):
    def __init__(self, config: GPTConfig):
        super().__init__()
        self.config = config
        self.embeddings = GPTEmbeddings(config)
        self.layers = nn.LayerList(
            [GPTDecoderLayer(config) for _ in range(config.num_layers)])
        self.ln_f = nn.LayerNorm(config.hidden_size, config.layer_norm_eps)

    def forward(self, input_ids, position_ids=None, attention_mask=None):
        x = self.embeddings(input_ids, position_ids)
        for layer in self.layers:
            if self.config.use_recompute and self.training:
                from ..distributed.fleet.recompute import recompute
                x = recompute(layer, x)
            else:
                x = layer(x)
        return self.ln_f(x)


class GPTForPretraining(nn.Layer):
    def __init__(self, config: GPTConfig):
        super().__init__()
        self.gpt = GPTModel(config)

    def forward(self, input_ids, position_ids=None):
        h = self.gpt(input_ids, position_ids)
        # tied head: logits = h @ W_emb^T
        w = self.gpt.embeddings.word_embeddings.weight
        return matmul(h, w, transpose_y=True)


class GPTPretrainingCriterion(nn.Layer):
    def forward(self, logits, labels, loss_mask=None):
        loss = PF.cross_entropy(logits, labels, reduction="none")
        if loss_mask is not None:
            flat = loss_mask.reshape(loss.shape)
            return psum(loss * flat) / psum(flat)
        return pmean(loss)


# =====================================================================
# Compiled functional trainer
# =====================================================================

def init_gpt_params(config: GPTConfig, seed: int = 0,
                    device: DeviceLike = None) -> Dict[str, Any]:
    """Random parameters in the reference's layout, per-block arrays
    stacked on a leading layer axis ``[L, ...]``. Drawn from a
    ``torch.Generator`` seeded with ``seed``: the same distribution as the
    reference's ``jax.random`` draw, not the same numbers."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    h, f_, L = config.hidden_size, config.ffn, config.num_layers
    v, s_max = config.vocab_size, config.max_position_embeddings
    std = config.initializer_range
    dt = config.torch_dtype

    def norm(shape, scale=std):
        return (torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32) * scale).to(dt)

    def ones(*shape):
        return torch.ones(shape, device=dev, dtype=dt)

    def zeros(*shape):
        return torch.zeros(shape, device=dev, dtype=dt)

    return {
        "wte": norm((v, h)),
        "wpe": norm((s_max, h)),
        "blocks": {
            "ln1_g": ones(L, h), "ln1_b": zeros(L, h),
            "qkv_w": norm((L, h, 3 * h)),
            "qkv_b": zeros(L, 3 * h),
            "proj_w": norm((L, h, h), scale=std / math.sqrt(2 * L)),
            "proj_b": zeros(L, h),
            "ln2_g": ones(L, h), "ln2_b": zeros(L, h),
            "fc_w": norm((L, h, f_)),
            "fc_b": zeros(L, f_),
            "fo_w": norm((L, f_, h), scale=std / math.sqrt(2 * L)),
            "fo_b": zeros(L, h),
        },
        "lnf_g": ones(h),
        "lnf_b": zeros(h),
    }


# decay only matrix weights and embeddings; LayerNorm gains/biases and bias
# vectors are excluded (the reference's Megatron convention)
_DECAY_KEYS = {"wte", "wpe", "qkv_w", "proj_w", "fc_w", "fo_w"}
WD_MASK = {
    "wte": True, "wpe": True,
    "blocks": {k: (k in _DECAY_KEYS) for k in BLOCK_KEYS},
    "lnf_g": False, "lnf_b": False,
}
# the fused qkv weight's last dim is [q | k | v]: an mp shard takes its
# heads' columns of each of the three (convert.shard_index)
SPLIT_GROUPS = {"blocks": {"qkv_w": 3, "qkv_b": 3}}
# the block leaves applied to the sequence-split residual stream under
# Megatron-SP: each mp rank's gradient covers its rows only
SP_LEAVES = ("ln1_g", "ln1_b", "proj_b", "ln2_g", "ln2_b", "fo_b")


def param_specs(config: GPTConfig, dp: str = "dp", mp: str = "mp",
                zero_axis: Optional[str] = None,
                pp: Optional[str] = None) -> Dict[str, Any]:
    """The reference's PartitionSpecs per param (Megatron TP layout): qkv
    and fc column-split over mp, proj and fo row-split, wte vocab-split;
    ``pp``, when set, splits the stacked layer dim of the blocks.
    (``dp`` and ``zero_axis`` are accepted and unused, as in the
    reference.)"""
    blocks = {
        "ln1_g": P(pp, None), "ln1_b": P(pp, None),
        "qkv_w": P(pp, None, mp), "qkv_b": P(pp, mp),
        "proj_w": P(pp, mp, None), "proj_b": P(pp, None),
        "ln2_g": P(pp, None), "ln2_b": P(pp, None),
        "fc_w": P(pp, None, mp), "fc_b": P(pp, mp),
        "fo_w": P(pp, mp, None), "fo_b": P(pp, None),
    }
    return {
        "wte": P(mp, None),
        "wpe": P(None, None),
        "blocks": blocks,
        "lnf_g": P(None), "lnf_b": P(None),
    }


def _mp_dims(config: GPTConfig):
    """The dims the Megatron layout splits over mp."""
    return (("num_heads", config.num_heads), ("the MLP width", config.ffn))


def _use_flash_kernel(config: GPTConfig, seq: int) -> bool:
    """The reference's ``_use_flash_kernel`` without its TPU and interpret
    branches: the port always has its kernel (or, on the CPU, its plain
    version)."""
    return config.use_flash_attention and seq % 128 == 0


def _ln(x, g, b, eps):
    """LayerNorm with fp32 statistics; the normalised value is cast back to
    the input type before ``* g + b``, as in the reference."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * g + b


def _block(x, blk: Dict[str, torch.Tensor], config: GPTConfig, mesh=None,
           sp: bool = False, flash: Optional[bool] = None):
    """One decoder block. x: ``[B, S, H]`` (under ``sp``, this mp rank's
    ``[B, S/mp, H]``); blk: one layer's slice of ``params["blocks"]``
    (with a mesh, this rank's shards: its heads' columns of qkv and fc,
    their rows of proj and fo). ``flash`` None: the kernels where
    :func:`_use_flash_kernel` says so."""
    c = config
    group = mp_group(mesh)
    b = x.shape[0]
    y = _ln(x, blk["ln1_g"], blk["ln1_b"], c.layer_norm_eps)
    y = tp_enter(y, group, sp)
    s = y.shape[1]
    nh = blk["qkv_w"].shape[-1] // (3 * c.head_dim)  # this rank's heads
    qkv = y @ blk["qkv_w"] + blk["qkv_b"]
    qkv = qkv.reshape(b, s, 3, nh, c.head_dim)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # B,H,S,D
    scale = 1.0 / math.sqrt(c.head_dim)
    if _use_flash_kernel(c, s) if flash is None else flash:
        # on a mesh, the kernels on this rank's heads (the reference's
        # mha_spmd)
        attn = mha_forward(q, k, v, causal=True, scale=scale)
    else:
        logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                     device=x.device))
        logits = logits.masked_fill(~mask, -1e30)
        probs = torch.softmax(logits.float(), -1).to(x.dtype)
        attn = torch.einsum("bhqk,bhkd->bhqd", probs, v)
    attn = attn.transpose(1, 2).reshape(b, s, nh * c.head_dim)
    x = x + (tp_leave(attn @ blk["proj_w"], group, sp) + blk["proj_b"])
    y = _ln(x, blk["ln2_g"], blk["ln2_b"], c.layer_norm_eps)
    y = tp_enter(y, group, sp)
    y = y @ blk["fc_w"] + blk["fc_b"]
    y = F.gelu(y, approximate="tanh")
    y = tp_leave(y @ blk["fo_w"], group, sp) + blk["fo_b"]
    return x + y


def gpt_forward(params, tokens, config: GPTConfig, remat: bool = True, *,
                mesh=None, sp: bool = False, pp_trunk=None,
                return_hidden: bool = False):
    """tokens ``[B, S]`` int → logits ``[B, S, V]`` in the param type (the
    final hidden states ``[B, S, H]`` with ``return_hidden``).

    With a ``mesh``, ``params`` are this rank's shards and ``tokens`` its
    rows; ``sp`` splits the residual stream's sequence over mp between the
    blocks (Megatron-SP); ``pp_trunk`` (:func:`distributed.pipelined_trunk`)
    runs the blocks as the pipeline over pp."""
    s = tokens.shape[1]
    x = embed_tokens(params["wte"], tokens, config.vocab_size, mesh) \
        + params["wpe"][:s]
    x = x.to(config.torch_dtype)
    if pp_trunk is not None:
        x = pp_trunk(params["blocks"], x)
    else:
        group = mp_group(mesh) if sp else None
        if group is not None:
            x = C.split(x, 1, group)
        flash = _use_flash_kernel(config, s)
        blocks = params["blocks"]
        for i in range(config.num_layers):
            blk = {k: t[i] for k, t in blocks.items()}
            if remat:
                x = checkpoint(_block, x, blk, config, mesh, group is not None,
                               flash, use_reentrant=False)
            else:
                x = _block(x, blk, config, mesh, group is not None, flash)
        if group is not None:
            x = C.gather(x, 1, group)
    x = _ln(x, params["lnf_g"], params["lnf_b"], config.layer_norm_eps)
    if return_hidden:
        return x
    return head_logits(x, params["wte"], config.vocab_size, mesh)


def gpt_loss(params, tokens, labels, config: GPTConfig, remat: bool = True,
             *, mesh=None, sp: bool = False, pp_trunk=None):
    """Mean LM loss: tied ``wte`` head, logits cast to fp32, log-softmax,
    mean negative log-likelihood of ``labels``. On a mesh with mp > 1 (and
    a vocabulary it divides) the head is vocab-parallel: each mp rank
    computes its ``[B, S, V/mp]`` logits and the full logits never exist."""
    kw = dict(mesh=mesh, sp=sp, pp_trunk=pp_trunk)
    mp = axis_size(mesh, "mp")
    if mp > 1 and config.vocab_size % mp == 0:
        hidden = gpt_forward(params, tokens, config, remat,
                             return_hidden=True, **kw)
        loss = vocab_parallel_softmax_cross_entropy(
            hidden, params["wte"], labels, mesh, axis="mp")
        return loss.mean()
    logits = gpt_forward(params, tokens, config, remat, **kw).float()
    logp = torch.log_softmax(logits, -1)
    picked = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return -picked.mean()


def build_train_step(config: GPTConfig, mesh=None, lr: float = 3e-4,
                     wd: float = 0.1, b1: float = 0.9, b2: float = 0.95,
                     zero1: bool = True, seq_shard: bool = False,
                     remat: bool = True,
                     pp_microbatches: Optional[int] = None,
                     unroll_layers: bool = False,
                     device: DeviceLike = None):
    """``(init_fn, step_fn)`` for GPT training: forward, backward (remat
    per block) and the AdamW update of ``models/trainer.py``.
    ``step_fn(state, tokens, labels)`` returns ``(state, loss)`` and
    updates ``state`` in place.

    With a ``mesh`` (a ``distributed.ProcessMesh`` with any of the axes
    ``dp``, ``pp``, ``mp``, over ``torch.distributed``'s default group),
    each rank holds its shards (``param_specs``) and its ZeRO-1 share of
    the optimizer state (``zero1``); the step takes the global batch and
    keeps its dp rows. ``mp`` runs the Megatron layout (heads split),
    ``seq_shard`` adds Megatron-SP where the mesh has both ``dp`` and
    ``mp`` and no pipeline, as in the reference; ``pp`` above 1 runs the
    blocks as the pipeline over ``pp_microbatches`` micro-batches of each
    rank's rows (default 2 pp). ``unroll_layers`` (the reference's way
    around an XLA:CPU fault in its layer scan) is accepted and unused: the
    layers always run as a Python loop."""
    from .trainer import build_adamw_train_step

    pp = axis_size(mesh, "pp")
    if pp > 1 and config.num_layers % pp:
        raise ValueError(f"num_layers {config.num_layers} not divisible "
                         f"by pp {pp}")
    check_mp(mesh, _mp_dims(config))
    dev = resolve_device(device)
    pp_trunk = None
    if pp > 1:
        pp_trunk = pipelined_trunk(
            functools.partial(_block, config=config, mesh=mesh), mesh,
            pp_microbatches or 2 * pp, axis_name="pp", remat=remat)
    sp = bool(seq_shard and pp == 1 and mesh is not None
              and {"dp", "mp"} <= set(mesh.dim_names))
    grad_sum = tree_map(lambda _: None, WD_MASK)
    if sp:
        grad_sum["blocks"].update({k: ("mp",) for k in SP_LEAVES})

    def loss_fn(params, tokens, labels):
        return share_of_mean(gpt_loss(
            params, tokens, labels, config, remat=remat, mesh=mesh, sp=sp,
            pp_trunk=pp_trunk), mesh)

    return build_adamw_train_step(
        loss_fn, functools.partial(init_gpt_params, config, device=dev),
        WD_MASK, lr=lr, wd=wd, b1=b1, b2=b2, device=dev,
        specs=param_specs(config, pp="pp" if pp > 1 else None), mesh=mesh,
        zero1=zero1, split_groups=SPLIT_GROUPS, grad_sum=grad_sum)
