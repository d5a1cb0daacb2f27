"""GPT compiled-trainer path in PyTorch.

Counterpart of the functional half of ``paddle_tpu/models/gpt.py``
(``init_gpt_params`` → ``_block`` → ``gpt_forward`` → ``gpt_loss`` →
``build_train_step``). Parameters are a nested dict with the reference's
key names and its stacked ``[L, ...]`` per-block layout, so a parameter
tree moves between the two packages leaf for leaf (``models/convert.py``).

Differences in form, not in function:

- the reference scans over the stacked layer axis inside one XLA program;
  here ``gpt_forward`` is a Python loop over layers, each block wrapped in
  ``torch.utils.checkpoint`` when ``remat`` is set (the reference's
  ``jax.checkpoint`` per block);
- attention goes through the port's flash-attention kernels
  (``ops/cuda/flash_attention.py``) when the config asks for it and the
  sequence tiles by 128, else through the dense masked softmax.

There is no mesh, pipeline, sequence-parallel or vocab-parallel code here.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .._core.device import DeviceLike, resolve_device
from ..ops.cuda.flash_attention import mha_forward


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: Optional[int] = None
    max_position_embeddings: int = 1024
    layer_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    use_flash_attention: bool = True
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


def _block(x, blk: Dict[str, torch.Tensor], config: GPTConfig):
    """One decoder block. x: ``[B, S, H]``; blk: one layer's slice of
    ``params["blocks"]``."""
    c = config
    b, s, h = x.shape
    y = _ln(x, blk["ln1_g"], blk["ln1_b"], c.layer_norm_eps)
    qkv = y @ blk["qkv_w"] + blk["qkv_b"]
    qkv = qkv.reshape(b, s, 3, c.num_heads, c.head_dim)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # B,H,S,D
    scale = 1.0 / math.sqrt(c.head_dim)
    if _use_flash_kernel(c, s):
        attn = mha_forward(q, k, v, causal=True, scale=scale)
    else:
        logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                     device=x.device))
        logits = logits.masked_fill(~mask, -1e30)
        probs = torch.softmax(logits.float(), -1).to(x.dtype)
        attn = torch.einsum("bhqk,bhkd->bhqd", probs, v)
    attn = attn.transpose(1, 2).reshape(b, s, h)
    x = x + (attn @ blk["proj_w"] + blk["proj_b"])
    y = _ln(x, blk["ln2_g"], blk["ln2_b"], c.layer_norm_eps)
    y = y @ blk["fc_w"] + blk["fc_b"]
    y = F.gelu(y, approximate="tanh")
    y = y @ blk["fo_w"] + blk["fo_b"]
    return x + y


def gpt_forward(params, tokens, config: GPTConfig, remat: bool = True):
    """tokens ``[B, S]`` int → logits ``[B, S, V]`` in the param type."""
    s = tokens.shape[1]
    x = params["wte"][tokens] + params["wpe"][:s]
    x = x.to(config.torch_dtype)
    blocks = params["blocks"]
    for i in range(config.num_layers):
        blk = {k: t[i] for k, t in blocks.items()}
        if remat:
            x = checkpoint(_block, x, blk, config, use_reentrant=False)
        else:
            x = _block(x, blk, config)
    x = _ln(x, params["lnf_g"], params["lnf_b"], config.layer_norm_eps)
    return x @ params["wte"].t()


def gpt_loss(params, tokens, labels, config: GPTConfig, remat: bool = True):
    """Mean LM loss: tied ``wte`` head, logits cast to fp32, log-softmax,
    mean negative log-likelihood of ``labels``."""
    logits = gpt_forward(params, tokens, config, remat).float()
    logp = torch.log_softmax(logits, -1)
    picked = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return -picked.mean()


def build_train_step(config: GPTConfig, lr: float = 3e-4, wd: float = 0.1,
                     b1: float = 0.9, b2: float = 0.95, remat: bool = True,
                     device: DeviceLike = None):
    """``(init_fn, step_fn)`` for single-device GPT training: forward,
    backward (remat per block) and the AdamW update of
    ``models/trainer.py``. ``step_fn(state, tokens, labels)`` returns
    ``(state, loss)`` and updates ``state`` in place."""
    from .trainer import build_adamw_train_step

    dev = resolve_device(device)

    def loss_fn(params, tokens, labels):
        return gpt_loss(params, tokens, labels, config, remat=remat)

    return build_adamw_train_step(
        loss_fn, functools.partial(init_gpt_params, config, device=dev),
        WD_MASK, lr=lr, wd=wd, b1=b1, b2=b2, device=dev)
