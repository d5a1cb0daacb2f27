"""Context parallelism: ring attention and Ulysses (all-to-all) attention,
the counterpart of ``paddle_tpu/distributed/context_parallel.py``.

The long-context axis is ``sep`` (segment parallel: the sequence split
over ranks). Each rank is a process holding its piece of the sequence,
and the reference's ``shard_map`` collectives become explicit ones over
the process group of that axis (``_collectives``):

- ``ring_attention``: blockwise attention with an online softmax; the
  K/V chunks go around the ring (``_collectives.ring_shift``, the
  reference's ``ppermute``), n - 1 shifts, the queries stay. Autograd
  differentiates through the shifts (backward, the reverse shift).
- ``ulysses_attention``: an all-to-all (``_collectives.resplit``) turns the
  sequence split into a head split, each rank runs full-sequence
  attention for H/n heads (``attn_fn``: the port's flash entry
  ``ops.cuda.flash_attention.flash_attention`` fits, ``[B, S, H, D]``),
  and the reverse all-to-all restores the sequence split. Needs
  num_heads % sep == 0.

Both take this rank's pieces ``[B, S_local, H, D]``; ``axis_name`` names
an axis of the current mesh (``mesh.get_mesh()``, else fleet's hybrid
group's mesh), whose group through this rank carries the collectives.
Without a process group the axis has one rank. ``ring_attention_global``
and ``ulysses_attention_global`` take the global ``[B, S, H, D]`` value
(the same on every rank), cut this rank's piece by its ``seq_axis``
coordinate (and its ``batch_axis`` one) and return a DistTensor of this
rank's output piece, ``Shard(1)`` on ``seq_axis`` and ``Shard(0)`` on
``batch_axis`` (``api.py``: a DistTensor holds this rank's piece;
``unshard_dtensor`` gives the global value).

The scores and P·V are fp32 products, as the reference asks
(``preferred_element_type=float32``): their operands are upcast before
the product. On a card TF32 stays off for them
(``torch.backends.cuda.matmul.allow_tf32``, off by default).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.distributed as dist

from .._core.tensor import Tensor
from . import _collectives as C

NEG_INF = -1e30


def _axis_group(axis_name: str, mesh=None):
    """The process group of ``axis_name`` through this rank: of ``mesh``
    when given, else of the current mesh, else of fleet's hybrid group's
    mesh; None where there is no process group or no such axis (one
    rank)."""
    if not dist.is_initialized():
        return None
    if mesh is None:
        from .mesh import get_mesh
        mesh = get_mesh()
        if mesh is None or axis_name not in mesh.dim_names:
            from .fleet.topology import get_hybrid_communicate_group
            hcg = get_hybrid_communicate_group()
            mesh = hcg.mesh if hcg is not None else None
    if mesh is None or axis_name not in mesh.dim_names:
        return None
    return mesh.get_group(axis_name)


def _size_rank(group):
    if group is None:
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def _raw(x) -> torch.Tensor:
    return x._t if isinstance(x, Tensor) else torch.as_tensor(x)


# ------------------------------------------------------------------ ring

def _chunk_attn(q, k, v, scale, m, l, acc, q_off, k_off, causal, kv_len):
    """One online-softmax accumulation step of local Q against one K/V
    chunk. Shapes: q [B,H,Sq,D], k/v [B,H,Sk,D]; carries m,l [B,H,Sq],
    acc [B,H,Sq,D] (fp32).

    The reference's step, with its values. The running max is a constant
    of the backward (its gradient is zero in exact arithmetic: the softmax
    does not depend on the shift; the reference differentiates through it
    and gets that zero up to rounding), and the scores are shifted and
    exponentiated in place, so a step keeps two [Sq, Sk] fp32 residuals
    (the exponentials and P·V's fp32 operand), not five: at one rank the
    chunk is the whole sequence. The reference's guard for entries at
    ``NEG_INF`` keeps p == 0 in rows that have seen no key yet (``s -
    m_new`` would be 0 - 0); elsewhere a masked entry's exp underflows to 0
    exactly, so the guard is applied by row."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s.mul_(scale)
    sk = k.shape[2]
    k_pos = k_off + torch.arange(sk, device=q.device)[None, None, None, :]
    mask = k_pos < kv_len
    if causal:
        q_pos = q_off + torch.arange(q.shape[2],
                                     device=q.device)[None, None, :, None]
        mask = mask & (k_pos <= q_pos)
    s.masked_fill_(~mask, NEG_INF)
    m_new = torch.maximum(m, s.detach().amax(-1))
    dead = (m_new <= NEG_INF / 2)[..., None]
    e = s.sub_(m_new[..., None]).exp_()
    p = e.masked_fill(dead, 0.0)
    alpha = torch.exp(torch.where(m <= NEG_INF / 2, 0.0, m - m_new))
    l_new = alpha * l + p.sum(-1)
    pv = p.to(v.dtype)
    del p
    acc_new = acc * alpha[..., None] + torch.matmul(pv.float(), v.float())
    return m_new, l_new, acc_new


def _ring(q, k, v, group, causal, scale):
    n, rank = _size_rank(group)
    b, s_local, h, d = q.shape
    if scale is None:
        scale = d ** -0.5
    qt, kc, vc = (t.transpose(1, 2) for t in (q, k, v))   # [B,H,S,D]
    q_off = rank * s_local
    m = torch.full((b, h, s_local), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, s_local), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, s_local, d), dtype=torch.float32,
                      device=q.device)
    for step in range(n):
        # at ring step t this rank holds the chunk that started on rank
        # (rank - t) mod n; the last chunk needs no trailing shift
        k_off = ((rank - step) % n) * s_local
        m, l, acc = _chunk_attn(qt, kc, vc, scale, m, l, acc, q_off, k_off,
                                causal, kv_len=n * s_local)
        if step < n - 1:
            kc = C.ring_shift(kc, group)
            vc = C.ring_shift(vc, group)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype).transpose(1, 2)


def ring_attention(q, k, v, axis_name: str = "sep", causal: bool = False,
                   scale: Optional[float] = None):
    """Ring attention over the ``axis_name`` mesh axis.

    Args are this rank's pieces [B, S_local, H, D] (sequence split in rank
    order). Returns this rank's output piece [B, S_local, H, D]."""
    out = _ring(_raw(q), _raw(k), _raw(v), _axis_group(axis_name), causal,
                scale)
    return Tensor(out) if isinstance(q, Tensor) else out


# --------------------------------------------------------------- ulysses

def _ulysses(q, k, v, group, causal, scale, attn_fn):
    n, _ = _size_rank(group)
    h = q.shape[2]
    if h % n:
        raise ValueError(f"ulysses needs num_heads % sep == 0, got {h} % {n}")

    def fwd_a2a(x):   # [B, S/n, H, D] -> [B, S, H/n, D]
        return x if group is None else C.resplit(x, 2, 1, group)

    def bwd_a2a(x):
        return x if group is None else C.resplit(x, 1, 2, group)

    qg, kg, vg = fwd_a2a(q), fwd_a2a(k), fwd_a2a(v)
    if attn_fn is None:
        attn_fn = functools.partial(_full_attention, causal=causal,
                                    scale=scale)
    return bwd_a2a(_raw(attn_fn(qg, kg, vg)))


def ulysses_attention(q, k, v, axis_name: str = "sep",
                      causal: bool = False, scale: Optional[float] = None,
                      attn_fn=None):
    """DeepSpeed-Ulysses attention over ``axis_name``.

    The all-to-all turns sequence-split [B, S/n, H, D] pieces into
    head-split [B, S, H/n, D] ones; ``attn_fn(q, k, v)`` (default: plain
    full-sequence attention with ``causal`` and ``scale``) runs locally,
    then the inverse all-to-all restores the sequence split."""
    out = _ulysses(_raw(q), _raw(k), _raw(v), _axis_group(axis_name),
                   causal, scale, attn_fn)
    return Tensor(out) if isinstance(q, Tensor) else out


def _full_attention(q, k, v, causal, scale):
    """Plain attention on [B, S, H, D]: fp32 scores, softmax, P·V in the
    values' type. The scores are one contiguous [B, H, S, S] fp32 buffer,
    scaled and masked in place (the reference's values), alive until the
    softmax."""
    d = q.shape[-1]
    if scale is None:
        scale = d ** -0.5
    s = torch.matmul(q.float().transpose(1, 2), k.float().permute(0, 2, 3, 1))
    s.mul_(scale)
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        mask = torch.arange(sk, device=s.device)[None, :] \
            <= torch.arange(sq, device=s.device)[:, None]
        s.masked_fill_(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    del s
    return torch.matmul(p, v.transpose(1, 2)).transpose(1, 2)


# ------------------------------------------------------------ global wrap

def _seq_sharded(fn, q, k, v, mesh, seq_axis: str,
                 batch_axis: Optional[str]):
    """``fn(q_piece, k_piece, v_piece, seq_group)`` on this rank's pieces
    of the global values, as a DistTensor: ``Shard(1)`` on ``seq_axis``,
    ``Shard(0)`` on ``batch_axis``, ``Replicate()`` elsewhere. Every rank
    of the world calls it (a mesh makes its groups on first use). The cut
    is ``_collectives.split``, so a global input's gradient is whole on
    every rank."""
    from .api import dtensor_from_local
    from .auto_parallel.reshard_functions import in_mesh
    from .placements import Replicate, Shard
    if dist.is_initialized():
        mesh.groups()
    placements = [Shard(1) if a == seq_axis else
                  Shard(0) if a == batch_axis else Replicate()
                  for a in mesh.dim_names]
    q, k, v = _raw(q), _raw(k), _raw(v)
    if dist.is_initialized() and not in_mesh(mesh):
        return dtensor_from_local(Tensor(q.new_empty((0,))), mesh,
                                  placements)
    pieces = []
    for t in (q, k, v):
        for axis, dim in ((batch_axis, 0), (seq_axis, 1)):
            group = None if axis is None else _axis_group(axis, mesh)
            if group is not None:
                t = C.split(t, dim, group)
            elif axis is not None and mesh.axis_size(axis) > 1:
                raise RuntimeError(f"axis {axis!r} of {mesh} has "
                                   f"{mesh.axis_size(axis)} ranks and no "
                                   f"process group")
        pieces.append(t)
    out = fn(*pieces, _axis_group(seq_axis, mesh))
    return dtensor_from_local(Tensor(out), mesh, placements)


def ring_attention_global(q, k, v, mesh, seq_axis: str = "sep",
                          causal: bool = False,
                          scale: Optional[float] = None,
                          batch_axis: Optional[str] = None):
    """Ring attention on GLOBAL values [B, S, H, D]: the sequence split
    over ``seq_axis`` of ``mesh`` (and the batch over ``batch_axis`` if
    given); returns this rank's output piece as a DistTensor."""
    return _seq_sharded(
        lambda q_, k_, v_, g: _ring(q_, k_, v_, g, causal, scale),
        q, k, v, mesh, seq_axis, batch_axis)


def ulysses_attention_global(q, k, v, mesh, seq_axis: str = "sep",
                             causal: bool = False,
                             scale: Optional[float] = None,
                             batch_axis: Optional[str] = None):
    """Ulysses attention on GLOBAL values [B, S, H, D], as
    :func:`ring_attention_global`."""
    return _seq_sharded(
        lambda q_, k_, v_, g: _ulysses(q_, k_, v_, g, causal, scale, None),
        q, k, v, mesh, seq_axis, batch_axis)
