"""The reference-parity op batch: the counterpart of
``paddle_tpu/ops/parity.py``, op for op, each registered under the
reference's name with its functional wrapper beside it: the fused family
(``fused_bias_act``, ``fused_dropout_add``, ``fused_softmax_mask*``,
``fused_gemm_epilogue``, ``skip_layernorm``, ...), the strided and view
family, creation and compare ops, interpolation variants, sequence, MoE,
metric and decoding utilities. The reference writes all of them as XLA
bodies, not Pallas kernels; here they are plain PyTorch.

Views: ``as_strided``, ``view_dtype`` and ``view_slice`` return copies,
as the reference's gathers and bitcasts do. A torch view would alias its
input, and a later in-place write to the input (``set_value``, or torch
code on the payload) would show through it where the reference's result
keeps its values.

Random ops take a ``torch.Generator`` where the reference takes a PRNG
key: the generator of their input's device (``_core/random.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from .._core import dtype as dtypes
from .._core import random as rnd
from .._core.dispatch import apply, meta, unwrap
from .._core.op_registry import register_op
from ._helper import promoted
from .linalg import promote

# ============================================================ fused family

# jax.nn.gelu's default: the tanh approximation
_ACTS = {
    "gelu": lambda v: tF.gelu(v, approximate="tanh"), "relu": torch.relu,
    "silu": tF.silu,
    "none": lambda v: v,
    "swiglu": lambda v: tF.silu(v[..., :v.shape[-1] // 2])
    * v[..., v.shape[-1] // 2:],
}


def _gen_of(x):
    return rnd.generator(meta(x).device)


@register_op("fused_bias_act")
def _fused_bias_act(x, b, act):
    return _ACTS[act](x + b)


def fused_bias_act(x, bias, act_method="gelu", name=None):
    """Bias add and activation in one op."""
    return apply("fused_bias_act", _fused_bias_act, x, bias,
                 act=str(act_method))


def _keep_mask(gen, shape, p, device):
    return torch.rand(shape, generator=gen, device=device) >= p


@register_op("fused_dropout_add")
def _fused_dropout_add(x, y, key, p, training, mode="upscale_in_train"):
    if training and p > 0.0:
        keep = _keep_mask(key, x.shape, p, x.device)
        if mode == "upscale_in_train":
            return torch.where(keep, x / (1.0 - p), 0.0) + y
        return torch.where(keep, x, 0.0) + y    # downscale_in_infer
    if not training and mode == "downscale_in_infer" and p > 0.0:
        return x * (1.0 - p) + y
    return x + y


def fused_dropout_add(x, y, p=0.5, training=True, mode="upscale_in_train",
                      name=None):
    """dropout(x) + y in one op (both dropout modes)."""
    return apply("fused_dropout_add", _fused_dropout_add, x, y, _gen_of(x),
                 p=float(p), training=bool(training), mode=str(mode))


@register_op("fused_softmax_mask")
def _softmax_mask(x, mask):
    return torch.softmax(x + mask, -1)


def fused_softmax_mask(x, mask, name=None):
    """Additive mask and softmax as one op."""
    return apply("fused_softmax_mask", _softmax_mask, x, mask)


@register_op("fused_softmax_mask_upper_triangle")
def _softmax_mask_triu(x):
    r, t = x.shape[-2], x.shape[-1]
    keep = torch.ones(r, t, dtype=torch.bool, device=x.device).tril()
    return torch.softmax(torch.where(keep, x, -1e9), -1)


def fused_softmax_mask_upper_triangle(x, name=None):
    """Causal (upper-triangle-masked) softmax as one op."""
    return apply("fused_softmax_mask_upper_triangle", _softmax_mask_triu, x)


@register_op("fused_gemm_epilogue")
def _fused_gemm_epilogue(x, y, b, act):
    x, y = promote(x, y)
    return _ACTS[act](x @ y + b)


def fused_gemm_epilogue(x, y, bias, trans_x=False, trans_y=False,
                        activation="none", name=None):
    """matmul, bias and activation epilogue."""
    from .manipulation import t
    if trans_x:
        x = t(x)
    if trans_y:
        y = t(y)
    return apply("fused_gemm_epilogue", _fused_gemm_epilogue, x, y, bias,
                 act=str(activation))


def _layer_norm(h, w, b, eps):
    mu = h.mean(-1, keepdim=True)
    var = ((h - mu) ** 2).mean(-1, keepdim=True)
    return (h - mu) / torch.sqrt(var + eps) * w + b


@register_op("skip_layernorm")
def _skip_layernorm(x, skip, w, b, eps):
    return _layer_norm(x + skip, w, b, eps)


def skip_layernorm(x, skip, weight, bias, epsilon=1e-5, name=None):
    """Residual add and layer_norm as one op."""
    return apply("skip_layernorm", _skip_layernorm, x, skip, weight, bias,
                 eps=float(epsilon))


@register_op("fused_bias_dropout_residual_layer_norm")
def _fused_bias_dropout_residual_ln(x, residual, bias, w, b, key, p,
                                    training, eps):
    h = x + bias
    if training and p > 0.0:
        h = torch.where(_keep_mask(key, h.shape, p, h.device),
                        h / (1.0 - p), 0.0)
    return _layer_norm(h + residual, w, b, eps)


def fused_bias_dropout_residual_layer_norm(
        x, residual, bias, ln_scale, ln_bias, dropout_rate=0.5,
        ln_epsilon=1e-5, training=True, name=None):
    return apply("fused_bias_dropout_residual_layer_norm",
                 _fused_bias_dropout_residual_ln, x, residual, bias,
                 ln_scale, ln_bias, _gen_of(x), p=float(dropout_rate),
                 training=bool(training), eps=float(ln_epsilon))


@register_op("fused_linear_param_grad_add", multi_output=True)
def _fused_linear_param_grad_add(x, dout, dw_acc, db_acc, has_bias):
    dw = torch.einsum("...i,...o->io", x, dout)
    dw = dw if dw_acc is None else dw_acc + dw
    if not has_bias:
        return dw, torch.zeros(dout.shape[-1], dtype=dout.dtype,
                               device=dout.device)
    db = dout.reshape(-1, dout.shape[-1]).sum(0)
    return dw, db if db_acc is None else db_acc + db


def fused_linear_param_grad_add(x, dout, dweight=None, dbias=None,
                                multi_precision=False, has_bias=True,
                                name=None):
    """dW and db accumulation in one op."""
    return tuple(apply("fused_linear_param_grad_add",
                       _fused_linear_param_grad_add, x, dout, dweight, dbias,
                       has_bias=bool(has_bias)))


def _def_fused_elementwise(name, fn):
    def body(x, y, scale):
        return fn(*promoted(x, y)) * scale
    register_op(name, body)

    def wrapper(x, y, scale=1.0, name=None):
        return apply(op_name, body, x, y, scale=float(scale))
    op_name = name
    wrapper.__name__ = name
    return wrapper


fused_elementwise_add = _def_fused_elementwise("fused_elementwise_add",
                                               torch.add)
fused_elementwise_sub = _def_fused_elementwise("fused_elementwise_sub",
                                               torch.sub)
fused_elementwise_mul = _def_fused_elementwise("fused_elementwise_mul",
                                               torch.mul)
fused_elementwise_div = _def_fused_elementwise("fused_elementwise_div",
                                               torch.true_divide)


# ====================================================== strided/view family

@register_op("as_strided")
def _as_strided(x, shape, stride, offset):
    return torch.as_strided(x.contiguous().reshape(-1), shape, stride,
                            offset).clone()


def as_strided(x, shape, stride, offset=0, name=None):
    """The elements ``offset + sum_d i_d * stride[d]`` of ``x``'s
    row-major elements, as a new tensor (a copy: see the module
    docstring)."""
    return apply("as_strided", _as_strided, x,
                 shape=tuple(int(s) for s in shape),
                 stride=tuple(int(s) for s in stride), offset=int(offset))


@register_op("view_dtype")
def _view_dtype(x, dtype):
    return x.contiguous().view(dtypes.to_torch(dtype)).clone()


def view_dtype(x, dtype, name=None):
    """The payload's bytes read as ``dtype`` (the last axis grows or
    shrinks by the ratio of the item sizes), as a copy."""
    return apply("view_dtype", _view_dtype, x,
                 dtype=dtypes.to_dtype(dtype).name)


@register_op("view_slice")
def _view_slice(x, begin, end):
    return x[tuple(slice(b, e) for b, e in zip(begin, end))].clone()


def view_slice(x, begin, end, name=None):
    """A contiguous sub-block, as a copy."""
    return apply("view_slice", _view_slice, x,
                 begin=tuple(int(b) for b in begin),
                 end=tuple(int(e) for e in end))


@register_op("trans_layout")
def _trans_layout(x, perm):
    return x.permute(perm)


def trans_layout(x, perm, name=None):
    return apply("trans_layout", _trans_layout, x,
                 perm=tuple(int(p) for p in perm))


@register_op("index_select_strided")
def _index_select_strided(x, index, axis):
    from .search import _gather
    return _gather(x, index, axis)


def index_select_strided(x, index, axis=0, name=None):
    return apply("index_select_strided", _index_select_strided, x, index,
                 axis=int(axis))


@register_op("fill_diagonal_tensor")
def _fill_diagonal_tensor(x, y, offset, dim1, dim2):
    i1 = torch.arange(x.shape[dim1], device=x.device).reshape(
        [-1 if d == dim1 else 1 for d in range(x.dim())])
    i2 = torch.arange(x.shape[dim2], device=x.device).reshape(
        [-1 if d == dim2 else 1 for d in range(x.dim())])
    on_diag = (i2 - i1) == offset
    if y.dim() == 1:
        pos = i1 if offset >= 0 else i2
        y = y[pos.clamp(0, y.shape[-1] - 1)]
    return torch.where(on_diag, y.to(x.dtype), x)


def fill_diagonal_tensor(x, y, offset=0, dim1=0, dim2=1, name=None):
    """``y`` written along the (dim1, dim2) diagonal of ``x``."""
    return apply("fill_diagonal_tensor", _fill_diagonal_tensor, x, y,
                 offset=int(offset), dim1=int(dim1), dim2=int(dim2))


# ================================================= creation / compare ops
# (eye_k, linspace_k, logspace_k, tril/triu_indices_k, full_k, full_like_k,
# numel_k: creation.py; kthvalue_k, mode_k: search.py)

@register_op("allclose_k")
def _allclose(x, y, rtol, atol, equal_nan):
    return torch.isclose(*promoted(x, y), rtol=rtol, atol=atol,
                         equal_nan=equal_nan).all()


@register_op("isclose_k")
def _isclose(x, y, rtol, atol, equal_nan):
    return torch.isclose(*promoted(x, y), rtol=rtol, atol=atol,
                         equal_nan=equal_nan)


@register_op("equal_all_k")
def _equal_all(x, y):
    if x.shape != y.shape:
        return torch.zeros((), dtype=torch.bool, device=x.device)
    return torch.eq(*promoted(x, y)).all()


@register_op("bmm_k")
def _bmm(x, y):
    return torch.matmul(*promote(x, y))


@register_op("mv_k")
def _mv(x, v):
    return torch.matmul(*promote(x, v))


@register_op("eigvalsh_k")
def _eigvalsh(x):
    from .linalg import _eigh
    return _eigh(x, "L")[0]


@register_op("frobenius_norm_k")
def _frobenius_norm(x, axis, keepdim):
    dims = tuple(range(x.dim())) if axis is None else axis
    return torch.sqrt(torch.sum(x * x, dims, keepdim=keepdim))


def frobenius_norm(x, axis=None, keepdim=False, name=None):
    return apply("frobenius_norm_k", _frobenius_norm, x,
                 axis=None if axis is None else tuple(axis),
                 keepdim=bool(keepdim))


@register_op("shape_k")
def _shape(x):
    """int32 [ndim] on ``x``'s device, filled there (no host copy)."""
    return torch.stack([torch.full((), s, dtype=torch.int32, device=x.device)
                        for s in x.shape]) if x.dim() else \
        torch.zeros(0, dtype=torch.int32, device=x.device)


@register_op("increment_k")
def _increment(x, value):
    return x + value


# kldiv pointwise and sigmoid cross entropy with logits
@register_op("kldiv_pointwise_k")
def _kldiv_pointwise(x, target):
    return target * (torch.log(torch.clamp(target, min=1e-12)) - x)


@register_op("sigmoid_cross_entropy_with_logits_k")
def _sigmoid_ce(x, label):
    return torch.clamp(x, min=0.0) - x * label + torch.log1p(
        torch.exp(-torch.abs(x)))


def kldiv_loss_pointwise(input, target, name=None):
    return apply("kldiv_pointwise_k", _kldiv_pointwise, input, target)


def sigmoid_cross_entropy_with_logits(x, label, name=None):
    return apply("sigmoid_cross_entropy_with_logits_k", _sigmoid_ce, x,
                 label)


# ============================================== interpolation variants
# NCHW / NCDHW in; the reference's jax.image.resize: half-pixel centres,
# a weight matrix per resized axis (linear: the triangle kernel; cubic:
# Keys' kernel with a = -0.5), its columns normalised to sum 1 (the
# border renormalises), widened by the downscale factor (antialiasing);
# nearest: the input pixel whose centre is nearest, ties to the right.

def _linear_kernel(x):
    return torch.clamp(1.0 - x, min=0.0)


def _cubic_kernel(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def _weights(n_in, n_out, kernel, device):
    """[n_in, n_out] float32: jax.image's compute_weight_mat."""
    inv = n_in / n_out
    k_scale = max(inv, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device)
              + 0.5) * inv - 0.5
    x = torch.abs(sample[None, :] - torch.arange(
        n_in, dtype=torch.float32, device=device)[:, None]) / k_scale
    w = kernel(x)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * 1.1920929e-07,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def _resize(x, size, kernel):
    for i, n_out in enumerate(size):
        axis = 2 + i
        n_in = x.shape[axis]
        if n_in == n_out:
            continue
        if kernel is None:  # nearest
            idx = torch.floor((torch.arange(n_out, device=x.device) + 0.5)
                              * (n_in / n_out)).long().clamp(0, n_in - 1)
            x = x.index_select(axis, idx)
            continue
        w = _weights(n_in, n_out, kernel, x.device).to(x.dtype)
        x = torch.movedim(torch.tensordot(x, w, ([axis], [0])), -1, axis)
    return x


_KERNELS = {"bilinear_interp": _linear_kernel, "linear_interp":
            _linear_kernel, "trilinear_interp": _linear_kernel,
            "bicubic_interp": _cubic_kernel, "nearest_interp": None}


def _def_interp(name):
    kernel = _KERNELS[name]

    def body(x, size):
        return _resize(x, tuple(int(s) for s in size), kernel)
    register_op(name, body)

    def wrapper(x, size, name=None):
        return apply(op_name, body, x, size=tuple(int(s) for s in size))
    op_name = name
    wrapper.__name__ = name
    return wrapper


bilinear_interp = _def_interp("bilinear_interp")
nearest_interp = _def_interp("nearest_interp")
bicubic_interp = _def_interp("bicubic_interp")
linear_interp = _def_interp("linear_interp")
trilinear_interp = _def_interp("trilinear_interp")


# =============================================== sequence / misc utility

@register_op("sequence_mask_k")
def _sequence_mask(lengths, maxlen):
    pos = torch.arange(maxlen, device=lengths.device)
    return (pos < lengths.unsqueeze(-1)).to(torch.int64)


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """[..., maxlen] 0/1 mask from lengths (``maxlen`` None: the longest,
    read on the host)."""
    ml = int(maxlen) if maxlen is not None else int(unwrap(x).max())
    out = apply("sequence_mask_k", _sequence_mask, x, maxlen=ml)
    return out if str(dtype) == "int64" else out.astype(dtype)


@register_op("shard_index_k")
def _shard_index(x, index_num, nshards, shard_id, ignore_value):
    size = index_num // nshards
    return torch.where(torch.div(x, size, rounding_mode="floor") == shard_id,
                       x % size, ignore_value)


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1,
                name=None):
    """Global ids recoded into per-shard ids."""
    return apply("shard_index_k", _shard_index, input,
                 index_num=int(index_num), nshards=int(nshards),
                 shard_id=int(shard_id), ignore_value=int(ignore_value))


@register_op("label_smooth_k")
def _label_smooth(x, prior, epsilon):
    return (1.0 - epsilon) * x + epsilon * (
        prior if prior is not None else 1.0 / x.shape[-1])


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    return apply("label_smooth_k", _label_smooth, label, prior_dist,
                 epsilon=float(epsilon))


@register_op("gumbel_softmax_k")
def _gumbel_softmax(x, key, tau, hard, axis):
    # float64 uniforms, as the reference's (JAX's default float under x64)
    u = torch.rand(x.shape, generator=key, device=x.device,
                   dtype=torch.float64) * (1.0 - 1e-20) + 1e-20
    y = torch.softmax((x - torch.log(-torch.log(u))) / tau, axis)
    if hard:
        one = torch.zeros_like(y).scatter(
            axis, torch.argmax(y, axis, keepdim=True), 1.0)
        y = one + y - y.detach()  # straight-through
    return y


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """Gumbel-softmax sample; ``hard``: one-hot with the soft gradient."""
    return apply("gumbel_softmax_k", _gumbel_softmax, x, _gen_of(x),
                 tau=float(temperature), hard=bool(hard), axis=int(axis))


@register_op("gru_unit_k")
def _gru_unit(x, h, wu, wr, wc):
    hx = torch.cat([h, x], -1)
    u = torch.sigmoid(hx @ wu)
    r = torch.sigmoid(hx @ wr)
    c = torch.tanh(torch.cat([r * h, x], -1) @ wc)
    return (1.0 - u) * h + u * c


def gru_unit(x, hidden, weight_update, weight_reset, weight_cand,
             name=None):
    """One GRU cell step."""
    return apply("gru_unit_k", _gru_unit, x, hidden, weight_update,
                 weight_reset, weight_cand)


@register_op("partial_sum_k")
def _partial_sum(*xs, start, length):
    return sum(x[:, start:start + length] for x in xs)


def partial_sum(xs, start_index=0, length=-1, name=None):
    """The sum of one column slice of each input."""
    ln = int(length) if length != -1 else \
        unwrap(xs[0]).shape[1] - start_index
    return apply("partial_sum_k", _partial_sum, *xs, start=int(start_index),
                 length=ln)


@register_op("partial_concat_k")
def _partial_concat(*xs, start, length):
    return torch.cat([x[:, start:start + length] for x in xs], -1)


def partial_concat(xs, start_index=0, length=-1, name=None):
    """One column slice of each input, concatenated."""
    ln = int(length) if length != -1 else \
        unwrap(xs[0]).shape[1] - start_index
    return apply("partial_concat_k", _partial_concat, *xs,
                 start=int(start_index), length=ln)


@register_op("shuffle_channel_k")
def _shuffle_channel(x, group):
    s = x.shape
    return x.reshape((s[0], group, s[1] // group) + s[2:]).transpose(
        1, 2).reshape(s)


def shuffle_channel(x, group=1, name=None):
    return apply("shuffle_channel_k", _shuffle_channel, x, group=int(group))


# ---------------------------------------------------- MoE aux op family

@register_op("number_count_k")
def _number_count(ids, upper):
    return torch.nn.functional.one_hot(ids.to(torch.int64).clamp(
        min=0), upper).mul(((ids >= 0) & (ids < upper)).to(
            torch.int64).unsqueeze(-1)).sum(0)


def number_count(numbers, upper_range, name=None):
    """Per expert id in [0, upper_range), how many of ``numbers`` hold
    it."""
    return apply("number_count_k", _number_count, numbers,
                 upper=int(upper_range))


@register_op("limit_by_capacity_k")
def _limit_by_capacity(expert_count, capacity, n_worker):
    cap = capacity.repeat_interleave(n_worker, 0) if capacity.shape != \
        expert_count.shape else capacity
    return torch.minimum(expert_count, cap)


def limit_by_capacity(expert_count, capacity, n_worker, name=None):
    return apply("limit_by_capacity_k", _limit_by_capacity, expert_count,
                 capacity, n_worker=int(n_worker))


@register_op("prune_gate_by_capacity_k")
def _prune_gate(gate_idx, expert_count, n_expert):
    valid = (gate_idx >= 0) & (gate_idx < n_expert)
    one = tF.one_hot(gate_idx.clamp(0, n_expert - 1).to(torch.int64),
                     n_expert) * valid.unsqueeze(-1)
    rank = (torch.cumsum(one, 0) * one).sum(-1) - 1
    cap = expert_count[gate_idx.clamp(0, n_expert - 1).to(torch.int64)]
    return torch.where(rank < cap, gate_idx, -1)


def prune_gate_by_capacity(gate_idx, expert_count, n_expert, n_worker=1,
                           name=None):
    """Gate ids past their expert's capacity (in token order) set to
    -1."""
    return apply("prune_gate_by_capacity_k", _prune_gate, gate_idx,
                 expert_count, n_expert=int(n_expert))


@register_op("random_routing_k")
def _random_routing(prob, topk_value, topk_idx, key):
    u = torch.rand(topk_idx.shape, generator=key, device=topk_idx.device)
    return torch.where(u < torch.clamp(prob, 0.0, 1.0), topk_idx, -1)


def random_routing(topk_idx, topk_value, prob, name=None):
    return apply("random_routing_k", _random_routing, prob, topk_value,
                 topk_idx, _gen_of(topk_idx))


# ----------------------------------------------------- metric op family

@register_op("accuracy_k")
def _accuracy(pred_idx, label):
    return (pred_idx == label.reshape(-1, 1)).any(-1).float().mean()


def accuracy_op(topk_indices, label, name=None):
    """The share of rows whose label is among their top-k ids."""
    return apply("accuracy_k", _accuracy, topk_indices, label)


@register_op("auc_k")
def _auc(pred, label, num_thresholds):
    """One-shot AUC over ``num_thresholds`` threshold buckets."""
    thr = torch.linspace(0.0, 1.0, num_thresholds, device=pred.device,
                         dtype=torch.float32)
    p = pred[:, -1] if pred.dim() > 1 else pred
    pos = (label.reshape(-1) > 0).float()
    neg = 1.0 - pos
    above = (p[None, :] >= thr[:, None]).float()
    tpr = (pos[None, :] * above).sum(1) / torch.clamp(pos.sum(), min=1.0)
    fpr = (neg[None, :] * above).sum(1) / torch.clamp(neg.sum(), min=1.0)
    return torch.trapezoid(torch.flip(tpr, (0,)), torch.flip(fpr, (0,)))


def auc_op(pred, label, num_thresholds=200, name=None):
    return apply("auc_k", _auc, pred, label,
                 num_thresholds=int(num_thresholds))


# ------------------------------------------------------ edit / decoding

@register_op("edit_distance_k")
def _edit_distance(a, b, a_len, b_len):
    """Levenshtein distance of padded int sequences: the DP row over
    ``a`` swept along ``b`` (steps past ``b_len`` keep the row), read at
    ``a_len``; float32, unnormalized."""
    n, ta = a.shape[0], a.shape[-1]
    row = torch.arange(ta + 1, device=a.device).expand(n, ta + 1).clone()
    for j in range(b.shape[-1]):
        new = torch.empty_like(row)
        new[:, 0] = row[:, 0] + 1
        cost = (a != b[:, j:j + 1]).to(row.dtype)
        for i in range(ta):
            new[:, i + 1] = torch.minimum(torch.minimum(
                new[:, i] + 1, row[:, i + 1] + 1), row[:, i] + cost[:, i])
        row = torch.where((j < b_len).reshape(-1, 1), new, row)
    return row.gather(1, a_len.reshape(-1, 1).to(torch.int64))[:, 0].float()


def edit_distance(hyps, refs, hyps_len, refs_len, normalized=False,
                  name=None):
    out = apply("edit_distance_k", _edit_distance, hyps, refs, hyps_len,
                refs_len)
    if normalized:
        from .math import divide
        return divide(out, refs_len.astype("float32"))
    return out


@register_op("viterbi_decode_k", multi_output=True)
def _viterbi(potentials, trans, lengths):
    """Best tag path [B, T] (int64) and its score [B] of a dense CRF;
    steps at or past a sample's length keep its score and point back to
    the same tag (its path's tail repeats the last tag)."""
    b, t, n = potentials.shape
    if lengths is None:
        lengths = torch.full((b,), t, device=potentials.device)
    score = potentials[:, 0]
    backs = []
    ident = torch.arange(n, device=potentials.device).expand(b, n)
    for step in range(1, t):
        cand = score[:, :, None] + trans[None]
        best, back = cand.max(1)
        active = (step < lengths).reshape(-1, 1)
        score = torch.where(active, best + potentials[:, step], score)
        backs.append(torch.where(active, back, ident))
    last = torch.argmax(score, -1)
    path = [last]
    for back in reversed(backs):
        last = back.gather(1, last.reshape(-1, 1))[:, 0]
        path.append(last)
    return torch.stack(path[::-1], 1).to(torch.int64), score.amax(-1)


def viterbi_decode(potentials, transition_params, lengths=None,
                   include_bos_eos_tag=False, name=None):
    """(scores, paths) of dense CRF decoding."""
    path, score = apply("viterbi_decode_k", _viterbi, potentials,
                        transition_params, lengths)
    return score, path


@register_op("box_clip_k")
def _box_clip(boxes, im_hw):
    h, w = im_hw[0] - 1, im_hw[1] - 1
    lim = torch.stack([w, h, w, h]).to(boxes.dtype)
    return torch.clamp(torch.minimum(boxes, lim), min=0)


def box_clip(input, im_info, name=None):
    """xyxy boxes clamped into the image."""
    return apply("box_clip_k", _box_clip, input, im_info)


@register_op("prior_box_k")
def _prior_box(fh, fw, ih, iw, min_sizes, max_sizes, aspect_ratios):
    from .creation import default_device
    dev = default_device()
    # float64, as the reference's integer grid plus 0.5 under x64
    cx = (torch.arange(fw, device=dev, dtype=torch.float64) + 0.5) * (
        iw / fw)
    cy = (torch.arange(fh, device=dev, dtype=torch.float64) + 0.5) * (
        ih / fh)
    boxes = []
    for ms in min_sizes:
        whs = [(ms, ms)] + [(ms * ar ** 0.5, ms / ar ** 0.5)
                            for ar in aspect_ratios] + \
            [((ms * mx) ** 0.5, (ms * mx) ** 0.5) for mx in max_sizes]
        for w, h in whs:
            x0 = ((cx[None, :] - w / 2) / iw).expand(fh, fw)
            y0 = ((cy[:, None] - h / 2) / ih).expand(fh, fw)
            x1 = ((cx[None, :] + w / 2) / iw).expand(fh, fw)
            y1 = ((cy[:, None] + h / 2) / ih).expand(fh, fw)
            boxes.append(torch.stack([x0, y0, x1, y1], -1))
    return torch.stack(boxes, 2)


def prior_box(input, image, min_sizes, max_sizes=(), aspect_ratios=(1.0,),
              name=None, **kwargs):
    """SSD anchors [fh, fw, boxes, 4], float64."""
    fh, fw = meta(input).shape[-2:]
    ih, iw = meta(image).shape[-2:]
    from .._core.tensor import Tensor
    return Tensor(apply("prior_box_k", _prior_box, fh=int(fh), fw=int(fw),
                        ih=int(ih), iw=int(iw),
                        min_sizes=tuple(float(m) for m in min_sizes),
                        max_sizes=tuple(float(m) for m in max_sizes),
                        aspect_ratios=tuple(float(a)
                                            for a in aspect_ratios)))
