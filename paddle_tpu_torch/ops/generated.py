"""AUTO-GENERATED by paddle_tpu_torch.ops.yaml.gen from ops.yaml: do not
edit. Regenerate with python -m paddle_tpu_torch.ops.yaml.gen."""
from .._core.op_registry import call

# the default of a required tensor arg that follows an optional one
_REQUIRED = object()


def matmul(x, y, *, transpose_x=False, transpose_y=False, name=None):
    """Generated from ops.yaml (op: matmul)."""
    return call('matmul', x, y, transpose_x=transpose_x, transpose_y=transpose_y)


def linear(x, w, b, name=None):
    """Generated from ops.yaml (op: linear)."""
    return call('linear', x, w, b)


def embedding(w, ids, *, padding_idx=-1, name=None):
    """Generated from ops.yaml (op: embedding)."""
    return call('embedding', w, ids, padding_idx=padding_idx)


def softmax(x, *, axis=-1, name=None):
    """Generated from ops.yaml (op: softmax)."""
    return call('softmax', x, axis=axis)


def cast(x, *, dtype, name=None):
    """Generated from ops.yaml (op: cast)."""
    return call('cast', x, dtype=dtype)


def scale(x, *, scale=1.0, bias=0.0, bias_after_scale=True, name=None):
    """Generated from ops.yaml (op: scale)."""
    return call('scale', x, scale=scale, bias=bias, bias_after_scale=bias_after_scale)


def transpose(x, *, perm, name=None):
    """Generated from ops.yaml (op: transpose)."""
    return call('transpose', x, perm=perm)


def reshape(x, *, shape, name=None):
    """Generated from ops.yaml (op: reshape)."""
    return call('reshape', x, shape=shape)


def clip(x, *, lo, hi, name=None):
    """Generated from ops.yaml (op: clip)."""
    return call('clip', x, lo=lo, hi=hi)


def tril(x, *, diagonal=0, name=None):
    """Generated from ops.yaml (op: tril)."""
    return call('tril', x, diagonal=diagonal)


def triu(x, *, diagonal=0, name=None):
    """Generated from ops.yaml (op: triu)."""
    return call('triu', x, diagonal=diagonal)


def gelu(x, *, approximate=False, name=None):
    """Generated from ops.yaml (op: gelu)."""
    return call('gelu', x, approximate=approximate)


def log_sigmoid(x, name=None):
    """Generated from ops.yaml (op: log_sigmoid)."""
    return call('log_sigmoid', x)


def flip(x, *, axes, name=None):
    """Generated from ops.yaml (op: flip)."""
    return call('flip', x, axes=axes)


def tile(x, *, reps, name=None):
    """Generated from ops.yaml (op: tile)."""
    return call('tile', x, reps=reps)


def one_hot_k(x, *, num_classes, name=None):
    """Generated from ops.yaml (op: one_hot_k)."""
    return call('one_hot_k', x, num_classes=num_classes)


def gather_tree(ids, parents, name=None):
    """Generated from ops.yaml (op: gather_tree)."""
    return call('gather_tree', ids, parents)


def top_p_sampling(x, ps, *, seed, name=None):
    """Generated from ops.yaml (op: top_p_sampling)."""
    return call('top_p_sampling', x, ps, seed=seed)


def margin_cross_entropy(logits, label, *, margin1=1.0, margin2=0.5, margin3=0.0, scale=64.0, name=None):
    """Generated from ops.yaml (op: margin_cross_entropy)."""
    return call('margin_cross_entropy', logits, label, margin1=margin1, margin2=margin2, margin3=margin3, scale=scale)


def roi_align(x, boxes, boxes_num, *, pooled_height, pooled_width, spatial_scale=1.0, sampling_ratio=-1, aligned=True, name=None):
    """Generated from ops.yaml (op: roi_align)."""
    return call('roi_align', x, boxes, boxes_num, pooled_height=pooled_height, pooled_width=pooled_width, spatial_scale=spatial_scale, sampling_ratio=sampling_ratio, aligned=aligned)


def gammainc_(a, x, name=None):
    """Generated from ops.yaml (op: gammainc_)."""
    return call('gammainc_', a, x)


def gammaincc_(a, x, name=None):
    """Generated from ops.yaml (op: gammaincc_)."""
    return call('gammaincc_', a, x)


def multiply_no_broadcast(x, y, name=None):
    """Generated from ops.yaml (op: multiply_no_broadcast)."""
    return call('multiply_no_broadcast', x, y)


def det_(a, name=None):
    """Generated from ops.yaml (op: det_)."""
    return call('det_', a)


def inverse_(a, name=None):
    """Generated from ops.yaml (op: inverse_)."""
    return call('inverse_', a)


def linalg_eigvals(a, name=None):
    """Generated from ops.yaml (op: linalg_eigvals)."""
    return call('linalg_eigvals', a)


def solve_(a, b, name=None):
    """Generated from ops.yaml (op: solve_)."""
    return call('solve_', a, b)


def linalg_cond(x, *, p=None, name=None):
    """Generated from ops.yaml (op: linalg_cond)."""
    return call('linalg_cond', x, p=p)


def linalg_eig(x, name=None):
    """Generated from ops.yaml (op: linalg_eig)."""
    return call('linalg_eig', x)


def linalg_lstsq(x, y, *, rcond=None, driver=None, name=None):
    """Generated from ops.yaml (op: linalg_lstsq)."""
    return call('linalg_lstsq', x, y, rcond=rcond, driver=driver)


def linalg_lu(x, *, pivot=True, name=None):
    """Generated from ops.yaml (op: linalg_lu)."""
    return call('linalg_lu', x, pivot=pivot)


def linalg_matrix_norm(x, *, p='fro', axis=(-2, -1), keepdim=False, name=None):
    """Generated from ops.yaml (op: linalg_matrix_norm)."""
    return call('linalg_matrix_norm', x, p=p, axis=axis, keepdim=keepdim)


def linalg_matrix_rank(x, *, tol=None, hermitian=False, name=None):
    """Generated from ops.yaml (op: linalg_matrix_rank)."""
    return call('linalg_matrix_rank', x, tol=tol, hermitian=hermitian)


def linalg_vector_norm(x, *, p=2.0, axis=None, keepdim=False, name=None):
    """Generated from ops.yaml (op: linalg_vector_norm)."""
    return call('linalg_vector_norm', x, p=p, axis=axis, keepdim=keepdim)


def celu(x, *, alpha, name=None):
    """Generated from ops.yaml (op: celu)."""
    return call('celu', x, alpha=alpha)


def elu(x, *, alpha, name=None):
    """Generated from ops.yaml (op: elu)."""
    return call('elu', x, alpha=alpha)


def glu_k(x, *, axis, name=None):
    """Generated from ops.yaml (op: glu_k)."""
    return call('glu_k', x, axis=axis)


def hardshrink(x, *, threshold, name=None):
    """Generated from ops.yaml (op: hardshrink)."""
    return call('hardshrink', x, threshold=threshold)


def hardtanh(x, *, mn, mx, name=None):
    """Generated from ops.yaml (op: hardtanh)."""
    return call('hardtanh', x, mn=mn, mx=mx)


def leaky_relu(x, *, negative_slope, name=None):
    """Generated from ops.yaml (op: leaky_relu)."""
    return call('leaky_relu', x, negative_slope=negative_slope)


def log_softmax(x, *, axis, name=None):
    """Generated from ops.yaml (op: log_softmax)."""
    return call('log_softmax', x, axis=axis)


def prelu_k(x, w, name=None):
    """Generated from ops.yaml (op: prelu_k)."""
    return call('prelu_k', x, w)


def selu(x, *, scale, alpha, name=None):
    """Generated from ops.yaml (op: selu)."""
    return call('selu', x, scale=scale, alpha=alpha)


def softplus(x, *, beta, threshold, name=None):
    """Generated from ops.yaml (op: softplus)."""
    return call('softplus', x, beta=beta, threshold=threshold)


def softshrink(x, *, threshold, name=None):
    """Generated from ops.yaml (op: softshrink)."""
    return call('softshrink', x, threshold=threshold)


def thresholded_relu(x, *, threshold, value, name=None):
    """Generated from ops.yaml (op: thresholded_relu)."""
    return call('thresholded_relu', x, threshold=threshold, value=value)


def sdpa(q, k, v, mask=None, dropout_key=_REQUIRED, *, dropout_p, causal, scale, training, name=None):
    """Generated from ops.yaml (op: sdpa)."""
    if dropout_key is _REQUIRED:
        raise TypeError("sdpa() missing required argument: 'dropout_key'")
    return call('sdpa', q, k, v, mask, dropout_key, dropout_p=dropout_p, causal=causal, scale=scale, training=training)


def bilinear_k(x1, x2, w, b=None, name=None):
    """Generated from ops.yaml (op: bilinear_k)."""
    return call('bilinear_k', x1, x2, w, b)


def cosine_similarity_k(x, y, *, axis, eps, name=None):
    """Generated from ops.yaml (op: cosine_similarity_k)."""
    return call('cosine_similarity_k', x, y, axis=axis, eps=eps)


def dropout_k(x, key, *, p, mode, name=None):
    """Generated from ops.yaml (op: dropout_k)."""
    return call('dropout_k', x, key, p=p, mode=mode)


def interpolate_k(x, *, size, mode, align_corners, data_format, name=None):
    """Generated from ops.yaml (op: interpolate_k)."""
    return call('interpolate_k', x, size=size, mode=mode, align_corners=align_corners, data_format=data_format)


def normalize_k(x, *, p, axis, eps, name=None):
    """Generated from ops.yaml (op: normalize_k)."""
    return call('normalize_k', x, p=p, axis=axis, eps=eps)


def unfold_k(x, *, ks, st, pd, dl, name=None):
    """Generated from ops.yaml (op: unfold_k)."""
    return call('unfold_k', x, ks=ks, st=st, pd=pd, dl=dl)


def conv2d(x, w, b=None, *, stride, padding, dilation, groups, dims, fmt, name=None):
    """Generated from ops.yaml (op: conv2d)."""
    return call('conv2d', x, w, b, stride=stride, padding=padding, dilation=dilation, groups=groups, dims=dims, fmt=fmt)


def conv2d_transpose(x, w, b=None, *, stride, padding, output_padding, dilation, groups, dims, fmt, name=None):
    """Generated from ops.yaml (op: conv2d_transpose)."""
    return call('conv2d_transpose', x, w, b, stride=stride, padding=padding, output_padding=output_padding, dilation=dilation, groups=groups, dims=dims, fmt=fmt)


def affine_grid_k(theta, *, oshape, align_corners, name=None):
    """Generated from ops.yaml (op: affine_grid_k)."""
    return call('affine_grid_k', theta, oshape=oshape, align_corners=align_corners)


def channel_shuffle_k(x, *, g, name=None):
    """Generated from ops.yaml (op: channel_shuffle_k)."""
    return call('channel_shuffle_k', x, g=g)


def conv3d_transpose_k(x, w, b=None, *, stride, padding, output_padding, dilation, groups, name=None):
    """Generated from ops.yaml (op: conv3d_transpose_k)."""
    return call('conv3d_transpose_k', x, w, b, stride=stride, padding=padding, output_padding=output_padding, dilation=dilation, groups=groups)


def ctc_loss_k(log_probs, labels, input_lengths, label_lengths, *, blank, reduction, name=None):
    """Generated from ops.yaml (op: ctc_loss_k)."""
    return call('ctc_loss_k', log_probs, labels, input_lengths, label_lengths, blank=blank, reduction=reduction)


def dice_loss_k(input, label, *, epsilon, name=None):
    """Generated from ops.yaml (op: dice_loss_k)."""
    return call('dice_loss_k', input, label, epsilon=epsilon)


def fold_k(x, *, oshape, ksizes, strides, pads, dilations, name=None):
    """Generated from ops.yaml (op: fold_k)."""
    return call('fold_k', x, oshape=oshape, ksizes=ksizes, strides=strides, pads=pads, dilations=dilations)


def gaussian_nll_loss_k(x, y, var, *, full, epsilon, reduction, name=None):
    """Generated from ops.yaml (op: gaussian_nll_loss_k)."""
    return call('gaussian_nll_loss_k', x, y, var, full=full, epsilon=epsilon, reduction=reduction)


def grid_sample_k(x, grid, *, mode, padding_mode, align_corners, name=None):
    """Generated from ops.yaml (op: grid_sample_k)."""
    return call('grid_sample_k', x, grid, mode=mode, padding_mode=padding_mode, align_corners=align_corners)


def hinge_loss_k(logit, label, name=None):
    """Generated from ops.yaml (op: hinge_loss_k)."""
    return call('hinge_loss_k', logit, label)


def hsigmoid_loss_k(x, lbl_in, w, bias, *, num_classes, name=None):
    """Generated from ops.yaml (op: hsigmoid_loss_k)."""
    return call('hsigmoid_loss_k', x, lbl_in, w, bias, num_classes=num_classes)


def huber_loss_k(x, y, *, delta, reduction, name=None):
    """Generated from ops.yaml (op: huber_loss_k)."""
    return call('huber_loss_k', x, y, delta=delta, reduction=reduction)


def log_loss_k(input, label, *, epsilon, name=None):
    """Generated from ops.yaml (op: log_loss_k)."""
    return call('log_loss_k', input, label, epsilon=epsilon)


def max_unpool2d_k(x, indices, *, oh, ow, name=None):
    """Generated from ops.yaml (op: max_unpool2d_k)."""
    return call('max_unpool2d_k', x, indices, oh=oh, ow=ow)


def maxout_k(x, *, groups, axis, name=None):
    """Generated from ops.yaml (op: maxout_k)."""
    return call('maxout_k', x, groups=groups, axis=axis)


def multi_label_soft_margin_loss_k(x, y, w=None, *, reduction, name=None):
    """Generated from ops.yaml (op: multi_label_soft_margin_loss_k)."""
    return call('multi_label_soft_margin_loss_k', x, y, w, reduction=reduction)


def npair_loss_k(a, p, lbl, *, l2_reg, name=None):
    """Generated from ops.yaml (op: npair_loss_k)."""
    return call('npair_loss_k', a, p, lbl, l2_reg=l2_reg)


def pairwise_distance_k(x, y, *, p, epsilon, keepdim, name=None):
    """Generated from ops.yaml (op: pairwise_distance_k)."""
    return call('pairwise_distance_k', x, y, p=p, epsilon=epsilon, keepdim=keepdim)


def pixel_shuffle_k(x, *, r, name=None):
    """Generated from ops.yaml (op: pixel_shuffle_k)."""
    return call('pixel_shuffle_k', x, r=r)


def pixel_unshuffle_k(x, *, r, name=None):
    """Generated from ops.yaml (op: pixel_unshuffle_k)."""
    return call('pixel_unshuffle_k', x, r=r)


def poisson_nll_loss_k(x, y, *, log_input, full, epsilon, reduction, name=None):
    """Generated from ops.yaml (op: poisson_nll_loss_k)."""
    return call('poisson_nll_loss_k', x, y, log_input=log_input, full=full, epsilon=epsilon, reduction=reduction)


def soft_margin_loss_k(x, y, *, reduction, name=None):
    """Generated from ops.yaml (op: soft_margin_loss_k)."""
    return call('soft_margin_loss_k', x, y, reduction=reduction)


def square_error_cost_k(input, label, name=None):
    """Generated from ops.yaml (op: square_error_cost_k)."""
    return call('square_error_cost_k', input, label)


def temporal_shift_k(x, *, seg_num, shift_ratio, name=None):
    """Generated from ops.yaml (op: temporal_shift_k)."""
    return call('temporal_shift_k', x, seg_num=seg_num, shift_ratio=shift_ratio)


def triplet_margin_loss_k(x, pos_, neg, *, margin, p, epsilon, swap, reduction, name=None):
    """Generated from ops.yaml (op: triplet_margin_loss_k)."""
    return call('triplet_margin_loss_k', x, pos_, neg, margin=margin, p=p, epsilon=epsilon, swap=swap, reduction=reduction)


def bce_k(x, y, weight=None, *, use_weight, reduction, name=None):
    """Generated from ops.yaml (op: bce_k)."""
    return call('bce_k', x, y, weight, use_weight=use_weight, reduction=reduction)


def bce_logits_k(x, y, weight=None, pos_weight=None, *, use_weight, use_pos, reduction, name=None):
    """Generated from ops.yaml (op: bce_logits_k)."""
    return call('bce_logits_k', x, y, weight, pos_weight, use_weight=use_weight, use_pos=use_pos, reduction=reduction)


def kl_div_k(x, y, *, reduction, log_target, name=None):
    """Generated from ops.yaml (op: kl_div_k)."""
    return call('kl_div_k', x, y, reduction=reduction, log_target=log_target)


def l1_loss_k(x, y, *, reduction, name=None):
    """Generated from ops.yaml (op: l1_loss_k)."""
    return call('l1_loss_k', x, y, reduction=reduction)


def mse_loss_k(x, y, *, reduction, name=None):
    """Generated from ops.yaml (op: mse_loss_k)."""
    return call('mse_loss_k', x, y, reduction=reduction)


def nll_loss_k(logp, label, weight=None, *, use_weight, ignore_index, reduction, name=None):
    """Generated from ops.yaml (op: nll_loss_k)."""
    return call('nll_loss_k', logp, label, weight, use_weight=use_weight, ignore_index=ignore_index, reduction=reduction)


def sigmoid_focal_k(x, y, norm, *, alpha, gamma, use_norm, name=None):
    """Generated from ops.yaml (op: sigmoid_focal_k)."""
    return call('sigmoid_focal_k', x, y, norm, alpha=alpha, gamma=gamma, use_norm=use_norm)


def smooth_l1_k(x, y, *, reduction, delta, name=None):
    """Generated from ops.yaml (op: smooth_l1_k)."""
    return call('smooth_l1_k', x, y, reduction=reduction, delta=delta)


def softmax_ce(logits, label, weight=None, *, soft_label, ignore_index, axis, reduction, label_smoothing, use_weight, name=None):
    """Generated from ops.yaml (op: softmax_ce)."""
    return call('softmax_ce', logits, label, weight, soft_label=soft_label, ignore_index=ignore_index, axis=axis, reduction=reduction, label_smoothing=label_smoothing, use_weight=use_weight)


def bn_apply(x, mean, var, w, b, *, eps, fmt, name=None):
    """Generated from ops.yaml (op: bn_apply)."""
    return call('bn_apply', x, mean, var, w, b, eps=eps, fmt=fmt)


def bn_stats(x, *, fmt, name=None):
    """Generated from ops.yaml (op: bn_stats)."""
    return call('bn_stats', x, fmt=fmt)


def group_norm(x, w=None, b=None, *, groups, eps, fmt, name=None):
    """Generated from ops.yaml (op: group_norm)."""
    return call('group_norm', x, w, b, groups=groups, eps=eps, fmt=fmt)


def layer_norm(x, w, b, *, eps, norm_ndim, name=None):
    """Generated from ops.yaml (op: layer_norm)."""
    return call('layer_norm', x, w, b, eps=eps, norm_ndim=norm_ndim)


def local_response_norm_k(x, *, size, alpha, beta, k, fmt, name=None):
    """Generated from ops.yaml (op: local_response_norm_k)."""
    return call('local_response_norm_k', x, size=size, alpha=alpha, beta=beta, k=k, fmt=fmt)


def rms_norm(x, w, b=None, *, eps, name=None):
    """Generated from ops.yaml (op: rms_norm)."""
    return call('rms_norm', x, w, b, eps=eps)


def adaptive_avg_pool2d(x, *, out_hw, fmt, name=None):
    """Generated from ops.yaml (op: adaptive_avg_pool2d)."""
    return call('adaptive_avg_pool2d', x, out_hw=out_hw, fmt=fmt)


def adaptive_max_pool2d(x, *, out_hw, fmt, name=None):
    """Generated from ops.yaml (op: adaptive_max_pool2d)."""
    return call('adaptive_max_pool2d', x, out_hw=out_hw, fmt=fmt)


def avg_pool_nd(x, *, ksize, stride, padding, ceil_mode, fmt, exclusive, divisor, name=None):
    """Generated from ops.yaml (op: avg_pool_nd)."""
    return call('avg_pool_nd', x, ksize=ksize, stride=stride, padding=padding, ceil_mode=ceil_mode, fmt=fmt, exclusive=exclusive, divisor=divisor)


def max_pool_nd(x, *, ksize, stride, padding, ceil_mode, fmt, with_index, name=None):
    """Generated from ops.yaml (op: max_pool_nd)."""
    return call('max_pool_nd', x, ksize=ksize, stride=stride, padding=padding, ceil_mode=ceil_mode, fmt=fmt, with_index=with_index)


def max_pool_nd_index(*a, name=None):
    """Generated from ops.yaml (op: max_pool_nd_index)."""
    return call('max_pool_nd_index', *a)


def max_unpool2d(x, indices, *, out_h, out_w, name=None):
    """Generated from ops.yaml (op: max_unpool2d)."""
    return call('max_unpool2d', x, indices, out_h=out_h, out_w=out_w)


def abs(x, name=None):
    """Generated from ops.yaml (op: abs)."""
    return call('abs', x)


def acos(x, name=None):
    """Generated from ops.yaml (op: acos)."""
    return call('acos', x)


def acosh(x, name=None):
    """Generated from ops.yaml (op: acosh)."""
    return call('acosh', x)


def add(x, y, name=None):
    """Generated from ops.yaml (op: add)."""
    return call('add', x, y)


def angle(x, name=None):
    """Generated from ops.yaml (op: angle)."""
    return call('angle', x)


def asin(x, name=None):
    """Generated from ops.yaml (op: asin)."""
    return call('asin', x)


def asinh(x, name=None):
    """Generated from ops.yaml (op: asinh)."""
    return call('asinh', x)


def atan(x, name=None):
    """Generated from ops.yaml (op: atan)."""
    return call('atan', x)


def atan2(x, y, name=None):
    """Generated from ops.yaml (op: atan2)."""
    return call('atan2', x, y)


def atanh(x, name=None):
    """Generated from ops.yaml (op: atanh)."""
    return call('atanh', x)


def bitwise_and(x, y, name=None):
    """Generated from ops.yaml (op: bitwise_and)."""
    return call('bitwise_and', x, y)


def bitwise_left_shift(x, y, name=None):
    """Generated from ops.yaml (op: bitwise_left_shift)."""
    return call('bitwise_left_shift', x, y)


def bitwise_not(x, name=None):
    """Generated from ops.yaml (op: bitwise_not)."""
    return call('bitwise_not', x)


def bitwise_or(x, y, name=None):
    """Generated from ops.yaml (op: bitwise_or)."""
    return call('bitwise_or', x, y)


def bitwise_right_shift(x, y, name=None):
    """Generated from ops.yaml (op: bitwise_right_shift)."""
    return call('bitwise_right_shift', x, y)


def bitwise_xor(x, y, name=None):
    """Generated from ops.yaml (op: bitwise_xor)."""
    return call('bitwise_xor', x, y)


def ceil(x, name=None):
    """Generated from ops.yaml (op: ceil)."""
    return call('ceil', x)


def conj(x, name=None):
    """Generated from ops.yaml (op: conj)."""
    return call('conj', x)


def copysign(x, y, name=None):
    """Generated from ops.yaml (op: copysign)."""
    return call('copysign', x, y)


def cos(x, name=None):
    """Generated from ops.yaml (op: cos)."""
    return call('cos', x)


def cosh(x, name=None):
    """Generated from ops.yaml (op: cosh)."""
    return call('cosh', x)


def digamma(x, name=None):
    """Generated from ops.yaml (op: digamma)."""
    return call('digamma', x)


def divide(x, y, name=None):
    """Generated from ops.yaml (op: divide)."""
    return call('divide', x, y)


def equal(x, y, name=None):
    """Generated from ops.yaml (op: equal)."""
    return call('equal', x, y)


def erf(x, name=None):
    """Generated from ops.yaml (op: erf)."""
    return call('erf', x)


def erfinv(x, name=None):
    """Generated from ops.yaml (op: erfinv)."""
    return call('erfinv', x)


def exp(x, name=None):
    """Generated from ops.yaml (op: exp)."""
    return call('exp', x)


def expm1(x, name=None):
    """Generated from ops.yaml (op: expm1)."""
    return call('expm1', x)


def floor(x, name=None):
    """Generated from ops.yaml (op: floor)."""
    return call('floor', x)


def floor_divide(x, y, name=None):
    """Generated from ops.yaml (op: floor_divide)."""
    return call('floor_divide', x, y)


def fmax(x, y, name=None):
    """Generated from ops.yaml (op: fmax)."""
    return call('fmax', x, y)


def fmin(x, y, name=None):
    """Generated from ops.yaml (op: fmin)."""
    return call('fmin', x, y)


def frac(x, name=None):
    """Generated from ops.yaml (op: frac)."""
    return call('frac', x)


def gammaln(x, name=None):
    """Generated from ops.yaml (op: gammaln)."""
    return call('gammaln', x)


def gcd(x, y, name=None):
    """Generated from ops.yaml (op: gcd)."""
    return call('gcd', x, y)


def greater_equal(x, y, name=None):
    """Generated from ops.yaml (op: greater_equal)."""
    return call('greater_equal', x, y)


def greater_than(x, y, name=None):
    """Generated from ops.yaml (op: greater_than)."""
    return call('greater_than', x, y)


def hardsigmoid(x, name=None):
    """Generated from ops.yaml (op: hardsigmoid)."""
    return call('hardsigmoid', x)


def hardswish(x, name=None):
    """Generated from ops.yaml (op: hardswish)."""
    return call('hardswish', x)


def heaviside(x, y, name=None):
    """Generated from ops.yaml (op: heaviside)."""
    return call('heaviside', x, y)


def hypot(x, y, name=None):
    """Generated from ops.yaml (op: hypot)."""
    return call('hypot', x, y)


def i0(x, name=None):
    """Generated from ops.yaml (op: i0)."""
    return call('i0', x)


def i0e(x, name=None):
    """Generated from ops.yaml (op: i0e)."""
    return call('i0e', x)


def i1(x, name=None):
    """Generated from ops.yaml (op: i1)."""
    return call('i1', x)


def i1e(x, name=None):
    """Generated from ops.yaml (op: i1e)."""
    return call('i1e', x)


def imag(x, name=None):
    """Generated from ops.yaml (op: imag)."""
    return call('imag', x)


def isfinite(x, name=None):
    """Generated from ops.yaml (op: isfinite)."""
    return call('isfinite', x)


def isinf(x, name=None):
    """Generated from ops.yaml (op: isinf)."""
    return call('isinf', x)


def isnan(x, name=None):
    """Generated from ops.yaml (op: isnan)."""
    return call('isnan', x)


def kron(x, y, name=None):
    """Generated from ops.yaml (op: kron)."""
    return call('kron', x, y)


def lcm(x, y, name=None):
    """Generated from ops.yaml (op: lcm)."""
    return call('lcm', x, y)


def ldexp(x, y, name=None):
    """Generated from ops.yaml (op: ldexp)."""
    return call('ldexp', x, y)


def less_equal(x, y, name=None):
    """Generated from ops.yaml (op: less_equal)."""
    return call('less_equal', x, y)


def less_than(x, y, name=None):
    """Generated from ops.yaml (op: less_than)."""
    return call('less_than', x, y)


def lgamma(x, name=None):
    """Generated from ops.yaml (op: lgamma)."""
    return call('lgamma', x)


def log(x, name=None):
    """Generated from ops.yaml (op: log)."""
    return call('log', x)


def log10(x, name=None):
    """Generated from ops.yaml (op: log10)."""
    return call('log10', x)


def log1p(x, name=None):
    """Generated from ops.yaml (op: log1p)."""
    return call('log1p', x)


def log2(x, name=None):
    """Generated from ops.yaml (op: log2)."""
    return call('log2', x)


def logaddexp(x, y, name=None):
    """Generated from ops.yaml (op: logaddexp)."""
    return call('logaddexp', x, y)


def logical_and(x, y, name=None):
    """Generated from ops.yaml (op: logical_and)."""
    return call('logical_and', x, y)


def logical_not(x, name=None):
    """Generated from ops.yaml (op: logical_not)."""
    return call('logical_not', x)


def logical_or(x, y, name=None):
    """Generated from ops.yaml (op: logical_or)."""
    return call('logical_or', x, y)


def logical_xor(x, y, name=None):
    """Generated from ops.yaml (op: logical_xor)."""
    return call('logical_xor', x, y)


def logit(x, name=None):
    """Generated from ops.yaml (op: logit)."""
    return call('logit', x)


def maximum(x, y, name=None):
    """Generated from ops.yaml (op: maximum)."""
    return call('maximum', x, y)


def minimum(x, y, name=None):
    """Generated from ops.yaml (op: minimum)."""
    return call('minimum', x, y)


def mish(x, name=None):
    """Generated from ops.yaml (op: mish)."""
    return call('mish', x)


def mod(x, y, name=None):
    """Generated from ops.yaml (op: mod)."""
    return call('mod', x, y)


def multiply(x, y, name=None):
    """Generated from ops.yaml (op: multiply)."""
    return call('multiply', x, y)


def neg(x, name=None):
    """Generated from ops.yaml (op: neg)."""
    return call('neg', x)


def nextafter(x, y, name=None):
    """Generated from ops.yaml (op: nextafter)."""
    return call('nextafter', x, y)


def not_equal(x, y, name=None):
    """Generated from ops.yaml (op: not_equal)."""
    return call('not_equal', x, y)


def polar(x, y, name=None):
    """Generated from ops.yaml (op: polar)."""
    return call('polar', x, y)


def pow(x, y, name=None):
    """Generated from ops.yaml (op: pow)."""
    return call('pow', x, y)


def real(x, name=None):
    """Generated from ops.yaml (op: real)."""
    return call('real', x)


def reciprocal(x, name=None):
    """Generated from ops.yaml (op: reciprocal)."""
    return call('reciprocal', x)


def relu(x, name=None):
    """Generated from ops.yaml (op: relu)."""
    return call('relu', x)


def relu6(x, name=None):
    """Generated from ops.yaml (op: relu6)."""
    return call('relu6', x)


def round(x, name=None):
    """Generated from ops.yaml (op: round)."""
    return call('round', x)


def rsqrt(x, name=None):
    """Generated from ops.yaml (op: rsqrt)."""
    return call('rsqrt', x)


def sigmoid(x, name=None):
    """Generated from ops.yaml (op: sigmoid)."""
    return call('sigmoid', x)


def sigmoid_f(x, name=None):
    """Generated from ops.yaml (op: sigmoid_f)."""
    return call('sigmoid_f', x)


def sign(x, name=None):
    """Generated from ops.yaml (op: sign)."""
    return call('sign', x)


def silu(x, name=None):
    """Generated from ops.yaml (op: silu)."""
    return call('silu', x)


def sin(x, name=None):
    """Generated from ops.yaml (op: sin)."""
    return call('sin', x)


def sinh(x, name=None):
    """Generated from ops.yaml (op: sinh)."""
    return call('sinh', x)


def softsign(x, name=None):
    """Generated from ops.yaml (op: softsign)."""
    return call('softsign', x)


def sqrt(x, name=None):
    """Generated from ops.yaml (op: sqrt)."""
    return call('sqrt', x)


def square(x, name=None):
    """Generated from ops.yaml (op: square)."""
    return call('square', x)


def subtract(x, y, name=None):
    """Generated from ops.yaml (op: subtract)."""
    return call('subtract', x, y)


def tan(x, name=None):
    """Generated from ops.yaml (op: tan)."""
    return call('tan', x)


def tanh(x, name=None):
    """Generated from ops.yaml (op: tanh)."""
    return call('tanh', x)


def tanh_f(x, name=None):
    """Generated from ops.yaml (op: tanh_f)."""
    return call('tanh_f', x)


def tanhshrink(x, name=None):
    """Generated from ops.yaml (op: tanhshrink)."""
    return call('tanhshrink', x)


def trunc(x, name=None):
    """Generated from ops.yaml (op: trunc)."""
    return call('trunc', x)


def assign(x, name=None):
    """Generated from ops.yaml (op: assign)."""
    return call('assign', x)


def complex_make(r, i, name=None):
    """Generated from ops.yaml (op: complex_make)."""
    return call('complex_make', r, i)


def diag_(x, *, offset, padding_value, name=None):
    """Generated from ops.yaml (op: diag_)."""
    return call('diag_', x, offset=offset, padding_value=padding_value)


def diagflat_(x, *, offset, name=None):
    """Generated from ops.yaml (op: diagflat_)."""
    return call('diagflat_', x, offset=offset)


def bincount(x, weights=None, *, length=1, name=None):
    """Generated from ops.yaml (op: bincount)."""
    return call('bincount', x, weights, length=length)


def diff(x, *, n=1, axis=-1, name=None):
    """Generated from ops.yaml (op: diff)."""
    return call('diff', x, n=n, axis=axis)


def frexp(x, name=None):
    """Generated from ops.yaml (op: frexp)."""
    return call('frexp', x)


def histogram_op(x, *, bins=100, min=0.0, max=0.0, name=None):
    """Generated from ops.yaml (op: histogram_op)."""
    return call('histogram_op', x, bins=bins, min=min, max=max)


def nanmedian(x, *, axis=None, keepdim=False, name=None):
    """Generated from ops.yaml (op: nanmedian)."""
    return call('nanmedian', x, axis=axis, keepdim=keepdim)


def renorm_op(x, *, p=2.0, axis=0, max_norm=1.0, name=None):
    """Generated from ops.yaml (op: renorm_op)."""
    return call('renorm_op', x, p=p, axis=axis, max_norm=max_norm)


def rot90(x, *, k=1, axes=(0, 1), name=None):
    """Generated from ops.yaml (op: rot90)."""
    return call('rot90', x, k=k, axes=axes)


def select_scatter_op(x, values, *, axis=0, index=0, name=None):
    """Generated from ops.yaml (op: select_scatter_op)."""
    return call('select_scatter_op', x, values, axis=axis, index=index)


def take_op(x, index, *, mode='raise', name=None):
    """Generated from ops.yaml (op: take_op)."""
    return call('take_op', x, index, mode=mode)


def tensordot_op(x, y, *, axes=2, name=None):
    """Generated from ops.yaml (op: tensordot_op)."""
    return call('tensordot_op', x, y, axes=axes)


def trapezoid(y, *, x=None, dx=1.0, axis=-1, name=None):
    """Generated from ops.yaml (op: trapezoid)."""
    return call('trapezoid', y, x=x, dx=dx, axis=axis)


def unfold_op(x, *, axis=0, size=1, step=1, name=None):
    """Generated from ops.yaml (op: unfold_op)."""
    return call('unfold_op', x, axis=axis, size=size, step=step)


def vander(x, *, n=None, increasing=False, name=None):
    """Generated from ops.yaml (op: vander)."""
    return call('vander', x, n=n, increasing=increasing)


def getitem_(x, *tvals, spec, name=None):
    """Generated from ops.yaml (op: getitem_)."""
    return call('getitem_', x, *tvals, spec=spec)


def setitem_(x, v, *tvals, spec, name=None):
    """Generated from ops.yaml (op: setitem_)."""
    return call('setitem_', x, v, *tvals, spec=spec)


def cholesky_(x, *, upper, name=None):
    """Generated from ops.yaml (op: cholesky_)."""
    return call('cholesky_', x, upper=upper)


def cross_(x, y, *, axis, name=None):
    """Generated from ops.yaml (op: cross_)."""
    return call('cross_', x, y, axis=axis)


def dot_(x, y, name=None):
    """Generated from ops.yaml (op: dot_)."""
    return call('dot_', x, y)


def eigh_(x, *, UPLO, name=None):
    """Generated from ops.yaml (op: eigh_)."""
    return call('eigh_', x, UPLO=UPLO)


def einsum_(*xs, equation, name=None):
    """Generated from ops.yaml (op: einsum_)."""
    return call('einsum_', *xs, equation=equation)


def matrix_power_(x, *, n, name=None):
    """Generated from ops.yaml (op: matrix_power_)."""
    return call('matrix_power_', x, n=n)


def outer_(x, y, name=None):
    """Generated from ops.yaml (op: outer_)."""
    return call('outer_', x, y)


def p_norm_(x, *, p, axis, keepdim, name=None):
    """Generated from ops.yaml (op: p_norm_)."""
    return call('p_norm_', x, p=p, axis=axis, keepdim=keepdim)


def pinv_(x, *, rcond, name=None):
    """Generated from ops.yaml (op: pinv_)."""
    return call('pinv_', x, rcond=rcond)


def qr_(x, *, mode, name=None):
    """Generated from ops.yaml (op: qr_)."""
    return call('qr_', x, mode=mode)


def slogdet_(x, name=None):
    """Generated from ops.yaml (op: slogdet_)."""
    return call('slogdet_', x)


def svd_(x, *, full_matrices, name=None):
    """Generated from ops.yaml (op: svd_)."""
    return call('svd_', x, full_matrices=full_matrices)


def trace_(x, *, offset, axis1, axis2, name=None):
    """Generated from ops.yaml (op: trace_)."""
    return call('trace_', x, offset=offset, axis1=axis1, axis2=axis2)


def triangular_solve_(x, y, *, upper, transpose, unitriangular, name=None):
    """Generated from ops.yaml (op: triangular_solve_)."""
    return call('triangular_solve_', x, y, upper=upper, transpose=transpose, unitriangular=unitriangular)


def as_complex(x, name=None):
    """Generated from ops.yaml (op: as_complex)."""
    return call('as_complex', x)


def as_real(x, name=None):
    """Generated from ops.yaml (op: as_real)."""
    return call('as_real', x)


def concat_(*xs, axis, name=None):
    """Generated from ops.yaml (op: concat_)."""
    return call('concat_', *xs, axis=axis)


def diagonal_(x, *, offset, axis1, axis2, name=None):
    """Generated from ops.yaml (op: diagonal_)."""
    return call('diagonal_', x, offset=offset, axis1=axis1, axis2=axis2)


def expand(x, *, shape, name=None):
    """Generated from ops.yaml (op: expand)."""
    return call('expand', x, shape=shape)


def flatten_(x, *, start, stop, name=None):
    """Generated from ops.yaml (op: flatten_)."""
    return call('flatten_', x, start=start, stop=stop)


def masked_fill_(x, mask, v, name=None):
    """Generated from ops.yaml (op: masked_fill_)."""
    return call('masked_fill_', x, mask, v)


def moveaxis_(x, *, src, dst, name=None):
    """Generated from ops.yaml (op: moveaxis_)."""
    return call('moveaxis_', x, src=src, dst=dst)


def pad_(x, *, pad_width, mode, value, name=None):
    """Generated from ops.yaml (op: pad_)."""
    return call('pad_', x, pad_width=pad_width, mode=mode, value=value)


def repeat_interleave_(x, *, repeats, axis, name=None):
    """Generated from ops.yaml (op: repeat_interleave_)."""
    return call('repeat_interleave_', x, repeats=repeats, axis=axis)


def roll_(x, *, shifts, axes, name=None):
    """Generated from ops.yaml (op: roll_)."""
    return call('roll_', x, shifts=shifts, axes=axes)


def split_(x, *, indices, axis, name=None):
    """Generated from ops.yaml (op: split_)."""
    return call('split_', x, indices=indices, axis=axis)


def squeeze(x, *, axes, name=None):
    """Generated from ops.yaml (op: squeeze)."""
    return call('squeeze', x, axes=axes)


def stack_(*xs, axis, name=None):
    """Generated from ops.yaml (op: stack_)."""
    return call('stack_', *xs, axis=axis)


def unbind_(x, *, axis, name=None):
    """Generated from ops.yaml (op: unbind_)."""
    return call('unbind_', x, axis=axis)


def unsqueeze(x, *, axes, name=None):
    """Generated from ops.yaml (op: unsqueeze)."""
    return call('unsqueeze', x, axes=axes)


def cumprod_(x, *, axis, name=None):
    """Generated from ops.yaml (op: cumprod_)."""
    return call('cumprod_', x, axis=axis)


def cumsum_(x, *, axis, reverse, dtype, name=None):
    """Generated from ops.yaml (op: cumsum_)."""
    return call('cumsum_', x, axis=axis, reverse=reverse, dtype=dtype)


def lerp(x, y, w, name=None):
    """Generated from ops.yaml (op: lerp)."""
    return call('lerp', x, y, w)


def logcumsumexp_(x, *, axis, name=None):
    """Generated from ops.yaml (op: logcumsumexp_)."""
    return call('logcumsumexp_', x, axis=axis)


def nan_to_num(x, *, nan, posinf, neginf, name=None):
    """Generated from ops.yaml (op: nan_to_num)."""
    return call('nan_to_num', x, nan=nan, posinf=posinf, neginf=neginf)


def rsqrt_grad_friendly(x, name=None):
    """Generated from ops.yaml (op: rsqrt_grad_friendly)."""
    return call('rsqrt_grad_friendly', x)


def stanh(x, *, scale_a, scale_b, name=None):
    """Generated from ops.yaml (op: stanh)."""
    return call('stanh', x, scale_a=scale_a, scale_b=scale_b)


def addmm_(inp, x, y, *, beta, alpha, name=None):
    """Generated from ops.yaml (op: addmm_)."""
    return call('addmm_', inp, x, y, beta=beta, alpha=alpha)


def baddbmm_(inp, x, y, *, beta, alpha, name=None):
    """Generated from ops.yaml (op: baddbmm_)."""
    return call('baddbmm_', inp, x, y, beta=beta, alpha=alpha)


def cholesky_solve_(x, y, *, upper, name=None):
    """Generated from ops.yaml (op: cholesky_solve_)."""
    return call('cholesky_solve_', x, y, upper=upper)


def clip_by_norm_(x, *, max_norm, name=None):
    """Generated from ops.yaml (op: clip_by_norm_)."""
    return call('clip_by_norm_', x, max_norm=max_norm)


def crop_(x, *, offsets, shape, name=None):
    """Generated from ops.yaml (op: crop_)."""
    return call('crop_', x, offsets=offsets, shape=shape)


def cummax_(x, *, axis, name=None):
    """Generated from ops.yaml (op: cummax_)."""
    return call('cummax_', x, axis=axis)


def cummin_(x, *, axis, name=None):
    """Generated from ops.yaml (op: cummin_)."""
    return call('cummin_', x, axis=axis)


def diag_embed_(x, *, offset, dim1, dim2, name=None):
    """Generated from ops.yaml (op: diag_embed_)."""
    return call('diag_embed_', x, offset=offset, dim1=dim1, dim2=dim2)


def dist_(x, y, *, p, name=None):
    """Generated from ops.yaml (op: dist_)."""
    return call('dist_', x, y, p=p)


def fill_diagonal_(x, *, value, offset, wrap, name=None):
    """Generated from ops.yaml (op: fill_diagonal_)."""
    return call('fill_diagonal_', x, value=value, offset=offset, wrap=wrap)


def householder_product_(x, tau, name=None):
    """Generated from ops.yaml (op: householder_product_)."""
    return call('householder_product_', x, tau)


def l1_norm_(x, name=None):
    """Generated from ops.yaml (op: l1_norm_)."""
    return call('l1_norm_', x)


def multiplex_(index, *ins, name=None):
    """Generated from ops.yaml (op: multiplex_)."""
    return call('multiplex_', index, *ins)


def polygamma_(x, *, n, name=None):
    """Generated from ops.yaml (op: polygamma_)."""
    return call('polygamma_', x, n=n)


def reduce_as_(x, *, tshape, name=None):
    """Generated from ops.yaml (op: reduce_as_)."""
    return call('reduce_as_', x, tshape=tshape)


def squared_l2_norm_(x, name=None):
    """Generated from ops.yaml (op: squared_l2_norm_)."""
    return call('squared_l2_norm_', x)


def strided_slice_(x, *, spec, name=None):
    """Generated from ops.yaml (op: strided_slice_)."""
    return call('strided_slice_', x, spec=spec)


def svdvals_(x, name=None):
    """Generated from ops.yaml (op: svdvals_)."""
    return call('svdvals_', x)


def all(x, *, axis, keepdim, name=None):
    """Generated from ops.yaml (op: all)."""
    return call('all', x, axis=axis, keepdim=keepdim)


def amax(x, *, axis, keepdim, name=None):
    """Generated from ops.yaml (op: amax)."""
    return call('amax', x, axis=axis, keepdim=keepdim)


def amin(x, *, axis, keepdim, name=None):
    """Generated from ops.yaml (op: amin)."""
    return call('amin', x, axis=axis, keepdim=keepdim)


def any(x, *, axis, keepdim, name=None):
    """Generated from ops.yaml (op: any)."""
    return call('any', x, axis=axis, keepdim=keepdim)


def count_nonzero_(x, *, axis, keepdim, name=None):
    """Generated from ops.yaml (op: count_nonzero_)."""
    return call('count_nonzero_', x, axis=axis, keepdim=keepdim)


def logsumexp(x, *, axis, keepdim, name=None):
    """Generated from ops.yaml (op: logsumexp)."""
    return call('logsumexp', x, axis=axis, keepdim=keepdim)


def max(x, *, axis, keepdim, name=None):
    """Generated from ops.yaml (op: max)."""
    return call('max', x, axis=axis, keepdim=keepdim)


def mean(x, *, axis, keepdim, name=None):
    """Generated from ops.yaml (op: mean)."""
    return call('mean', x, axis=axis, keepdim=keepdim)


def median_(x, *, axis, keepdim, name=None):
    """Generated from ops.yaml (op: median_)."""
    return call('median_', x, axis=axis, keepdim=keepdim)


def min(x, *, axis, keepdim, name=None):
    """Generated from ops.yaml (op: min)."""
    return call('min', x, axis=axis, keepdim=keepdim)


def nanmean(x, *, axis, keepdim, name=None):
    """Generated from ops.yaml (op: nanmean)."""
    return call('nanmean', x, axis=axis, keepdim=keepdim)


def nansum(x, *, axis, keepdim, name=None):
    """Generated from ops.yaml (op: nansum)."""
    return call('nansum', x, axis=axis, keepdim=keepdim)


def prod(x, *, axis, keepdim, name=None):
    """Generated from ops.yaml (op: prod)."""
    return call('prod', x, axis=axis, keepdim=keepdim)


def quantile_(x, *, q, axis, keepdim, name=None):
    """Generated from ops.yaml (op: quantile_)."""
    return call('quantile_', x, q=q, axis=axis, keepdim=keepdim)


def std_(x, *, axis, keepdim, ddof, name=None):
    """Generated from ops.yaml (op: std_)."""
    return call('std_', x, axis=axis, keepdim=keepdim, ddof=ddof)


def sum_(x, *, axis, keepdim, name=None):
    """Generated from ops.yaml (op: sum_)."""
    return call('sum_', x, axis=axis, keepdim=keepdim)


def var_(x, *, axis, keepdim, ddof, name=None):
    """Generated from ops.yaml (op: var_)."""
    return call('var_', x, axis=axis, keepdim=keepdim, ddof=ddof)


def arg_topk_(x, *, k, axis, largest, name=None):
    """Generated from ops.yaml (op: arg_topk_)."""
    return call('arg_topk_', x, k=k, axis=axis, largest=largest)


def argmax_(x, *, axis, keepdim, dtype, name=None):
    """Generated from ops.yaml (op: argmax_)."""
    return call('argmax_', x, axis=axis, keepdim=keepdim, dtype=dtype)


def argmin_(x, *, axis, keepdim, dtype, name=None):
    """Generated from ops.yaml (op: argmin_)."""
    return call('argmin_', x, axis=axis, keepdim=keepdim, dtype=dtype)


def argsort_(x, *, axis, descending, name=None):
    """Generated from ops.yaml (op: argsort_)."""
    return call('argsort_', x, axis=axis, descending=descending)


def gather_(x, idx, *, axis, name=None):
    """Generated from ops.yaml (op: gather_)."""
    return call('gather_', x, idx, axis=axis)


def gather_nd_(x, index, name=None):
    """Generated from ops.yaml (op: gather_nd_)."""
    return call('gather_nd_', x, index)


def index_add_(x, index, value, *, axis, name=None):
    """Generated from ops.yaml (op: index_add_)."""
    return call('index_add_', x, index, value, axis=axis)


def index_put_(x, v, *idx, accumulate, name=None):
    """Generated from ops.yaml (op: index_put_)."""
    return call('index_put_', x, v, *idx, accumulate=accumulate)


def index_sample_(x, index, name=None):
    """Generated from ops.yaml (op: index_sample_)."""
    return call('index_sample_', x, index)


def index_select_(x, idx, *, axis, name=None):
    """Generated from ops.yaml (op: index_select_)."""
    return call('index_select_', x, idx, axis=axis)


def put_along_axis_(x, idx, v, *, axis, reduce, name=None):
    """Generated from ops.yaml (op: put_along_axis_)."""
    return call('put_along_axis_', x, idx, v, axis=axis, reduce=reduce)


def scatter_(x, index, updates, *, overwrite, name=None):
    """Generated from ops.yaml (op: scatter_)."""
    return call('scatter_', x, index, updates, overwrite=overwrite)


def scatter_nd_add_(x, index, updates, name=None):
    """Generated from ops.yaml (op: scatter_nd_add_)."""
    return call('scatter_nd_add_', x, index, updates)


def searchsorted_(a, v, *, right, name=None):
    """Generated from ops.yaml (op: searchsorted_)."""
    return call('searchsorted_', a, v, right=right)


def take_along_axis_(x, idx, *, axis, name=None):
    """Generated from ops.yaml (op: take_along_axis_)."""
    return call('take_along_axis_', x, idx, axis=axis)


def where_(c, x, y, name=None):
    """Generated from ops.yaml (op: where_)."""
    return call('where_', c, x, y)


def box_coder(prior_box, prior_var, target_box, *, code_type, box_normalized, name=None):
    """Generated from ops.yaml (op: box_coder)."""
    return call('box_coder', prior_box, prior_var, target_box, code_type=code_type, box_normalized=box_normalized)


def nms_mask(boxes, scores, *, iou_threshold, name=None):
    """Generated from ops.yaml (op: nms_mask)."""
    return call('nms_mask', boxes, scores, iou_threshold=iou_threshold)


def roi_pool(x, boxes, boxes_num, *, pooled_height, pooled_width, spatial_scale, name=None):
    """Generated from ops.yaml (op: roi_pool)."""
    return call('roi_pool', x, boxes, boxes_num, pooled_height=pooled_height, pooled_width=pooled_width, spatial_scale=spatial_scale)


def yolo_box(x, img_size, *, anchors, class_num, conf_thresh, downsample_ratio, clip_bbox, scale_x_y, name=None):
    """Generated from ops.yaml (op: yolo_box)."""
    return call('yolo_box', x, img_size, anchors=anchors, class_num=class_num, conf_thresh=conf_thresh, downsample_ratio=downsample_ratio, clip_bbox=clip_bbox, scale_x_y=scale_x_y)


def conv3d(x, w, b=None, *, stride, padding, dilation, groups, name=None):
    """Generated from ops.yaml (op: conv3d)."""
    return call('conv3d', x, w, b, stride=stride, padding=padding, dilation=dilation, groups=groups)


def accuracy_k(pred_idx, label, name=None):
    """Generated from ops.yaml (op: accuracy_k)."""
    return call('accuracy_k', pred_idx, label)


def allclose_k(x, y, *, rtol, atol, equal_nan, name=None):
    """Generated from ops.yaml (op: allclose_k)."""
    return call('allclose_k', x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)


def as_strided(x, *, shape, stride, offset, name=None):
    """Generated from ops.yaml (op: as_strided)."""
    return call('as_strided', x, shape=shape, stride=stride, offset=offset)


def auc_k(pred, label, *, num_thresholds, name=None):
    """Generated from ops.yaml (op: auc_k)."""
    return call('auc_k', pred, label, num_thresholds=num_thresholds)


def bernoulli_k(x, key, name=None):
    """Generated from ops.yaml (op: bernoulli_k)."""
    return call('bernoulli_k', x, key)


def bicubic_interp(x, *, size, name=None):
    """Generated from ops.yaml (op: bicubic_interp)."""
    return call('bicubic_interp', x, size=size)


def bilinear_interp(x, *, size, name=None):
    """Generated from ops.yaml (op: bilinear_interp)."""
    return call('bilinear_interp', x, size=size)


def bmm_k(x, y, name=None):
    """Generated from ops.yaml (op: bmm_k)."""
    return call('bmm_k', x, y)


def box_clip_k(boxes, im_hw, name=None):
    """Generated from ops.yaml (op: box_clip_k)."""
    return call('box_clip_k', boxes, im_hw)


def edit_distance_k(a, b, a_len, b_len, name=None):
    """Generated from ops.yaml (op: edit_distance_k)."""
    return call('edit_distance_k', a, b, a_len, b_len)


def eigvalsh_k(x, name=None):
    """Generated from ops.yaml (op: eigvalsh_k)."""
    return call('eigvalsh_k', x)


def equal_all_k(x, y, name=None):
    """Generated from ops.yaml (op: equal_all_k)."""
    return call('equal_all_k', x, y)


def eye_k(*, n, m, dtype, name=None):
    """Generated from ops.yaml (op: eye_k)."""
    return call('eye_k', n=n, m=m, dtype=dtype)


def fill_diagonal_tensor(x, y, *, offset, dim1, dim2, name=None):
    """Generated from ops.yaml (op: fill_diagonal_tensor)."""
    return call('fill_diagonal_tensor', x, y, offset=offset, dim1=dim1, dim2=dim2)


def frobenius_norm_k(x, *, axis, keepdim, name=None):
    """Generated from ops.yaml (op: frobenius_norm_k)."""
    return call('frobenius_norm_k', x, axis=axis, keepdim=keepdim)


def full_k(*, shape, value, dtype, name=None):
    """Generated from ops.yaml (op: full_k)."""
    return call('full_k', shape=shape, value=value, dtype=dtype)


def full_like_k(x, *, value, name=None):
    """Generated from ops.yaml (op: full_like_k)."""
    return call('full_like_k', x, value=value)


def fused_bias_act(x, b, *, act, name=None):
    """Generated from ops.yaml (op: fused_bias_act)."""
    return call('fused_bias_act', x, b, act=act)


def fused_bias_dropout_residual_layer_norm(x, residual, bias, w, b, key, *, p, training, eps, name=None):
    """Generated from ops.yaml (op: fused_bias_dropout_residual_layer_norm)."""
    return call('fused_bias_dropout_residual_layer_norm', x, residual, bias, w, b, key, p=p, training=training, eps=eps)


def fused_dropout_add(x, y, key, *, p, training, name=None):
    """Generated from ops.yaml (op: fused_dropout_add)."""
    return call('fused_dropout_add', x, y, key, p=p, training=training)


def fused_elementwise_add(x, y, *, scale, name=None):
    """Generated from ops.yaml (op: fused_elementwise_add)."""
    return call('fused_elementwise_add', x, y, scale=scale)


def fused_elementwise_div(x, y, *, scale, name=None):
    """Generated from ops.yaml (op: fused_elementwise_div)."""
    return call('fused_elementwise_div', x, y, scale=scale)


def fused_elementwise_mul(x, y, *, scale, name=None):
    """Generated from ops.yaml (op: fused_elementwise_mul)."""
    return call('fused_elementwise_mul', x, y, scale=scale)


def fused_elementwise_sub(x, y, *, scale, name=None):
    """Generated from ops.yaml (op: fused_elementwise_sub)."""
    return call('fused_elementwise_sub', x, y, scale=scale)


def fused_gemm_epilogue(x, y, b, *, act, name=None):
    """Generated from ops.yaml (op: fused_gemm_epilogue)."""
    return call('fused_gemm_epilogue', x, y, b, act=act)


def fused_linear_param_grad_add(x, dout, dw_acc, db_acc, *, has_bias, name=None):
    """Generated from ops.yaml (op: fused_linear_param_grad_add)."""
    return call('fused_linear_param_grad_add', x, dout, dw_acc, db_acc, has_bias=has_bias)


def fused_softmax_mask(x, mask, name=None):
    """Generated from ops.yaml (op: fused_softmax_mask)."""
    return call('fused_softmax_mask', x, mask)


def fused_softmax_mask_upper_triangle(x, name=None):
    """Generated from ops.yaml (op: fused_softmax_mask_upper_triangle)."""
    return call('fused_softmax_mask_upper_triangle', x)


def gaussian_k(key, *, shape, mean, std, name=None):
    """Generated from ops.yaml (op: gaussian_k)."""
    return call('gaussian_k', key, shape=shape, mean=mean, std=std)


def gru_unit_k(x, h, wu, wr, wc, name=None):
    """Generated from ops.yaml (op: gru_unit_k)."""
    return call('gru_unit_k', x, h, wu, wr, wc)


def gumbel_softmax_k(x, key, *, tau, hard, axis, name=None):
    """Generated from ops.yaml (op: gumbel_softmax_k)."""
    return call('gumbel_softmax_k', x, key, tau=tau, hard=hard, axis=axis)


def increment_k(x, *, value, name=None):
    """Generated from ops.yaml (op: increment_k)."""
    return call('increment_k', x, value=value)


def index_select_strided(x, index, *, axis, name=None):
    """Generated from ops.yaml (op: index_select_strided)."""
    return call('index_select_strided', x, index, axis=axis)


def isclose_k(x, y, *, rtol, atol, equal_nan, name=None):
    """Generated from ops.yaml (op: isclose_k)."""
    return call('isclose_k', x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)


def kldiv_pointwise_k(x, target, name=None):
    """Generated from ops.yaml (op: kldiv_pointwise_k)."""
    return call('kldiv_pointwise_k', x, target)


def kthvalue_k(x, *, k, axis, keepdim, name=None):
    """Generated from ops.yaml (op: kthvalue_k)."""
    return call('kthvalue_k', x, k=k, axis=axis, keepdim=keepdim)


def label_smooth_k(x, prior=None, *, epsilon, name=None):
    """Generated from ops.yaml (op: label_smooth_k)."""
    return call('label_smooth_k', x, prior, epsilon=epsilon)


def limit_by_capacity_k(expert_count, capacity, *, n_worker, name=None):
    """Generated from ops.yaml (op: limit_by_capacity_k)."""
    return call('limit_by_capacity_k', expert_count, capacity, n_worker=n_worker)


def linear_interp(x, *, size, name=None):
    """Generated from ops.yaml (op: linear_interp)."""
    return call('linear_interp', x, size=size)


def linspace_k(*, start, stop, num, dtype, name=None):
    """Generated from ops.yaml (op: linspace_k)."""
    return call('linspace_k', start=start, stop=stop, num=num, dtype=dtype)


def logspace_k(*, start, stop, num, base, dtype, name=None):
    """Generated from ops.yaml (op: logspace_k)."""
    return call('logspace_k', start=start, stop=stop, num=num, base=base, dtype=dtype)


def mode_k(x, name=None):
    """Generated from ops.yaml (op: mode_k)."""
    return call('mode_k', x)


def multinomial_k(x, key, *, num, replacement, name=None):
    """Generated from ops.yaml (op: multinomial_k)."""
    return call('multinomial_k', x, key, num=num, replacement=replacement)


def mv_k(x, v, name=None):
    """Generated from ops.yaml (op: mv_k)."""
    return call('mv_k', x, v)


def nearest_interp(x, *, size, name=None):
    """Generated from ops.yaml (op: nearest_interp)."""
    return call('nearest_interp', x, size=size)


def number_count_k(ids, *, upper, name=None):
    """Generated from ops.yaml (op: number_count_k)."""
    return call('number_count_k', ids, upper=upper)


def numel_k(x, name=None):
    """Generated from ops.yaml (op: numel_k)."""
    return call('numel_k', x)


def partial_concat_k(*xs, start, length, name=None):
    """Generated from ops.yaml (op: partial_concat_k)."""
    return call('partial_concat_k', *xs, start=start, length=length)


def partial_sum_k(*xs, start, length, name=None):
    """Generated from ops.yaml (op: partial_sum_k)."""
    return call('partial_sum_k', *xs, start=start, length=length)


def prior_box_k(*, fh, fw, ih, iw, min_sizes, max_sizes, aspect_ratios, name=None):
    """Generated from ops.yaml (op: prior_box_k)."""
    return call('prior_box_k', fh=fh, fw=fw, ih=ih, iw=iw, min_sizes=min_sizes, max_sizes=max_sizes, aspect_ratios=aspect_ratios)


def prune_gate_by_capacity_k(gate_idx, expert_count, *, n_expert, name=None):
    """Generated from ops.yaml (op: prune_gate_by_capacity_k)."""
    return call('prune_gate_by_capacity_k', gate_idx, expert_count, n_expert=n_expert)


def randint_k(key, *, low, high, shape, name=None):
    """Generated from ops.yaml (op: randint_k)."""
    return call('randint_k', key, low=low, high=high, shape=shape)


def random_routing_k(prob, topk_value, topk_idx, key, name=None):
    """Generated from ops.yaml (op: random_routing_k)."""
    return call('random_routing_k', prob, topk_value, topk_idx, key)


def randperm_k(key, *, n, name=None):
    """Generated from ops.yaml (op: randperm_k)."""
    return call('randperm_k', key, n=n)


def sequence_mask_k(lengths, *, maxlen, name=None):
    """Generated from ops.yaml (op: sequence_mask_k)."""
    return call('sequence_mask_k', lengths, maxlen=maxlen)


def shape_k(x, name=None):
    """Generated from ops.yaml (op: shape_k)."""
    return call('shape_k', x)


def shard_index_k(x, *, index_num, nshards, shard_id, ignore_value, name=None):
    """Generated from ops.yaml (op: shard_index_k)."""
    return call('shard_index_k', x, index_num=index_num, nshards=nshards, shard_id=shard_id, ignore_value=ignore_value)


def shuffle_channel_k(x, *, group, name=None):
    """Generated from ops.yaml (op: shuffle_channel_k)."""
    return call('shuffle_channel_k', x, group=group)


def sigmoid_cross_entropy_with_logits_k(x, label, name=None):
    """Generated from ops.yaml (op: sigmoid_cross_entropy_with_logits_k)."""
    return call('sigmoid_cross_entropy_with_logits_k', x, label)


def skip_layernorm(x, skip, w, b, *, eps, name=None):
    """Generated from ops.yaml (op: skip_layernorm)."""
    return call('skip_layernorm', x, skip, w, b, eps=eps)


def trans_layout(x, *, perm, name=None):
    """Generated from ops.yaml (op: trans_layout)."""
    return call('trans_layout', x, perm=perm)


def tril_indices_k(*, rows, cols, offset, name=None):
    """Generated from ops.yaml (op: tril_indices_k)."""
    return call('tril_indices_k', rows=rows, cols=cols, offset=offset)


def trilinear_interp(x, *, size, name=None):
    """Generated from ops.yaml (op: trilinear_interp)."""
    return call('trilinear_interp', x, size=size)


def triu_indices_k(*, rows, cols, offset, name=None):
    """Generated from ops.yaml (op: triu_indices_k)."""
    return call('triu_indices_k', rows=rows, cols=cols, offset=offset)


def uniform_k(key, *, shape, lo, hi, name=None):
    """Generated from ops.yaml (op: uniform_k)."""
    return call('uniform_k', key, shape=shape, lo=lo, hi=hi)


def view_dtype(x, *, dtype, name=None):
    """Generated from ops.yaml (op: view_dtype)."""
    return call('view_dtype', x, dtype=dtype)


def view_slice(x, *, begin, end, name=None):
    """Generated from ops.yaml (op: view_slice)."""
    return call('view_slice', x, begin=begin, end=end)


def viterbi_decode_k(potentials, trans, lengths, name=None):
    """Generated from ops.yaml (op: viterbi_decode_k)."""
    return call('viterbi_decode_k', potentials, trans, lengths)


def accuracy_check(x, y, *, fn_name='', rtol=1e-5, atol=1e-8, equal_nan=False, name=None):
    """Generated from ops.yaml (op: accuracy_check)."""
    return call('accuracy_check', x, y, fn_name=fn_name, rtol=rtol, atol=atol, equal_nan=equal_nan)


def quant_linear_i8(x, wq, w_scale, *, act_scale, qmax, name=None):
    """Generated from ops.yaml (op: quant_linear_i8)."""
    return call('quant_linear_i8', x, wq, w_scale, act_scale=act_scale, qmax=qmax)
