"""``vision.ops``, the detection operators: the counterpart of
``paddle_tpu/vision/ops.py`` (``roi_align``, ``roi_pool``, ``nms``,
``box_coder``, ``prior_box``, ``yolo_box``), plain PyTorch, with the
reference's rules:

- ``roi_align`` samples each bin at ``sampling_ratio``^2 points
  (``-1`` means 2, where Paddle adapts it per RoI), clamping every sample
  into the image and interpolating bilinearly; the RoI of each row comes
  from ``boxes_num`` (the rows past its sum belong to the last image);
- ``roi_pool`` takes the maximum over quantised bins (an empty bin gives
  0). It is taken separably, over each x-bin and then each y-bin, in
  chunks of RoIs: the reference's one ``[C, ph, H, pw, W]`` select per RoI
  is ~12 G elements at Fast R-CNN's shape;
- ``nms`` keeps a box when no higher-scored kept box overlaps it past the
  threshold. The greedy sweep is computed as a fixed point: ``keep[i] =
  not any(iou[i, j] > t and keep[j] for j < i)`` iterated over all boxes
  at once; after k rounds the first k entries are exact, and the sweep
  usually settles in as many rounds as its longest chain of suppressions.
  Rounds run in batches on the device; the one host read is the final
  compaction of the kept indices, which also reads whether the batch
  settled (another batch runs when not). ``category_idxs`` shifts each
  category into a coordinate range of its own, as the reference.
"""
from __future__ import annotations

import torch

from .._core.dispatch import apply, meta, unwrap
from .._core.op_registry import register_op
from .._core.tensor import Tensor

__all__ = ["roi_align", "roi_pool", "nms", "box_coder", "prior_box",
           "yolo_box"]

ROI_POOL_CHUNK = 1 << 26   # elements of one chunk's [R, C, H, pw, W] select
NMS_ROUNDS = 32            # fixed-point rounds a batch before its check


def _image_of_roi(boxes_num, r):
    """Each RoI's image index from the per-image counts (``jnp.repeat``
    with ``total_repeat_length=r``: the rows past the sum take the last
    image)."""
    ends = torch.cumsum(boxes_num.to(torch.int64), 0)
    idx = torch.searchsorted(ends, torch.arange(r, device=ends.device),
                             right=True)
    return idx.clamp(max=boxes_num.shape[0] - 1)


# ----------------------------------------------------------- roi align

def _roi_samples(boxes, boxes_num, shape, pooled_height, pooled_width,
                 spatial_scale, sampling_ratio, aligned):
    """Where ``roi_align`` samples: for each RoI, bin and sample point
    ([R, ph * pw * s * s]) the flat pixel index of its four corners in
    the NHW grid of ``shape`` (y0x0, y0x1, y1x0, y1x1) and the
    interpolation weights ``wy``, ``wx`` ([R, samples, 1])."""
    n, _, h, w = shape
    r = boxes.shape[0]
    img = _image_of_roi(boxes_num, r)
    offset = 0.5 if aligned else 0.0
    x1 = boxes[:, 0] * spatial_scale - offset
    y1 = boxes[:, 1] * spatial_scale - offset
    x2 = boxes[:, 2] * spatial_scale - offset
    y2 = boxes[:, 3] * spatial_scale - offset
    roi_w, roi_h = x2 - x1, y2 - y1
    if not aligned:
        roi_w, roi_h = roi_w.clamp(min=1.0), roi_h.clamp(min=1.0)
    bin_w, bin_h = roi_w / pooled_width, roi_h / pooled_height
    s = sampling_ratio if sampling_ratio > 0 else 2
    dev, dt = boxes.device, boxes.dtype
    steps = (torch.arange(s, device=dev, dtype=dt) + 0.5) / s
    py = (torch.arange(pooled_height, device=dev, dtype=dt)[:, None, None,
                                                             None]
          + steps[None, None, :, None])
    px = (torch.arange(pooled_width, device=dev, dtype=dt)[None, :, None,
                                                            None]
          + steps[None, None, None, :])
    # sample coordinates [R, ph, pw, s, s]
    yy = y1[:, None, None, None, None] + py[None] * bin_h[:, None, None,
                                                         None, None]
    xx = x1[:, None, None, None, None] + px[None] * bin_w[:, None, None,
                                                         None, None]
    yy, xx = torch.broadcast_tensors(yy, xx)
    y0 = torch.floor(yy).clamp(0, h - 1)
    x0 = torch.floor(xx).clamp(0, w - 1)
    y1_ = (y0 + 1).clamp(0, h - 1)
    x1_ = (x0 + 1).clamp(0, w - 1)
    wy = (yy.clamp(0, h - 1) - y0).reshape(r, -1, 1)
    wx = (xx.clamp(0, w - 1) - x0).reshape(r, -1, 1)
    base = (img * (h * w))[:, None]
    corners = [base + (yi.to(torch.int64) * w + xi.to(torch.int64))
               .reshape(r, -1) for yi, xi in ((y0, x0), (y0, x1_),
                                               (y1_, x0), (y1_, x1_))]
    return corners, wy, wx


@register_op("roi_align")
def _roi_align(x, boxes, boxes_num, pooled_height, pooled_width,
               spatial_scale=1.0, sampling_ratio=-1, aligned=True):
    n, c, h, w = x.shape
    r = boxes.shape[0]
    s = sampling_ratio if sampling_ratio > 0 else 2
    (c00, c01, c10, c11), wy, wx = _roi_samples(
        boxes, boxes_num, x.shape, pooled_height, pooled_width,
        spatial_scale, sampling_ratio, aligned)
    # the image as rows of channels: one gather of [R, samples, C] a corner
    rows = x.permute(0, 2, 3, 1).reshape(n * h * w, c)
    vals = (rows[c00] * (1 - wy) * (1 - wx) + rows[c01] * (1 - wy) * wx
            + rows[c10] * wy * (1 - wx) + rows[c11] * wy * wx)
    vals = vals.reshape(r, pooled_height, pooled_width, s, s, c)
    return vals.mean(dim=(3, 4)).permute(0, 3, 1, 2)


def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None):
    oh, ow = (output_size, output_size) if isinstance(output_size, int) \
        else tuple(output_size)
    return apply("roi_align", _roi_align, x, boxes, boxes_num,
                 pooled_height=int(oh), pooled_width=int(ow),
                 spatial_scale=float(spatial_scale),
                 sampling_ratio=int(sampling_ratio), aligned=bool(aligned))


# ------------------------------------------------------------ roi pool

@register_op("roi_pool")
def _roi_pool(x, boxes, boxes_num, pooled_height, pooled_width,
              spatial_scale):
    n, c, h, w = x.shape
    r = boxes.shape[0]
    img = _image_of_roi(boxes_num, r)
    q = torch.round(boxes * spatial_scale).to(torch.int64)
    x1, y1, x2, y2 = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    roi_w = (x2 - x1 + 1).clamp(min=1)
    roi_h = (y2 - y1 + 1).clamp(min=1)
    by = _member(y1, y2, roi_h, pooled_height, h, x.device)  # [R, ph, H]
    bx = _member(x1, x2, roi_w, pooled_width, w, x.device)   # [R, pw, W]
    chunk = max(1, ROI_POOL_CHUNK // max(1, c * h * pooled_width * w))
    neg = torch.full((), float("-inf"), dtype=x.dtype, device=x.device)
    outs = []
    for s in range(0, r, chunk):
        im = x[img[s:s + chunk]]                              # [Rc,C,H,W]
        mx = bx[s:s + chunk, None, None, :, :]               # [Rc,1,1,pw,W]
        colmax = torch.where(mx, im[:, :, :, None, :], neg).amax(-1)
        my = by[s:s + chunk, None, :, :, None]               # [Rc,1,ph,H,1]
        outs.append(torch.where(my, colmax[:, :, None], neg).amax(3))
    out = torch.cat(outs) if outs else x.new_zeros(
        (0, c, pooled_height, pooled_width))
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def _member(lo, hi, size, pooled, n, dev):
    """[R, pooled, n]: pixel k of the axis lies in bin j of each RoI (the
    reference's ``((k - lo) * pooled) // size``, clamped into the bins,
    for ``lo <= k <= hi``)."""
    k = torch.arange(n, device=dev)
    b = torch.div((k[None] - lo[:, None]) * pooled, size[:, None],
                  rounding_mode="floor")
    inside = (k[None] >= lo[:, None]) & (k[None] <= hi[:, None])
    b = torch.where(inside, b.clamp(0, pooled - 1), -1)
    return b[:, None, :] == torch.arange(pooled, device=dev)[None, :, None]


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
             name=None):
    oh, ow = (output_size, output_size) if isinstance(output_size, int) \
        else tuple(output_size)
    return apply("roi_pool", _roi_pool, x, boxes, boxes_num,
                 pooled_height=int(oh), pooled_width=int(ow),
                 spatial_scale=float(spatial_scale))


# ----------------------------------------------------------------- nms

def _iou_matrix(b):
    x1, y1, x2, y2 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    ix1 = torch.maximum(x1[:, None], x1[None, :])
    iy1 = torch.maximum(y1[:, None], y1[None, :])
    ix2 = torch.minimum(x2[:, None], x2[None, :])
    iy2 = torch.minimum(y2[:, None], y2[None, :])
    inter = (ix2 - ix1).clamp(min=0) * (iy2 - iy1).clamp(min=0)
    union = area[:, None] + area[None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


def _suppressors(boxes, scores, iou_threshold):
    """The boxes in score order (stable) and the strictly lower triangle
    of ``iou > threshold`` among them, as 0/1 in the boxes' type."""
    order = torch.argsort(-scores, stable=True)
    over = _iou_matrix(boxes[order]) > iou_threshold
    return order, torch.tril(over, -1).to(torch.float32)


def _sweep(lower, keep, rounds):
    """``rounds`` rounds of the fixed point from ``keep`` (0/1 float32:
    the counts of kept suppressors are exact)."""
    for _ in range(rounds):
        keep = ((lower @ keep) == 0).to(lower.dtype)
    return keep


@register_op("nms_mask")
def _nms_mask(boxes, scores, iou_threshold):
    """The greedy keep mask in score order (all rounds the sweep can
    need: exact without reading anything back)."""
    n = boxes.shape[0]
    _, lower = _suppressors(boxes, scores, iou_threshold)
    keep = torch.ones(n, dtype=lower.dtype, device=boxes.device)
    return _sweep(lower, keep, n) > 0


def nms(boxes, scores=None, iou_threshold=0.3, top_k=None,
        category_idxs=None, categories=None, name=None):
    """The kept boxes' indices in descending score order (ties in index
    order), an int64 ``Tensor``; with ``category_idxs`` boxes of different
    categories never suppress each other."""
    b = unwrap(boxes)
    n = b.shape[0]
    s = torch.ones(n, dtype=torch.float32, device=b.device) \
        if scores is None else unwrap(scores)
    if category_idxs is not None:
        span = b.max() - b.min() + 1.0
        b = b + (unwrap(category_idxs).to(torch.float32) * span)[:, None]
    order, lower = _suppressors(b, s, float(iou_threshold))
    keep = torch.ones(n, dtype=lower.dtype, device=b.device)
    done = 0
    while True:
        rounds = min(NMS_ROUNDS, n - done)
        keep = _sweep(lower, keep, rounds)
        done += rounds
        unsettled = (keep != _sweep(lower, keep, 1)).any() & (done < n)
        # the one read: the kept positions; every position and one past
        # the end when another batch of rounds is needed
        flags = torch.cat([keep > 0, torch.zeros(1, dtype=torch.bool,
                                                 device=b.device)])
        pos = torch.nonzero(flags | unsettled).reshape(-1)
        if pos.numel() <= n:
            break
    kept = order[pos]
    if top_k is not None:
        kept = kept[:top_k]
    return Tensor(kept.to(torch.int64))


# ------------------------------------------------------------ box coder

@register_op("box_coder")
def _box_coder(prior_box, prior_var, target_box, code_type,
               box_normalized):
    """encode_center_size / decode_center_size."""
    norm = 0.0 if box_normalized else 1.0
    pw = prior_box[:, 2] - prior_box[:, 0] + norm
    ph = prior_box[:, 3] - prior_box[:, 1] + norm
    pcx = prior_box[:, 0] + pw * 0.5
    pcy = prior_box[:, 1] + ph * 0.5
    if code_type == "encode_center_size":
        tw = target_box[:, 2] - target_box[:, 0] + norm
        th = target_box[:, 3] - target_box[:, 1] + norm
        tcx = target_box[:, 0] + tw * 0.5
        tcy = target_box[:, 1] + th * 0.5
        out = torch.stack([(tcx - pcx) / pw, (tcy - pcy) / ph,
                           torch.log(tw / pw), torch.log(th / ph)], dim=1)
        return out / prior_var if prior_var is not None else out
    t = target_box * prior_var if prior_var is not None else target_box
    cx = t[:, 0] * pw + pcx
    cy = t[:, 1] * ph + pcy
    bw = torch.exp(t[:, 2]) * pw
    bh = torch.exp(t[:, 3]) * ph
    return torch.stack([cx - bw * 0.5, cy - bh * 0.5,
                        cx + bw * 0.5 - norm, cy + bh * 0.5 - norm], dim=1)


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              axis=0, name=None):
    return apply("box_coder", _box_coder, prior_box, prior_box_var,
                 target_box, code_type=code_type,
                 box_normalized=bool(box_normalized))


# ------------------------------------------------------------ prior box

def _const(values, device):
    """A float32 tensor of Python numbers on ``device``, copied there
    without a blocking copy (``torch.tensor(..., device=cuda)`` waits for
    its copy: a host sync)."""
    return torch.tensor(values, dtype=torch.float32).to(device,
                                                        non_blocking=True)


def prior_box(input, image, min_sizes, max_sizes=None,
              aspect_ratios=(1.0,), variance=(0.1, 0.1, 0.2, 0.2),
              flip=False, clip=False, steps=(0.0, 0.0), offset=0.5,
              name=None):
    """SSD prior boxes: (boxes [H, W, P, 4], variances [H, W, P, 4]) for
    P anchors a cell of ``input``'s map over ``image``, normalised."""
    dev = meta(input).device
    fh, fw = int(input.shape[2]), int(input.shape[3])
    ih, iw = int(image.shape[2]), int(image.shape[3])
    step_h = steps[1] or ih / fh
    step_w = steps[0] or iw / fw
    ratios = list(aspect_ratios)
    if flip:
        ratios += [1.0 / r for r in aspect_ratios if r != 1.0]
    whs = []
    for ms in min_sizes:
        for r in ratios:
            whs.append((ms * (r ** 0.5), ms / (r ** 0.5)))
        if max_sizes:
            mx = max_sizes[min_sizes.index(ms)]
            whs.append(((ms * mx) ** 0.5, (ms * mx) ** 0.5))
    f32 = torch.float32
    # host constants reach the card by asynchronous copies: no sync
    whs = _const(whs, dev)                                      # [P, 2]
    cy = (torch.arange(fh, device=dev, dtype=f32) + offset) * step_h
    cx = (torch.arange(fw, device=dev, dtype=f32) + offset) * step_w
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")            # [H, W]
    ctr = torch.stack([cxg, cyg], -1)[:, :, None, :]            # [H,W,1,2]
    half = whs[None, None] * 0.5
    size = _const([iw, ih], dev)
    boxes = torch.cat([(ctr - half) / size, (ctr + half) / size], dim=-1)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    var = _const(variance, dev).expand(boxes.shape)
    return Tensor(boxes), Tensor(var.contiguous())


# ------------------------------------------------------------- yolo box

@register_op("yolo_box", multi_output=True)
def _yolo_box(x, img_size, anchors, class_num, conf_thresh,
              downsample_ratio, clip_bbox, scale_x_y):
    """A YOLOv3 head [N, A*(5+C), H, W] decoded: boxes [N, A*H*W, 4] in
    image pixels, scores [N, A*H*W, C] (0 below ``conf_thresh``)."""
    n, _, h, w = x.shape
    a = len(anchors) // 2
    anc = _const(anchors, x.device).reshape(a, 2)
    x = x.reshape(n, a, 5 + class_num, h, w)
    gx = torch.arange(w, dtype=torch.float32, device=x.device)
    gy = torch.arange(h, dtype=torch.float32, device=x.device)
    bias = 0.5 * (scale_x_y - 1.0)
    cx = (torch.sigmoid(x[:, :, 0]) * scale_x_y - bias
          + gx[None, None, None, :]) / w
    cy = (torch.sigmoid(x[:, :, 1]) * scale_x_y - bias
          + gy[None, None, :, None]) / h
    bw = torch.exp(x[:, :, 2]) * anc[None, :, 0, None, None] / (
        downsample_ratio * w)
    bh = torch.exp(x[:, :, 3]) * anc[None, :, 1, None, None] / (
        downsample_ratio * h)
    conf = torch.sigmoid(x[:, :, 4])
    probs = torch.sigmoid(x[:, :, 5:]) * conf[:, :, None]
    imh = img_size[:, 0].to(torch.float32)[:, None, None, None]
    imw = img_size[:, 1].to(torch.float32)[:, None, None, None]
    x1 = (cx - bw * 0.5) * imw
    y1 = (cy - bh * 0.5) * imh
    x2 = (cx + bw * 0.5) * imw
    y2 = (cy + bh * 0.5) * imh
    if clip_bbox:
        x1 = torch.minimum(x1.clamp(min=0), imw - 1)
        y1 = torch.minimum(y1.clamp(min=0), imh - 1)
        x2 = torch.minimum(x2.clamp(min=0), imw - 1)
        y2 = torch.minimum(y2.clamp(min=0), imh - 1)
    boxes = torch.stack([x1, y1, x2, y2], -1).reshape(n, -1, 4)
    mask = (conf > conf_thresh)[..., None]
    scores = torch.where(mask, probs.permute(0, 1, 3, 4, 2),
                         torch.zeros((), dtype=probs.dtype,
                                     device=probs.device))
    return boxes, scores.reshape(n, -1, class_num)


def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio, clip_bbox=True, scale_x_y=1.0, name=None,
             iou_aware=False, iou_aware_factor=0.5):
    if iou_aware:
        raise NotImplementedError(
            "yolo_box: iou_aware=True uses the A*(6+C) channel layout, "
            "which the reference's decoder does not support either")
    return apply("yolo_box", _yolo_box, x, img_size, anchors=tuple(anchors),
                 class_num=int(class_num), conf_thresh=float(conf_thresh),
                 downsample_ratio=int(downsample_ratio),
                 clip_bbox=bool(clip_bbox), scale_x_y=float(scale_x_y))
