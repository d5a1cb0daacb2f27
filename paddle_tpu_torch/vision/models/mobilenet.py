"""MobileNet v1 and v2: the counterpart of
``paddle_tpu/vision/models/mobilenet.py``, layer for layer (the depthwise
convolutions are ``Conv2D`` with ``groups`` equal to the channels)."""
from __future__ import annotations

from ... import nn


class _ConvBNRelu(nn.Layer):
    def __init__(self, in_c, out_c, k, stride=1, padding=0, groups=1,
                 relu6=False):
        super().__init__()
        self.conv = nn.Conv2D(in_c, out_c, k, stride=stride, padding=padding,
                              groups=groups, bias_attr=False)
        self.bn = nn.BatchNorm2D(out_c)
        self.act = nn.ReLU6() if relu6 else nn.ReLU()

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class MobileNetV1(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool

        def c(ch):
            return max(int(ch * scale), 8)

        cfg = [(32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
               (256, 256, 1), (256, 512, 2)] + [(512, 512, 1)] * 5 + \
            [(512, 1024, 2), (1024, 1024, 1)]
        layers = [_ConvBNRelu(3, c(32), 3, stride=2, padding=1)]
        for in_c, out_c, s in cfg:
            layers.append(_ConvBNRelu(c(in_c), c(in_c), 3, stride=s,
                                      padding=1, groups=c(in_c)))
            layers.append(_ConvBNRelu(c(in_c), c(out_c), 1))
        self.features = nn.Sequential(*layers)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = nn.Linear(c(1024), num_classes)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            from ...ops.manipulation import flatten
            x = self.fc(flatten(x, 1))
        return x


class _InvertedResidual(nn.Layer):
    def __init__(self, inp, oup, stride, expand_ratio):
        super().__init__()
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(_ConvBNRelu(inp, hidden, 1, relu6=True))
        layers += [
            _ConvBNRelu(hidden, hidden, 3, stride=stride, padding=1,
                        groups=hidden, relu6=True),
            nn.Conv2D(hidden, oup, 1, bias_attr=False),
            nn.BatchNorm2D(oup),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]

        def c(ch):
            return max(int(ch * scale), 8)

        input_c = c(32)
        layers = [_ConvBNRelu(3, input_c, 3, stride=2, padding=1,
                              relu6=True)]
        for t, ch, n, s in cfg:
            out_c = c(ch)
            for i in range(n):
                layers.append(_InvertedResidual(
                    input_c, out_c, s if i == 0 else 1, t))
                input_c = out_c
        last = c(1280)
        layers.append(_ConvBNRelu(input_c, last, 1, relu6=True))
        self.features = nn.Sequential(*layers)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.classifier = nn.Sequential(nn.Dropout(0.2),
                                            nn.Linear(last, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            from ...ops.manipulation import flatten
            x = self.classifier(flatten(x, 1))
        return x
