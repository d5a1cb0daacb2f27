"""AlexNet, SqueezeNet 1.1, DenseNet, ShuffleNetV2 and GoogLeNet (no aux
heads): the counterpart of ``paddle_tpu/vision/models/extras.py``, layer
for layer, with the same ``state_dict`` keys and shapes."""
from __future__ import annotations

from ... import nn
from ...ops.manipulation import concat, reshape, transpose


# ------------------------------------------------------------------ alexnet

class AlexNet(nn.Layer):

    def __init__(self, num_classes=1000):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2D(3, 64, 11, stride=4, padding=2), nn.ReLU(),
            nn.MaxPool2D(3, stride=2),
            nn.Conv2D(64, 192, 5, padding=2), nn.ReLU(),
            nn.MaxPool2D(3, stride=2),
            nn.Conv2D(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2D(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2D(256, 256, 3, padding=1), nn.ReLU(),
            nn.MaxPool2D(3, stride=2),
        )
        self.pool = nn.AdaptiveAvgPool2D((6, 6))
        self.classifier = nn.Sequential(
            nn.Dropout(0.5), nn.Linear(256 * 36, 4096), nn.ReLU(),
            nn.Dropout(0.5), nn.Linear(4096, 4096), nn.ReLU(),
            nn.Linear(4096, num_classes),
        )

    def forward(self, x):
        x = self.pool(self.features(x))
        return self.classifier(nn.Flatten()(x))


def alexnet(pretrained=False, **kwargs):
    return AlexNet(**kwargs)


# --------------------------------------------------------------- squeezenet

class _Fire(nn.Layer):
    def __init__(self, inp, squeeze, e1, e3):
        super().__init__()
        self.squeeze = nn.Conv2D(inp, squeeze, 1)
        self.expand1 = nn.Conv2D(squeeze, e1, 1)
        self.expand3 = nn.Conv2D(squeeze, e3, 3, padding=1)
        self.relu = nn.ReLU()

    def forward(self, x):
        x = self.relu(self.squeeze(x))
        return concat([self.relu(self.expand1(x)),
                              self.relu(self.expand3(x))], axis=1)


class SqueezeNet(nn.Layer):

    def __init__(self, version="1.1", num_classes=1000):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2D(3, 64, 3, stride=2), nn.ReLU(),
            nn.MaxPool2D(3, stride=2),
            _Fire(64, 16, 64, 64), _Fire(128, 16, 64, 64),
            nn.MaxPool2D(3, stride=2),
            _Fire(128, 32, 128, 128), _Fire(256, 32, 128, 128),
            nn.MaxPool2D(3, stride=2),
            _Fire(256, 48, 192, 192), _Fire(384, 48, 192, 192),
            _Fire(384, 64, 256, 256), _Fire(512, 64, 256, 256),
        )
        self.classifier = nn.Sequential(
            nn.Dropout(0.5), nn.Conv2D(512, num_classes, 1), nn.ReLU(),
            nn.AdaptiveAvgPool2D((1, 1)))

    def forward(self, x):
        x = self.classifier(self.features(x))
        return nn.Flatten()(x)


def squeezenet1_1(pretrained=False, **kwargs):
    return SqueezeNet("1.1", **kwargs)


# ----------------------------------------------------------------- densenet

class _DenseLayer(nn.Layer):
    def __init__(self, inp, growth, bn_size):
        super().__init__()
        self.norm1 = nn.BatchNorm2D(inp)
        self.conv1 = nn.Conv2D(inp, bn_size * growth, 1, bias_attr=False)
        self.norm2 = nn.BatchNorm2D(bn_size * growth)
        self.conv2 = nn.Conv2D(bn_size * growth, growth, 3, padding=1,
                               bias_attr=False)
        self.relu = nn.ReLU()

    def forward(self, x):
        y = self.conv1(self.relu(self.norm1(x)))
        y = self.conv2(self.relu(self.norm2(y)))
        return concat([x, y], axis=1)


class _Transition(nn.Layer):
    def __init__(self, inp, out):
        super().__init__()
        self.norm = nn.BatchNorm2D(inp)
        self.conv = nn.Conv2D(inp, out, 1, bias_attr=False)
        self.pool = nn.AvgPool2D(2, stride=2)
        self.relu = nn.ReLU()

    def forward(self, x):
        return self.pool(self.conv(self.relu(self.norm(x))))


class DenseNet(nn.Layer):

    def __init__(self, layers=121, growth_rate=32, bn_size=4,
                 num_classes=1000):
        super().__init__()
        cfg = {121: (6, 12, 24, 16), 161: (6, 12, 36, 24),
               169: (6, 12, 32, 32), 201: (6, 12, 48, 32)}[layers]
        num_init = 64
        feats = [nn.Conv2D(3, num_init, 7, stride=2, padding=3,
                           bias_attr=False),
                 nn.BatchNorm2D(num_init), nn.ReLU(),
                 nn.MaxPool2D(3, stride=2, padding=1)]
        ch = num_init
        for i, n in enumerate(cfg):
            for _ in range(n):
                feats.append(_DenseLayer(ch, growth_rate, bn_size))
                ch += growth_rate
            if i != len(cfg) - 1:
                feats.append(_Transition(ch, ch // 2))
                ch //= 2
        feats += [nn.BatchNorm2D(ch), nn.ReLU()]
        self.features = nn.Sequential(*feats)
        self.pool = nn.AdaptiveAvgPool2D((1, 1))
        self.classifier = nn.Linear(ch, num_classes)

    def forward(self, x):
        x = self.pool(self.features(x))
        return self.classifier(nn.Flatten()(x))


def densenet121(pretrained=False, **kwargs):
    return DenseNet(121, **kwargs)


# -------------------------------------------------------------- shufflenet

class _ShuffleUnit(nn.Layer):
    def __init__(self, inp, out, stride):
        super().__init__()
        self.stride = stride
        branch = out // 2
        if stride > 1:
            self.branch1 = nn.Sequential(
                nn.Conv2D(inp, inp, 3, stride=stride, padding=1,
                          groups=inp, bias_attr=False),
                nn.BatchNorm2D(inp),
                nn.Conv2D(inp, branch, 1, bias_attr=False),
                nn.BatchNorm2D(branch), nn.ReLU())
            in2 = inp
        else:
            self.branch1 = None
            in2 = inp // 2
        self.branch2 = nn.Sequential(
            nn.Conv2D(in2, branch, 1, bias_attr=False),
            nn.BatchNorm2D(branch), nn.ReLU(),
            nn.Conv2D(branch, branch, 3, stride=stride, padding=1,
                      groups=branch, bias_attr=False),
            nn.BatchNorm2D(branch),
            nn.Conv2D(branch, branch, 1, bias_attr=False),
            nn.BatchNorm2D(branch), nn.ReLU())

    def forward(self, x):
        if self.stride == 1:
            c = x.shape[1] // 2
            x1, x2 = x[:, :c], x[:, c:]
            out = concat([x1, self.branch2(x2)], axis=1)
        else:
            out = concat([self.branch1(x), self.branch2(x)],
                                axis=1)
        # channel shuffle (groups=2)
        b, ch, h, w = out.shape
        out = reshape(out, [b, 2, ch // 2, h, w])
        out = transpose(out, [0, 2, 1, 3, 4])
        return reshape(out, [b, ch, h, w])


class ShuffleNetV2(nn.Layer):

    def __init__(self, scale=1.0, num_classes=1000):
        super().__init__()
        stage_out = {0.5: [24, 48, 96, 192, 1024],
                     1.0: [24, 116, 232, 464, 1024]}[scale]
        self.conv1 = nn.Sequential(
            nn.Conv2D(3, stage_out[0], 3, stride=2, padding=1,
                      bias_attr=False),
            nn.BatchNorm2D(stage_out[0]), nn.ReLU())
        self.maxpool = nn.MaxPool2D(3, stride=2, padding=1)
        stages = []
        inp = stage_out[0]
        for out, repeats in zip(stage_out[1:4], (4, 8, 4)):
            units = [_ShuffleUnit(inp, out, 2)]
            units += [_ShuffleUnit(out, out, 1) for _ in range(repeats - 1)]
            stages.append(nn.Sequential(*units))
            inp = out
        self.stages = nn.Sequential(*stages)
        self.conv5 = nn.Sequential(
            nn.Conv2D(inp, stage_out[4], 1, bias_attr=False),
            nn.BatchNorm2D(stage_out[4]), nn.ReLU())
        self.pool = nn.AdaptiveAvgPool2D((1, 1))
        self.fc = nn.Linear(stage_out[4], num_classes)

    def forward(self, x):
        x = self.maxpool(self.conv1(x))
        x = self.conv5(self.stages(x))
        return self.fc(nn.Flatten()(self.pool(x)))


def shufflenet_v2_x1_0(pretrained=False, **kwargs):
    return ShuffleNetV2(1.0, **kwargs)


# ---------------------------------------------------------------- googlenet

class _Inception(nn.Layer):
    def __init__(self, inp, c1, c3r, c3, c5r, c5, pp):
        super().__init__()
        self.b1 = nn.Sequential(nn.Conv2D(inp, c1, 1), nn.ReLU())
        self.b2 = nn.Sequential(nn.Conv2D(inp, c3r, 1), nn.ReLU(),
                                nn.Conv2D(c3r, c3, 3, padding=1),
                                nn.ReLU())
        self.b3 = nn.Sequential(nn.Conv2D(inp, c5r, 1), nn.ReLU(),
                                nn.Conv2D(c5r, c5, 5, padding=2),
                                nn.ReLU())
        self.b4 = nn.Sequential(nn.MaxPool2D(3, stride=1, padding=1),
                                nn.Conv2D(inp, pp, 1), nn.ReLU())

    def forward(self, x):
        return concat([self.b1(x), self.b2(x), self.b3(x),
                              self.b4(x)], axis=1)


class GoogLeNet(nn.Layer):

    def __init__(self, num_classes=1000):
        super().__init__()
        self.stem = nn.Sequential(
            nn.Conv2D(3, 64, 7, stride=2, padding=3), nn.ReLU(),
            nn.MaxPool2D(3, stride=2, padding=1),
            nn.Conv2D(64, 64, 1), nn.ReLU(),
            nn.Conv2D(64, 192, 3, padding=1), nn.ReLU(),
            nn.MaxPool2D(3, stride=2, padding=1))
        self.blocks = nn.Sequential(
            _Inception(192, 64, 96, 128, 16, 32, 32),
            _Inception(256, 128, 128, 192, 32, 96, 64),
            nn.MaxPool2D(3, stride=2, padding=1),
            _Inception(480, 192, 96, 208, 16, 48, 64),
            _Inception(512, 160, 112, 224, 24, 64, 64),
            _Inception(512, 128, 128, 256, 24, 64, 64),
            _Inception(512, 112, 144, 288, 32, 64, 64),
            _Inception(528, 256, 160, 320, 32, 128, 128),
            nn.MaxPool2D(3, stride=2, padding=1),
            _Inception(832, 256, 160, 320, 32, 128, 128),
            _Inception(832, 384, 192, 384, 48, 128, 128))
        self.pool = nn.AdaptiveAvgPool2D((1, 1))
        self.dropout = nn.Dropout(0.2)
        self.fc = nn.Linear(1024, num_classes)

    def forward(self, x):
        x = self.pool(self.blocks(self.stem(x)))
        return self.fc(self.dropout(nn.Flatten()(x)))


def googlenet(pretrained=False, **kwargs):
    return GoogLeNet(**kwargs)
