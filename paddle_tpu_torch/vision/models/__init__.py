"""Counterpart of ``paddle_tpu/vision/models``: LeNet, ResNet, VGG,
MobileNet and the five families of ``extras.py``."""
from .lenet import LeNet  # noqa: F401
from .mobilenet import MobileNetV1, MobileNetV2  # noqa: F401
from .resnet import (BasicBlock, BottleneckBlock, ResNet,  # noqa: F401
                     resnet18, resnet34, resnet50, resnet101, resnet152)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401
from .extras import (AlexNet, DenseNet, GoogLeNet, ShuffleNetV2,  # noqa: F401
                     SqueezeNet, alexnet, densenet121, googlenet,
                     shufflenet_v2_x1_0, squeezenet1_1)
