"""Vision models (the port of ``paddle_tpu/vision/models.py``): LeNet,
ResNet-18/34/50/101/152, VGG, MobileNetV1, AlexNet, SqueezeNet 1.1,
ShuffleNetV2 and DenseNet-121, with the JAX package's sublayer names, so
its ``state_dict()`` loads into these unchanged."""
from __future__ import annotations

import torch

from .. import nn

__all__ = ["LeNet", "ResNet", "resnet18", "resnet34", "resnet50",
           "resnet101", "VGG", "vgg16", "MobileNetV1",
           "AlexNet", "alexnet", "SqueezeNet", "squeezenet1_1",
           "ShuffleNetV2", "shufflenet_v2_x1_0", "DenseNet", "densenet121"]


class LeNet(nn.Layer):
    def __init__(self, num_classes=10):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2D(1, 6, 3, stride=1, padding=1), nn.ReLU(),
            nn.MaxPool2D(2, 2),
            nn.Conv2D(6, 16, 5, stride=1, padding=0), nn.ReLU(),
            nn.MaxPool2D(2, 2))
        self.fc = nn.Sequential(
            nn.Linear(400, 120), nn.Linear(120, 84),
            nn.Linear(84, num_classes))

    def forward(self, x):
        return self.fc(self.features(x).flatten(1))


class BasicBlock(nn.Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1 = nn.Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                               bias_attr=False)
        self.bn1 = nn.BatchNorm2D(planes)
        self.relu = nn.ReLU()
        self.conv2 = nn.Conv2D(planes, planes, 3, padding=1, bias_attr=False)
        self.bn2 = nn.BatchNorm2D(planes)
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1 = nn.Conv2D(inplanes, planes, 1, bias_attr=False)
        self.bn1 = nn.BatchNorm2D(planes)
        self.conv2 = nn.Conv2D(planes, planes, 3, stride=stride, padding=1,
                               bias_attr=False)
        self.bn2 = nn.BatchNorm2D(planes)
        self.conv3 = nn.Conv2D(planes, planes * 4, 1, bias_attr=False)
        self.bn3 = nn.BatchNorm2D(planes * 4)
        self.relu = nn.ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Layer):
    """ResNet-{18,34,50,101,152}."""

    CFG = {18: (BasicBlock, [2, 2, 2, 2]), 34: (BasicBlock, [3, 4, 6, 3]),
           50: (BottleneckBlock, [3, 4, 6, 3]),
           101: (BottleneckBlock, [3, 4, 23, 3]),
           152: (BottleneckBlock, [3, 8, 36, 3])}

    def __init__(self, depth=50, num_classes=1000, with_pool=True):
        super().__init__()
        block, layers = self.CFG[depth]
        self.inplanes = 64
        self.conv1 = nn.Conv2D(3, 64, 7, stride=2, padding=3, bias_attr=False)
        self.bn1 = nn.BatchNorm2D(64)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        self.avgpool = nn.AdaptiveAvgPool2D((1, 1)) if with_pool else None
        self.fc = (nn.Linear(512 * block.expansion, num_classes)
                   if num_classes > 0 else None)

    def _make_layer(self, block, planes, blocks, stride=1):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2D(self.inplanes, planes * block.expansion, 1,
                          stride=stride, bias_attr=False),
                nn.BatchNorm2D(planes * block.expansion))
        layers = [block(self.inplanes, planes, stride, downsample)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if self.avgpool is not None:
            x = self.avgpool(x)
        if self.fc is not None:
            x = self.fc(x.flatten(1))
        return x


def resnet18(pretrained=False, **kwargs):
    return ResNet(18, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return ResNet(34, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return ResNet(50, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return ResNet(101, **kwargs)


class VGG(nn.Layer):
    def __init__(self, cfg=(64, "M", 128, "M", 256, 256, "M", 512, 512, "M",
                            512, 512, "M"), num_classes=1000):
        super().__init__()
        layers = []
        in_c = 3
        for v in cfg:
            if v == "M":
                layers.append(nn.MaxPool2D(2, 2))
            else:
                layers += [nn.Conv2D(in_c, v, 3, padding=1), nn.ReLU()]
                in_c = v
        self.features = nn.Sequential(*layers)
        self.avgpool = nn.AdaptiveAvgPool2D((7, 7))
        self.classifier = nn.Sequential(
            nn.Linear(512 * 7 * 7, 4096), nn.ReLU(), nn.Dropout(0.5),
            nn.Linear(4096, 4096), nn.ReLU(), nn.Dropout(0.5),
            nn.Linear(4096, num_classes))

    def forward(self, x):
        return self.classifier(self.avgpool(self.features(x)).flatten(1))


def vgg16(pretrained=False, **kwargs):
    return VGG(**kwargs)


class MobileNetV1(nn.Layer):
    def __init__(self, num_classes=1000, scale=1.0):
        super().__init__()

        def dw_sep(inp, outp, stride):
            return nn.Sequential(
                nn.Conv2D(inp, inp, 3, stride=stride, padding=1, groups=inp,
                          bias_attr=False),
                nn.BatchNorm2D(inp), nn.ReLU(),
                nn.Conv2D(inp, outp, 1, bias_attr=False),
                nn.BatchNorm2D(outp), nn.ReLU())

        def s(c):
            return int(c * scale)

        self.features = nn.Sequential(
            nn.Conv2D(3, s(32), 3, stride=2, padding=1, bias_attr=False),
            nn.BatchNorm2D(s(32)), nn.ReLU(),
            dw_sep(s(32), s(64), 1), dw_sep(s(64), s(128), 2),
            dw_sep(s(128), s(128), 1), dw_sep(s(128), s(256), 2),
            dw_sep(s(256), s(256), 1), dw_sep(s(256), s(512), 2),
            *[dw_sep(s(512), s(512), 1) for _ in range(5)],
            dw_sep(s(512), s(1024), 2), dw_sep(s(1024), s(1024), 1))
        self.pool = nn.AdaptiveAvgPool2D((1, 1))
        self.fc = nn.Linear(s(1024), num_classes)

    def forward(self, x):
        return self.fc(self.pool(self.features(x)).flatten(1))


class AlexNet(nn.Layer):
    def __init__(self, num_classes=1000, dropout=0.5):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2D(3, 64, 11, stride=4, padding=2), nn.ReLU(),
            nn.MaxPool2D(3, 2),
            nn.Conv2D(64, 192, 5, padding=2), nn.ReLU(),
            nn.MaxPool2D(3, 2),
            nn.Conv2D(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2D(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2D(256, 256, 3, padding=1), nn.ReLU(),
            nn.MaxPool2D(3, 2))
        self.pool = nn.AdaptiveAvgPool2D((6, 6))
        self.classifier = nn.Sequential(
            nn.Dropout(dropout), nn.Linear(256 * 36, 4096), nn.ReLU(),
            nn.Dropout(dropout), nn.Linear(4096, 4096), nn.ReLU(),
            nn.Linear(4096, num_classes))

    def forward(self, x):
        return self.classifier(self.pool(self.features(x)).flatten(1))


def alexnet(pretrained=False, **kwargs):
    return AlexNet(**kwargs)


class _Fire(nn.Layer):
    """SqueezeNet fire module (squeeze 1x1 → expand 1x1 + 3x3, concat)."""

    def __init__(self, inp, squeeze, e1, e3):
        super().__init__()
        self.squeeze = nn.Sequential(nn.Conv2D(inp, squeeze, 1), nn.ReLU())
        self.expand1 = nn.Sequential(nn.Conv2D(squeeze, e1, 1), nn.ReLU())
        self.expand3 = nn.Sequential(
            nn.Conv2D(squeeze, e3, 3, padding=1), nn.ReLU())

    def forward(self, x):
        s = self.squeeze(x)
        return torch.cat([self.expand1(s), self.expand3(s)], dim=1)


class SqueezeNet(nn.Layer):
    """SqueezeNet, the version 1.1 topology."""

    def __init__(self, num_classes=1000, version="1.1"):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2D(3, 64, 3, stride=2), nn.ReLU(),
            nn.MaxPool2D(3, 2),
            _Fire(64, 16, 64, 64), _Fire(128, 16, 64, 64),
            nn.MaxPool2D(3, 2),
            _Fire(128, 32, 128, 128), _Fire(256, 32, 128, 128),
            nn.MaxPool2D(3, 2),
            _Fire(256, 48, 192, 192), _Fire(384, 48, 192, 192),
            _Fire(384, 64, 256, 256), _Fire(512, 64, 256, 256))
        self.classifier = nn.Sequential(
            nn.Dropout(0.5), nn.Conv2D(512, num_classes, 1), nn.ReLU(),
            nn.AdaptiveAvgPool2D((1, 1)))

    def forward(self, x):
        return self.classifier(self.features(x)).flatten(1)


def squeezenet1_1(pretrained=False, **kwargs):
    return SqueezeNet(**kwargs)


def _channel_shuffle(x, groups):
    """Interleave the channels of ``groups`` groups."""
    B, C, H, W = x.shape
    return (x.reshape(B, groups, C // groups, H, W).transpose(1, 2)
            .reshape(B, C, H, W))


class _ShuffleUnit(nn.Layer):
    def __init__(self, inp, outp, stride):
        super().__init__()
        self.stride = stride
        branch = outp // 2
        if stride == 2:
            self.branch1 = nn.Sequential(
                nn.Conv2D(inp, inp, 3, stride=2, padding=1, groups=inp,
                          bias_attr=False),
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
        if self.stride == 2:
            out = torch.cat([self.branch1(x), self.branch2(x)], dim=1)
        else:
            c = x.shape[1] // 2
            out = torch.cat([x[:, :c], self.branch2(x[:, c:])], dim=1)
        return _channel_shuffle(out, 2)


class ShuffleNetV2(nn.Layer):
    def __init__(self, num_classes=1000, scale=1.0):
        super().__init__()
        stage_out = {0.5: [48, 96, 192, 1024], 1.0: [116, 232, 464, 1024],
                     1.5: [176, 352, 704, 1024]}[scale]
        self.conv1 = nn.Sequential(
            nn.Conv2D(3, 24, 3, stride=2, padding=1, bias_attr=False),
            nn.BatchNorm2D(24), nn.ReLU())
        self.maxpool = nn.MaxPool2D(3, 2, padding=1)
        inp = 24
        stages = []
        for outp, repeats in zip(stage_out[:3], (4, 8, 4)):
            units = [_ShuffleUnit(inp, outp, 2)]
            units += [_ShuffleUnit(outp, outp, 1) for _ in range(repeats - 1)]
            stages.append(nn.Sequential(*units))
            inp = outp
        self.stage2, self.stage3, self.stage4 = stages
        self.conv5 = nn.Sequential(
            nn.Conv2D(inp, stage_out[3], 1, bias_attr=False),
            nn.BatchNorm2D(stage_out[3]), nn.ReLU())
        self.pool = nn.AdaptiveAvgPool2D((1, 1))
        self.fc = nn.Linear(stage_out[3], num_classes)

    def forward(self, x):
        x = self.maxpool(self.conv1(x))
        x = self.stage4(self.stage3(self.stage2(x)))
        return self.fc(self.pool(self.conv5(x)).flatten(1))


def shufflenet_v2_x1_0(pretrained=False, **kwargs):
    return ShuffleNetV2(scale=1.0, **kwargs)


class _DenseLayer(nn.Layer):
    def __init__(self, inp, growth, bn_size):
        super().__init__()
        self.fn = nn.Sequential(
            nn.BatchNorm2D(inp), nn.ReLU(),
            nn.Conv2D(inp, bn_size * growth, 1, bias_attr=False),
            nn.BatchNorm2D(bn_size * growth), nn.ReLU(),
            nn.Conv2D(bn_size * growth, growth, 3, padding=1,
                      bias_attr=False))

    def forward(self, x):
        return torch.cat([x, self.fn(x)], dim=1)


class DenseNet(nn.Layer):
    """DenseNet-121 by default."""

    def __init__(self, num_classes=1000, growth_rate=32,
                 block_config=(6, 12, 24, 16), bn_size=4,
                 num_init_features=64):
        super().__init__()
        feats = [nn.Conv2D(3, num_init_features, 7, stride=2, padding=3,
                           bias_attr=False),
                 nn.BatchNorm2D(num_init_features), nn.ReLU(),
                 nn.MaxPool2D(3, 2, padding=1)]
        ch = num_init_features
        for bi, n in enumerate(block_config):
            for _ in range(n):
                feats.append(_DenseLayer(ch, growth_rate, bn_size))
                ch += growth_rate
            if bi != len(block_config) - 1:
                feats += [nn.BatchNorm2D(ch), nn.ReLU(),
                          nn.Conv2D(ch, ch // 2, 1, bias_attr=False),
                          nn.AvgPool2D(2, 2)]
                ch //= 2
        feats += [nn.BatchNorm2D(ch), nn.ReLU()]
        self.features = nn.Sequential(*feats)
        self.pool = nn.AdaptiveAvgPool2D((1, 1))
        self.classifier = nn.Linear(ch, num_classes)

    def forward(self, x):
        return self.classifier(self.pool(self.features(x)).flatten(1))


def densenet121(pretrained=False, **kwargs):
    return DenseNet(**kwargs)
