"""ResNet feature-pyramid encoder.

Port of ``unsupervised_pose_estimation_tpu/models/resnet.py``: ResNet-18 to
-152 returning [relu(bn1(conv1)), layer1, ..., layer4] at strides 2..32, and
the multi-image variant whose first conv takes ``num_input_images`` stacked
RGB frames (the pose encoder). Weights sit under ``encoder.`` in
torchvision's layout, as the reference ``.pth`` files store them. Inputs are
NCHW in [0, 1], not ImageNet-normalised (as in the reference). BatchNorm
trains with flax's semantics (``layers.BatchNorm2d``).
"""

from __future__ import annotations

from torch import nn

from .layers import BatchNorm2d

STAGE_BLOCKS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
                101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
BOTTLENECK_DEPTHS = (50, 101, 152)


def encoder_channels(num_layers: int):
    ch = [64, 64, 128, 256, 512]
    if num_layers > 34:
        ch = [ch[0]] + [c * 4 for c in ch[1:]]
    return tuple(ch)


def _downsample(cin, cout, stride):
    if stride == 1 and cin == cout:
        return None
    return nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                         BatchNorm2d(cout))


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(cout)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = _downsample(cin, cout, stride)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        return self.relu(self.bn2(self.conv2(out)) + identity)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        inner = cout // 4
        self.conv1 = nn.Conv2d(cin, inner, 1, bias=False)
        self.bn1 = BatchNorm2d(inner)
        self.conv2 = nn.Conv2d(inner, inner, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2d(inner)
        self.conv3 = nn.Conv2d(inner, cout, 1, bias=False)
        self.bn3 = BatchNorm2d(cout)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = _downsample(cin, cout, stride)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        return self.relu(self.bn3(self.conv3(out)) + identity)


class _ResNet(nn.Module):
    def __init__(self, num_layers: int, in_channels: int):
        super().__init__()
        if num_layers not in STAGE_BLOCKS:
            raise ValueError(f"{num_layers} is not a valid number of resnet "
                             "layers")
        block = Bottleneck if num_layers in BOTTLENECK_DEPTHS else BasicBlock
        self.conv1 = nn.Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        widths = encoder_channels(num_layers)
        cin = 64
        for stage, n_blocks in enumerate(STAGE_BLOCKS[num_layers]):
            blocks = []
            for i in range(n_blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                blocks.append(block(cin, widths[stage + 1], stride))
                cin = widths[stage + 1]
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))


class ResnetEncoder(nn.Module):
    """5-level pyramid with widths ``encoder_channels(num_layers)``."""

    def __init__(self, num_layers: int = 18, num_input_images: int = 1):
        super().__init__()
        self.num_ch_enc = encoder_channels(num_layers)
        self.encoder = _ResNet(num_layers, 3 * num_input_images)

    def forward(self, x):
        e = self.encoder
        feats = [e.relu(e.bn1(e.conv1(x)))]
        feats.append(e.layer1(e.maxpool(feats[-1])))
        feats.append(e.layer2(feats[-1]))
        feats.append(e.layer3(feats[-1]))
        feats.append(e.layer4(feats[-1]))
        return feats
