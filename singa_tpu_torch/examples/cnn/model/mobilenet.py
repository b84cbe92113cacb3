"""MobileNetV2 (reference: ``examples/cnn/model/mobilenet.py``): inverted
residual blocks (expand 1x1, depthwise 3x3, linear 1x1 projection), ReLU6
as ``clip(x, 0, 6)``, the width multiplier, and the zoo's ``precision``
and ``layout`` arguments (see :mod:`.resnet`)."""

from .... import autograd, layer
from . import Classifier


def _relu6(x):
    return autograd.clip(x, 0.0, 6.0)


def _make_divisible(v, divisor=8):
    """Round channel counts to multiples of ``divisor`` (the stock V2
    channel arithmetic), never dropping below 90% of the original."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class InvertedResidual(layer.Layer):
    """t-expand 1x1 conv -> depthwise 3x3 -> linear 1x1 project, with an
    identity shortcut when stride==1 and channels are unchanged."""

    def __init__(self, in_ch, out_ch, stride, expand_ratio, layout="NCHW",
                 name=None):
        super().__init__(name)
        self.use_res = stride == 1 and in_ch == out_ch
        hidden = int(round(in_ch * expand_ratio))
        lay = dict(layout=layout)
        self.expand = None
        if expand_ratio != 1:
            self.expand = layer.Conv2d(hidden, 1, bias=False, **lay)
            self.bn0 = layer.BatchNorm2d(**lay)
        self.dw = layer.Conv2d(hidden, 3, stride=stride, padding=1,
                               groups=hidden, bias=False, **lay)
        self.bn1 = layer.BatchNorm2d(**lay)
        self.project = layer.Conv2d(out_ch, 1, bias=False, **lay)
        self.bn2 = layer.BatchNorm2d(**lay)

    def forward(self, x):
        out = x
        if self.expand is not None:
            out = _relu6(self.bn0(self.expand(out)))
        out = _relu6(self.bn1(self.dw(out)))
        out = self.bn2(self.project(out))
        if self.use_res:
            out = autograd.add(out, x)
        return out


class MobileNetV2(Classifier):
    # (expand t, channels c, repeats n, stride s): the stock V2 table
    SETTINGS = [
        (1, 16, 1, 1),
        (6, 24, 2, 2),
        (6, 32, 3, 2),
        (6, 64, 4, 2),
        (6, 96, 3, 1),
        (6, 160, 3, 2),
        (6, 320, 1, 1),
    ]

    def __init__(self, num_classes=1000, num_channels=3, width_mult=1.0,
                 precision="float32", layout="NCHW"):
        super().__init__()
        self.num_classes = num_classes
        self.input_size = 224
        self.dim = num_channels
        self.precision = precision
        self.layout = layout
        lay = dict(layout=layout)

        in_ch = _make_divisible(32 * width_mult)
        self.conv1 = layer.Conv2d(in_ch, 3, stride=2, padding=1, bias=False,
                                  **lay)
        self.bn1 = layer.BatchNorm2d(**lay)
        blocks = []
        for t, c, n, s in self.SETTINGS:
            out_ch = _make_divisible(c * width_mult)
            for i in range(n):
                blocks.append(InvertedResidual(
                    in_ch, out_ch, s if i == 0 else 1, t, layout=layout))
                in_ch = out_ch
        self.blocks = layer.Sequential(*blocks)
        last_ch = _make_divisible(1280 * max(1.0, width_mult))
        self.conv_last = layer.Conv2d(last_ch, 1, bias=False, **lay)
        self.bn_last = layer.BatchNorm2d(**lay)
        self.avgpool = layer.GlobalAvgPool2d(**lay)
        self.fc = layer.Linear(num_classes)

    def forward(self, x):
        if self.precision != "float32":
            x = autograd.cast(x, self.precision)
        if self.layout == "NHWC":
            x = autograd.transpose(x, (0, 2, 3, 1))
        x = _relu6(self.bn1(self.conv1(x)))
        x = self.blocks(x)
        x = _relu6(self.bn_last(self.conv_last(x)))
        x = self.avgpool(x)
        x = autograd.flatten(x)
        out = self.fc(x)
        if self.precision != "float32":
            out = autograd.cast(out, "float32")
        return out


def create_model(**kw):
    return MobileNetV2(**kw)
