"""Xception (reference: ``examples/cnn/model/xceptionnet.py``): separable
convs with residual shortcuts, NCHW inputs."""

from .... import autograd, layer
from . import Classifier


class Block(layer.Layer):
    """Xception block: [relu ->] sepconv -> bn, repeated, with an optional
    strided maxpool and a 1x1-conv shortcut."""

    def __init__(self, out_filters, reps, strides=1, start_with_relu=True,
                 grow_first=True, name=None):
        super().__init__(name)
        self.out_filters = out_filters
        self.reps = reps
        self.strides = strides
        self.start_with_relu = start_with_relu
        self.grow_first = grow_first
        self.layers = []
        for _ in range(reps):
            self.layers.append(layer.ReLU())
            self.layers.append(layer.SeparableConv2d(
                out_filters, 3, stride=1, padding=1, bias=False))
            self.layers.append(layer.BatchNorm2d())
        if not start_with_relu:
            self.layers = self.layers[1:]
        if strides != 1:
            self.pool = layer.MaxPool2d(3, strides, padding=1)
        else:
            self.pool = None
        self.skip = layer.Conv2d(out_filters, 1, stride=strides, bias=False)
        self.skipbn = layer.BatchNorm2d()

    def forward(self, x):
        out = x
        for lay in self.layers:
            out = lay(out)
        if self.pool is not None:
            out = self.pool(out)
        skip = self.skipbn(self.skip(x))
        return autograd.add(out, skip)


class Xception(Classifier):
    def __init__(self, num_classes=1000, num_channels=3):
        super().__init__()
        self.num_classes = num_classes
        self.input_size = 299
        self.dim = num_channels
        self.conv1 = layer.Conv2d(32, 3, stride=2, bias=False)
        self.bn1 = layer.BatchNorm2d()
        self.relu1 = layer.ReLU()
        self.conv2 = layer.Conv2d(64, 3, bias=False)
        self.bn2 = layer.BatchNorm2d()
        self.relu2 = layer.ReLU()
        self.block1 = Block(128, 2, 2, start_with_relu=False)
        self.block2 = Block(256, 2, 2)
        self.block3 = Block(728, 2, 2)
        self.mid = layer.Sequential(*[Block(728, 3, 1) for _ in range(8)])
        self.block12 = Block(1024, 2, 2, grow_first=False)
        self.sep3 = layer.SeparableConv2d(1536, 3, padding=1, bias=False)
        self.bn3 = layer.BatchNorm2d()
        self.relu3 = layer.ReLU()
        self.sep4 = layer.SeparableConv2d(2048, 3, padding=1, bias=False)
        self.bn4 = layer.BatchNorm2d()
        self.relu4 = layer.ReLU()
        self.avgpool = layer.GlobalAvgPool2d()
        self.fc = layer.Linear(num_classes)

    def forward(self, x):
        x = self.relu1(self.bn1(self.conv1(x)))
        x = self.relu2(self.bn2(self.conv2(x)))
        x = self.block1(x)
        x = self.block2(x)
        x = self.block3(x)
        x = self.mid(x)
        x = self.block12(x)
        x = self.relu3(self.bn3(self.sep3(x)))
        x = self.relu4(self.bn4(self.sep4(x)))
        x = self.avgpool(x)
        x = autograd.flatten(x)
        return self.fc(x)


def create_model(**kw):
    return Xception(**kw)
