"""ResNet family (reference: ``examples/cnn/model/resnet.py``:
resnet18/34/50/101/152 over Conv2d, BatchNorm2d and the pools, with
``autograd.add`` shortcuts).

``precision`` (``"float32"`` by default) casts the input to that dtype
inside ``forward`` and the logits back to float32: the parameters stay
float32 and the conv and batch-norm ops cast them to the activation's
dtype.  ``layout="NHWC"`` keeps the NCHW input contract and runs the
network channels-last after one transpose; the weights stay OIHW, so
checkpoints do not depend on the layout."""

from .... import autograd, layer
from . import Classifier


class BasicBlock(layer.Layer):
    """3x3 + 3x3 residual block (resnet18/34)."""

    expansion = 1

    def __init__(self, planes, stride=1, downsample=False, layout="NCHW",
                 name=None):
        super().__init__(name)
        lay = dict(layout=layout)
        self.conv1 = layer.Conv2d(planes, 3, stride=stride, padding=1,
                                  bias=False, **lay)
        self.bn1 = layer.BatchNorm2d(**lay)
        self.relu1 = layer.ReLU()
        self.conv2 = layer.Conv2d(planes, 3, stride=1, padding=1, bias=False,
                                  **lay)
        self.bn2 = layer.BatchNorm2d(**lay)
        self.relu2 = layer.ReLU()
        self.downsample = None
        if downsample:
            self.ds_conv = layer.Conv2d(planes * self.expansion, 1,
                                        stride=stride, bias=False, **lay)
            self.ds_bn = layer.BatchNorm2d(**lay)
            self.downsample = True

    def forward(self, x):
        identity = x
        out = self.relu1(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample:
            identity = self.ds_bn(self.ds_conv(x))
        return self.relu2(autograd.add(out, identity))


class Bottleneck(layer.Layer):
    """1x1 -> 3x3 -> 1x1 bottleneck (resnet50/101/152)."""

    expansion = 4

    def __init__(self, planes, stride=1, downsample=False, layout="NCHW",
                 name=None):
        super().__init__(name)
        lay = dict(layout=layout)
        self.conv1 = layer.Conv2d(planes, 1, bias=False, **lay)
        self.bn1 = layer.BatchNorm2d(**lay)
        self.relu1 = layer.ReLU()
        self.conv2 = layer.Conv2d(planes, 3, stride=stride, padding=1,
                                  bias=False, **lay)
        self.bn2 = layer.BatchNorm2d(**lay)
        self.relu2 = layer.ReLU()
        self.conv3 = layer.Conv2d(planes * self.expansion, 1, bias=False,
                                  **lay)
        self.bn3 = layer.BatchNorm2d(**lay)
        self.relu3 = layer.ReLU()
        self.downsample = None
        if downsample:
            self.ds_conv = layer.Conv2d(planes * self.expansion, 1,
                                        stride=stride, bias=False, **lay)
            self.ds_bn = layer.BatchNorm2d(**lay)
            self.downsample = True

    def forward(self, x):
        identity = x
        out = self.relu1(self.bn1(self.conv1(x)))
        out = self.relu2(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample:
            identity = self.ds_bn(self.ds_conv(x))
        return self.relu3(autograd.add(out, identity))


class ResNet(Classifier):
    """ResNet over NCHW inputs (reference: ``class ResNet(model.Model)``);
    see the module docstring for ``precision`` and ``layout``."""

    def __init__(self, block, layers, num_classes=1000, num_channels=3,
                 precision="float32", layout="NCHW"):
        super().__init__()
        self.num_classes = num_classes
        self.input_size = 224
        self.dim = num_channels
        self.precision = precision
        self.layout = layout
        lay = dict(layout=layout)
        self.conv1 = layer.Conv2d(64, 7, stride=2, padding=3, bias=False,
                                  **lay)
        self.bn1 = layer.BatchNorm2d(**lay)
        self.relu = layer.ReLU()
        self.maxpool = layer.MaxPool2d(3, stride=2, padding=1, **lay)
        self.layer1 = self._make_layer(block, 64, layers[0], stride=1)
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        self.avgpool = layer.GlobalAvgPool2d(**lay)
        self.fc = layer.Linear(num_classes)

    def _make_layer(self, block, planes, blocks, stride):
        # the first block of a stage needs a projection shortcut when it
        # strides or changes the channel count (always, for Bottleneck)
        layers = [block(planes, stride, downsample=(stride != 1 or
                                                    block.expansion != 1),
                        layout=self.layout)]
        for _ in range(1, blocks):
            layers.append(block(planes, 1, downsample=False,
                                layout=self.layout))
        return layer.Sequential(*layers)

    def forward(self, x):
        if self.precision != "float32":
            x = autograd.cast(x, self.precision)
        if self.layout == "NHWC":
            x = autograd.transpose(x, (0, 2, 3, 1))
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        x = self.avgpool(x)
        x = autograd.flatten(x)
        out = self.fc(x)
        if self.precision != "float32":
            out = autograd.cast(out, "float32")  # float32 logits
        return out


def resnet18(**kw):
    return ResNet(BasicBlock, [2, 2, 2, 2], **kw)


def resnet34(**kw):
    return ResNet(BasicBlock, [3, 4, 6, 3], **kw)


def resnet50(**kw):
    return ResNet(Bottleneck, [3, 4, 6, 3], **kw)


def resnet101(**kw):
    return ResNet(Bottleneck, [3, 4, 23, 3], **kw)


def resnet152(**kw):
    return ResNet(Bottleneck, [3, 8, 36, 3], **kw)


def create_model(name="resnet50", **kw):
    return {"resnet18": resnet18, "resnet34": resnet34, "resnet50": resnet50,
            "resnet101": resnet101, "resnet152": resnet152}[name](**kw)


__all__ = ["ResNet", "BasicBlock", "Bottleneck", "resnet18", "resnet34",
           "resnet50", "resnet101", "resnet152", "create_model"]
