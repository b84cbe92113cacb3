"""VGG-11/13/16/19 with optional BatchNorm (reference:
``examples/cnn/model/vgg.py``), with the zoo's ``precision`` and
``layout`` arguments (see :mod:`.resnet`)."""

from .... import autograd, layer
from . import Classifier

CFGS = {
    "vgg11": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "vgg13": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
              512, 512, "M"],
    "vgg16": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M"],
    "vgg19": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


class VGG(Classifier):
    def __init__(self, cfg="vgg16", num_classes=1000, num_channels=3,
                 batch_norm=False, precision="float32", layout="NCHW"):
        super().__init__()
        self.num_classes = num_classes
        self.input_size = 224
        self.dim = num_channels
        self.precision = precision
        self.layout = layout
        lay = dict(layout=layout)
        self._feats = []  # (kind, layer) so forward can skip no-op pools
        for v in CFGS[cfg]:
            if v == "M":
                self._feats.append(("pool", layer.MaxPool2d(2, stride=2,
                                                            **lay)))
            else:
                self._feats.append(("conv", layer.Conv2d(v, 3, padding=1,
                                                         **lay)))
                if batch_norm:
                    self._feats.append(("bn", layer.BatchNorm2d(**lay)))
                self._feats.append(("act", layer.ReLU()))
        self.features = layer.Sequential(*[lay_ for _, lay_ in self._feats])
        # classifier head: 4096-4096-classes with dropout, as stock VGG
        self.fc1 = layer.Linear(4096)
        self.drop1 = layer.Dropout(0.5)
        self.fc2 = layer.Linear(4096)
        self.drop2 = layer.Dropout(0.5)
        self.fc3 = layer.Linear(num_classes)
        self.relu = layer.ReLU()

    def forward(self, x):
        if self.precision != "float32":
            x = autograd.cast(x, self.precision)
        if self.layout == "NHWC":
            x = autograd.transpose(x, (0, 2, 3, 1))
        h_axis = 1 if self.layout == "NHWC" else 2
        for kind, lay_ in self._feats:
            # a 2x2/2 pool on a 1-pixel map (small inputs) is skipped
            if kind == "pool" and min(x.shape[h_axis],
                                      x.shape[h_axis + 1]) < 2:
                continue
            x = lay_(x)
        x = autograd.flatten(x)
        x = self.drop1(self.relu(self.fc1(x)))
        x = self.drop2(self.relu(self.fc2(x)))
        out = self.fc3(x)
        if self.precision != "float32":
            out = autograd.cast(out, "float32")
        return out


def vgg11(**kw):
    return VGG("vgg11", **kw)


def vgg13(**kw):
    return VGG("vgg13", **kw)


def vgg16(**kw):
    return VGG("vgg16", **kw)


def vgg19(**kw):
    return VGG("vgg19", **kw)


def create_model(name="vgg16", **kw):
    return VGG(name if name in CFGS else "vgg16", **kw)
