"""AlexNet (reference: ``examples/cnn/model/alexnet.py``).  Its smallest
input is 63x63 (pool5 needs a 3x3 map)."""

from .... import layer
from . import Classifier


class AlexNet(Classifier):
    def __init__(self, num_classes=1000, num_channels=3):
        super().__init__()
        self.num_classes = num_classes
        self.input_size = 224
        self.dim = num_channels
        self.conv1 = layer.Conv2d(64, 11, stride=4, padding=2)
        self.relu1 = layer.ReLU()
        self.pool1 = layer.MaxPool2d(3, 2)
        self.conv2 = layer.Conv2d(192, 5, padding=2)
        self.relu2 = layer.ReLU()
        self.pool2 = layer.MaxPool2d(3, 2)
        self.conv3 = layer.Conv2d(384, 3, padding=1)
        self.relu3 = layer.ReLU()
        self.conv4 = layer.Conv2d(256, 3, padding=1)
        self.relu4 = layer.ReLU()
        self.conv5 = layer.Conv2d(256, 3, padding=1)
        self.relu5 = layer.ReLU()
        self.pool5 = layer.MaxPool2d(3, 2)
        self.flatten = layer.Flatten()
        self.drop6 = layer.Dropout(0.5)
        self.fc6 = layer.Linear(4096)
        self.relu6 = layer.ReLU()
        self.drop7 = layer.Dropout(0.5)
        self.fc7 = layer.Linear(4096)
        self.relu7 = layer.ReLU()
        self.fc8 = layer.Linear(num_classes)

    def forward(self, x):
        x = self.pool1(self.relu1(self.conv1(x)))
        x = self.pool2(self.relu2(self.conv2(x)))
        x = self.relu3(self.conv3(x))
        x = self.relu4(self.conv4(x))
        x = self.pool5(self.relu5(self.conv5(x)))
        x = self.flatten(x)
        x = self.relu6(self.fc6(self.drop6(x)))
        x = self.relu7(self.fc7(self.drop7(x)))
        return self.fc8(x)


def create_model(**kw):
    return AlexNet(**kw)
