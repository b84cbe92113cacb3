"""Simple CNN (reference: ``examples/cnn/model/cnn.py``): two conv and
two fc layers on MNIST-shaped inputs."""

from .... import layer
from . import Classifier


class CNN(Classifier):
    def __init__(self, num_classes=10, num_channels=1):
        super().__init__()
        self.num_classes = num_classes
        self.input_size = 28
        self.dim = num_channels
        self.conv1 = layer.Conv2d(20, 5, padding=0)
        self.relu1 = layer.ReLU()
        self.pool1 = layer.MaxPool2d(2, 2, padding=0)
        self.conv2 = layer.Conv2d(50, 5, padding=0)
        self.relu2 = layer.ReLU()
        self.pool2 = layer.MaxPool2d(2, 2, padding=0)
        self.flatten = layer.Flatten()
        self.fc1 = layer.Linear(500)
        self.relu3 = layer.ReLU()
        self.fc2 = layer.Linear(num_classes)

    def forward(self, x):
        x = self.pool1(self.relu1(self.conv1(x)))
        x = self.pool2(self.relu2(self.conv2(x)))
        x = self.flatten(x)
        x = self.relu3(self.fc1(x))
        return self.fc2(x)


def create_model(**kw):
    return CNN(**kw)
