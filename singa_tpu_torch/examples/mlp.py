"""MLP on MNIST-shaped data on the port — the counterpart of the JAX
package's ``examples/mlp/train.py`` (the reference's ``examples/mlp``).

    python -m singa_tpu_torch.examples.mlp [--device cuda|cpu] ...

784-128-128-10 with ReLU, SGD with momentum 0.9, mean softmax
cross-entropy, trained through ``Model.compile(use_graph=...)`` (on the
card a captured CUDA graph; ``--no-graph`` runs eagerly).  The data is a
synthetic MNIST-shaped task (784-d inputs, 10 classes, Gaussian class
centers; :func:`synthetic_mnist`) unless ``--data`` names an ``.npz``
with ``x_train`` / ``y_train``.  The flags are the JAX example's;
``--device`` is ``cuda`` (the default) or ``cpu``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from .. import autograd, layer, opt, tensor
from ..device import get_device
from ..logging import INFO, InitLogging, LOG
from ..model import Model


class MLP(Model):
    def __init__(self, hidden=128, classes=10):
        super().__init__()
        self.fc1 = layer.Linear(hidden)
        self.relu1 = layer.ReLU()
        self.fc2 = layer.Linear(hidden)
        self.relu2 = layer.ReLU()
        self.fc3 = layer.Linear(classes)

    def forward(self, x):
        h = self.relu1(self.fc1(x))
        h = self.relu2(self.fc2(h))
        return self.fc3(h)

    def train_one_batch(self, x, y):
        out = self.forward(x)
        loss = autograd.softmax_cross_entropy(out, y)
        self.optimizer(loss)
        return out, loss


def synthetic_mnist(n=8192, dim=784, classes=10, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(classes, dim).astype(np.float32) * 2.0
    y = rng.randint(0, classes, n).astype(np.int32)
    x = centers[y] + rng.randn(n, dim).astype(np.float32)
    return x, y


def run(args):
    """Train as the flags say; returns the epochs' mean losses."""
    InitLogging("train_mlp")
    dev = get_device(args.device)
    if args.data:
        d = np.load(args.data)
        x_np = d["x_train"].astype(np.float32)
        y_np = d["y_train"].astype(np.int32)
        x_np = x_np.reshape(len(x_np), -1) / 255.0
    else:
        x_np, y_np = synthetic_mnist()

    model = MLP()
    model.set_optimizer(opt.SGD(lr=args.lr, momentum=0.9))
    tx = tensor.Tensor(data=x_np[:args.bs], device=dev, requires_grad=False)
    model.compile([tx], is_train=True, use_graph=args.graph)

    nb = len(x_np) // args.bs
    losses = []
    for epoch in range(args.epochs):
        t0 = time.time()
        tot_loss, correct = 0.0, 0
        for b in range(nb):
            xb = x_np[b * args.bs:(b + 1) * args.bs]
            yb = y_np[b * args.bs:(b + 1) * args.bs]
            tx = tensor.Tensor(data=xb, device=dev, requires_grad=False)
            ty = tensor.Tensor(data=yb, device=dev, requires_grad=False)
            out, loss = model.train_one_batch(tx, ty)
            tot_loss += float(loss.item())
            correct += int((np.argmax(out.numpy(), 1) == yb).sum())
        dt = time.time() - t0
        losses.append(tot_loss / nb)
        LOG(INFO, "epoch %d: loss=%.4f acc=%.4f (%.0f samples/s)",
            epoch, tot_loss / nb, correct / (nb * args.bs),
            nb * args.bs / dt)
    return losses


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--bs", type=int, default=256)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--graph", action="store_true", default=True)
    ap.add_argument("--no-graph", dest="graph", action="store_false")
    ap.add_argument("--data", type=str, default=None)
    return ap


def main(argv=None):
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
