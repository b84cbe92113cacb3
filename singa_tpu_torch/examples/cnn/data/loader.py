"""Dataset dispatch for the CNN examples: real local files when present,
synthetic fallback otherwise (reference: ``examples/cnn/data/*`` always
downloads; these download nothing, so presence on disk decides).

``load`` returns ``(x, y, source)`` where source is ``"mnist-idx"``,
``"cifar-pickle"`` or ``"synthetic"`` so callers can log what actually
trained.
"""

import numpy as np

from . import cifar, mnist, synthetic


def load(dataset: str, num: int = 1024, seed: int = 0,
         data_dir: str | None = None, split: str = "train"):
    if dataset == "mnist" and data_dir \
            and mnist.available(data_dir, split):
        x, y = mnist.load(data_dir, split)
        source = "mnist-idx"
    elif dataset in ("cifar10", "cifar100") and data_dir \
            and cifar.available(data_dir, dataset, split):
        x, y = cifar.load(data_dir, dataset, split)
        source = "cifar-pickle"
    else:
        x, y = synthetic.load(dataset, num=num, seed=seed)
        return x, y, "synthetic"
    if num and num < len(x):
        # deterministic subsample so -n keeps its meaning on real data
        idx = np.random.RandomState(seed).permutation(len(x))[:num]
        x, y = x[idx], y[idx]
    return x, y, source
