"""CIFAR-10/100 python-pickle loader (reference:
``examples/cnn/data/cifar10.py``, which downloads the toronto.edu
tarball then unpickles the same batches).

This copy downloads nothing: it reads already-extracted local batch
files only.
CIFAR-10 layout: ``data_batch_1..5`` + ``test_batch`` under
``cifar-10-batches-py/`` (or ``data_dir`` itself), each a pickle dict
with ``b"data"`` (N, 3072) uint8 rows (R then G then B planes) and
``b"labels"``.  CIFAR-100: ``train`` / ``test`` files with
``b"fine_labels"``.
"""

import os
import pickle

import numpy as np

_C10_DIR = "cifar-10-batches-py"
_C100_DIR = "cifar-100-python"
_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32).reshape(3, 1, 1)
_STD = np.array([0.2470, 0.2435, 0.2616], np.float32).reshape(3, 1, 1)


def _root(data_dir: str, sub: str) -> str:
    nested = os.path.join(data_dir, sub)
    return nested if os.path.isdir(nested) else data_dir


def _unpickle(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f, encoding="bytes")


def _decode(batches):
    xs, ys = [], []
    for d in batches:
        rows = np.asarray(d[b"data"], np.uint8)
        labels = d.get(b"labels", d.get(b"fine_labels"))
        if labels is None:
            raise ValueError("batch has neither b'labels' nor "
                             "b'fine_labels'")
        if rows.shape[1] != 3072:
            raise ValueError(f"expected 3072-byte rows, got "
                             f"{rows.shape[1]}")
        xs.append(rows.reshape(-1, 3, 32, 32))
        ys.append(np.asarray(labels, np.int32))
    x = np.concatenate(xs).astype(np.float32) / 255.0
    return (x - _MEAN) / _STD, np.concatenate(ys)


def available(data_dir: str, dataset: str = "cifar10",
              split: str = "train") -> bool:
    if not data_dir:
        return False
    if dataset == "cifar100":
        name = "train" if split == "train" else "test"
        return os.path.exists(os.path.join(_root(data_dir, _C100_DIR),
                                           name))
    name = "data_batch_1" if split == "train" else "test_batch"
    return os.path.exists(os.path.join(_root(data_dir, _C10_DIR), name))


def load(data_dir: str, dataset: str = "cifar10", split: str = "train"):
    """(x, y): x float32 (N, 3, 32, 32) channel-normalized, y int32."""
    if dataset == "cifar100":
        root = _root(data_dir, _C100_DIR)
        path = os.path.join(root, "train" if split == "train" else "test")
        if not os.path.exists(path):
            raise FileNotFoundError(f"CIFAR-100 {split} file not at "
                                    f"{path}")
        return _decode([_unpickle(path)])
    root = _root(data_dir, _C10_DIR)
    if split == "train":
        names = [f"data_batch_{i}" for i in range(1, 6)]
        paths = [p for p in (os.path.join(root, n) for n in names)
                 if os.path.exists(p)]
        if not paths:
            raise FileNotFoundError(f"no CIFAR-10 data_batch_* under "
                                    f"{root}")
    else:
        p = os.path.join(root, "test_batch")
        if not os.path.exists(p):
            raise FileNotFoundError(f"CIFAR-10 test_batch not under "
                                    f"{root}")
        paths = [p]
    return _decode([_unpickle(p) for p in paths])
