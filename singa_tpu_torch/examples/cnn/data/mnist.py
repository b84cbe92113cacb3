"""MNIST IDX-format loader (reference: ``examples/cnn/data/mnist.py``,
which downloads the Yann LeCun archives then parses the same format).

This copy downloads nothing: it parses local IDX files only — plain or gzipped —
from ``data_dir``; no download.  The IDX format (big-endian): magic
``0x00000803`` for uint8 image tensors with 3 dims (N, rows, cols),
``0x00000801`` for uint8 label vectors.

Use :func:`available` to decide between real files and the synthetic
fallback (``synthetic.load``).
"""

import gzip
import os
import struct

import numpy as np

TRAIN_IMAGES = "train-images-idx3-ubyte"
TRAIN_LABELS = "train-labels-idx1-ubyte"
TEST_IMAGES = "t10k-images-idx3-ubyte"
TEST_LABELS = "t10k-labels-idx1-ubyte"


def _open(path):
    return gzip.open(path, "rb") if path.endswith(".gz") else \
        open(path, "rb")


def _find(data_dir: str, stem: str):
    for name in (stem, stem + ".gz"):
        p = os.path.join(data_dir, name)
        if os.path.exists(p):
            return p
    return None


def read_idx(path: str) -> np.ndarray:
    """Parse one IDX file (images or labels), plain or .gz."""
    with _open(path) as f:
        zero, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        if zero != 0:
            raise ValueError(f"{path}: bad IDX magic (leading {zero:#x})")
        if dtype_code != 0x08:
            raise ValueError(f"{path}: only uint8 IDX supported, "
                             f"got type {dtype_code:#x}")
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = f.read(int(np.prod(dims)))
        if len(data) != int(np.prod(dims)):
            raise ValueError(f"{path}: truncated ({len(data)} bytes for "
                             f"dims {dims})")
        return np.frombuffer(data, np.uint8).reshape(dims)


def available(data_dir: str, split: str = "train") -> bool:
    stems = (TRAIN_IMAGES, TRAIN_LABELS) if split == "train" else \
        (TEST_IMAGES, TEST_LABELS)
    return bool(data_dir) and \
        all(_find(data_dir, s) is not None for s in stems)


def load(data_dir: str, split: str = "train"):
    """(x, y): x float32 (N, 1, 28, 28) scaled to [0, 1]-ish mean-centred
    the way the reference example normalizes; y int32 (N,)."""
    stems = (TRAIN_IMAGES, TRAIN_LABELS) if split == "train" else \
        (TEST_IMAGES, TEST_LABELS)
    paths = [_find(data_dir, s) for s in stems]
    if None in paths:
        raise FileNotFoundError(f"MNIST {split} IDX files not under "
                                f"{data_dir!r} (need {stems})")
    images = read_idx(paths[0])
    labels = read_idx(paths[1])
    if images.ndim != 3:
        raise ValueError(f"{paths[0]}: expected 3-d image tensor, "
                         f"got shape {images.shape}")
    if len(images) != len(labels):
        raise ValueError(f"images/labels disagree: {len(images)} vs "
                         f"{len(labels)}")
    x = (images.astype(np.float32) / 255.0 - 0.1307) / 0.3081
    return x[:, None, :, :], labels.astype(np.int32)
